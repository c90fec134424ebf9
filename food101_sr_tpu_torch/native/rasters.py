"""Netpbm, ICO, CUR and QOI uploads decoded as the JAX package's server
decodes them: PIL's PpmImagePlugin, IcoImagePlugin, CurImagePlugin and
QoiImagePlugin, then ``convert("RGB")``.

- Netpbm: P1-P6 (plain and binary, comments anywhere in the header and in
  plain rasters), PIL's Pf (PFM: the scale's sign gives the byte order,
  rows bottom-up, mode F) and PIL's own P0CMYK, PyP, PyRGBA and PyCMYK. A
  maxval under 255 (or between 256 and 65534) is scaled to 8 bits (16 bits
  for gray, PIL's mode I) with Python's rounding; 65535 gray is read as
  PIL's ``I;16B``; I and F clip to 0..255.
- ICO: the directory entry PIL opens (the largest, then the shallowest),
  a PNG payload through :func:`decode_png_rgb8`, a BMP one (a DIB with a
  doubled height) through :func:`decode_bmp_rgb8` with PIL's checks on the
  AND mask or the alpha bytes it reads. CUR: PIL's entry, always a BMP.
- QOI: the header and ``fast_tiff.cpp``'s op decoder (PIL's QoiDecoder).
"""
from __future__ import annotations

import math
import struct

import numpy as np

from . import (MAX_PIXELS, PNG_SIGNATURE, NotThisFormat, decode_bmp_rgb8,
               decode_png_rgb8)
from .tiff import tiff_lib, to_rgb, unpacker

# ---------------------------------------------------------------------------
# Netpbm
# ---------------------------------------------------------------------------

_WS = b" \t\n\x0b\x0c\r"
_PPM_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L",
              b"P6": "RGB", b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P",
              b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_PPM_BANDS = {"1": 1, "L": 1, "I": 1, "P": 1, "F": 1, "RGB": 3, "RGBA": 4,
              "CMYK": 4}
_SAFEBLOCK = 1024 * 1024  # ImageFile.SAFEBLOCK: plain rasters are read so


def is_netpbm(data: bytes) -> bool:
    """PpmImagePlugin's _accept."""
    return len(data) >= 2 and data[:1] == b"P" and data[1] in b"0123456fy"


class _Reader:
    def __init__(self, data: bytes):
        self.d, self.pos = data, 0

    def read(self, n: int) -> bytes:
        out = self.d[self.pos:self.pos + n]
        self.pos += len(out)
        return out

    def token(self) -> bytes:
        """PpmImageFile._read_token: whitespace-separated, at most 10
        characters, a '#' skipping to the end of its line."""
        tok = b""
        while len(tok) <= 10:
            c = self.read(1)
            if not c:
                break
            if c in _WS:
                if not tok:
                    continue
                break
            if c == b"#":
                while self.read(1) not in b"\r\n":
                    pass
                continue
            tok += c
        if not tok:
            raise ValueError("PPM: reached EOF while reading header")
        if len(tok) > 10:
            raise ValueError("PPM: token too long in file header")
        return tok


def _comment_end(block: bytes, start: int = 0) -> int:
    a, b = block.find(b"\n", start), block.find(b"\r", start)
    return min(a, b) if a * b > 0 else max(a, b)


class _Plain:
    """PIL's PpmPlainDecoder: 1 MiB blocks, comments dropped with their
    line end, tokens stitched across blocks."""

    def __init__(self, r: _Reader):
        self.r, self.spans = r, False

    def block(self) -> bytes:
        return self.r.read(_SAFEBLOCK)

    def strip_comments(self, block: bytes) -> bytes:
        if self.spans:
            while block:
                end = _comment_end(block)
                if end != -1:
                    block = block[end + 1:]
                    break
                block = self.block()
        self.spans = False
        while True:
            start = block.find(b"#")
            if start == -1:
                break
            end = _comment_end(block, start)
            if end != -1:
                block = block[:start] + block[end + 1:]
            else:
                block = block[:start]
                self.spans = True
                break
        return block

    def bitonal(self, total: int) -> np.ndarray:
        data = b""
        while len(data) != total:
            block = self.block()
            if not block:
                break
            tokens = b"".join(self.strip_comments(block).split())
            if tokens.translate(None, b"01"):
                raise ValueError("PPM: invalid token for this mode")
            data = (data + tokens)[:total]
        if len(data) < total:
            raise ValueError("PPM: not enough image data")
        return np.where(np.frombuffer(data, np.uint8) == 48, 255, 0).astype(
            np.uint8)

    def values(self, total: int, maxval: int, out_max: int) -> list:
        out: list = []
        half = b""
        while len(out) != total:
            block = self.block()
            if not block:
                if half:
                    block = b" "
                else:
                    break
            block = self.strip_comments(block)
            if half:
                block, half = half + block, b""
            tokens = block.split()
            if block and not block[-1:].isspace():
                half = tokens.pop()
                if len(half) > 10:
                    raise ValueError("PPM: token too long in data")
            for t in tokens:
                if len(t) > 10:
                    raise ValueError("PPM: token too long in data")
                v = int(t)
                if v < 0 or v > maxval:
                    raise ValueError(f"PPM: channel value {v} out of range")
                out.append(round(v / maxval * out_max))
                if len(out) == total:
                    break
        if len(out) < total:
            raise ValueError("PPM: not enough image data")
        return out


def decode_netpbm_rgb8(data: bytes) -> np.ndarray:
    """Netpbm bytes -> uint8 HxWx3 as PIL opens and converts them (module
    docstring). Raises ValueError where PIL raises."""
    if not is_netpbm(data):
        raise ValueError("not a Netpbm file")
    r = _Reader(data)
    magic = b""
    for _ in range(6):
        c = r.read(1)
        if not c or c in _WS:
            break
        magic += c
    if magic not in _PPM_MODES:
        raise ValueError("PPM: not a PPM file")
    mode = _PPM_MODES[magic]
    w, h = int(r.token()), int(r.token())
    if w <= 0 or h <= 0:
        raise ValueError("PPM: empty image")
    if w * h > MAX_PIXELS:
        raise ValueError(f"PPM: {w}x{h} exceeds {MAX_PIXELS} pixels")
    plain = magic in (b"P1", b"P2", b"P3")
    decoder, rawmode, maxval, flip = "raw", mode, 255, False
    if mode == "1":
        rawmode = "1;I"
    elif mode == "F":
        scale = float(r.token())
        if scale == 0.0 or not math.isfinite(scale):
            raise ValueError("PPM: scale must be finite and non-zero")
        rawmode, flip = ("F;32F" if scale < 0 else "F;32BF"), True
    else:
        maxval = int(r.token())
        if not 0 < maxval < 65536:
            raise ValueError("PPM: maxval out of range")
        if not plain:
            if maxval == 65535 and mode == "L":
                rawmode = "I;16B"
            elif maxval != 255:
                decoder = "ppm"
        if maxval > 255 and mode == "L":
            mode = "I"
    bands = _PPM_BANDS[mode]
    body = _Reader(data[r.pos:])
    if plain:
        p = _Plain(body)
        if mode == "1":
            img = p.bitonal(w * h).reshape(h, w)
        else:
            out_max = 65535 if mode == "I" else 255
            vals = np.array(p.values(w * h * bands, maxval, out_max),
                            np.int64).reshape(h, w, bands)
            img = vals[..., 0] if bands == 1 else vals.astype(np.uint8)
    elif decoder == "ppm":  # PIL's PpmDecoder: scaled sample by sample
        size = 1 if maxval < 256 else 2
        out_max = 65535 if mode == "I" else 255
        n = w * h * bands
        raw = body.d[:n * size]
        if len(raw) < n * size:
            raise ValueError("PPM: not enough image data")
        v = np.frombuffer(raw, np.uint8 if size == 1 else ">u2").astype(
            np.float64)
        img = np.minimum(out_max, np.round(v / maxval * out_max)).astype(
            np.int64).reshape(h, w, bands)
        img = img[..., 0] if bands == 1 else img.astype(np.uint8)
    else:
        bits, fn = unpacker(mode, rawmode) if mode != "I" else (
            16, lambda rows, n: rows[:, :2 * n].view(">u2").astype(np.int64))
        stride = (w * bits + 7) // 8
        raw = body.d[:stride * h]
        if len(raw) < stride * h:
            raise ValueError("PPM: image file is truncated")
        img = fn(np.frombuffer(raw, np.uint8).reshape(h, stride), w)
        if flip:
            img = img[::-1]
    if isinstance(img, np.ndarray) and img.ndim == 3 and mode in (
            "RGB", "RGBA", "CMYK"):
        four = np.zeros((h, w, 4), np.uint8)
        four[..., :img.shape[2]] = img
        img = four
    return to_rgb(mode, img)


# ---------------------------------------------------------------------------
# ICO and CUR
# ---------------------------------------------------------------------------

def _dib_as_bmp(data: bytes, pos: int) -> tuple:
    """The DIB at ``pos`` as a BMP file whose height is half the header's
    (the XOR image): (bmp bytes, the pixel data's offset in ``data``, width,
    half height), with PIL's DibImageFile offsets (pixels right after the
    header, its bit masks and palette)."""
    if pos + 4 > len(data):  # struct.error in PIL's _bitmap
        raise NotThisFormat("ICO/CUR: truncated bitmap header")
    hsize = struct.unpack_from("<I", data, pos)[0]
    if pos + hsize > len(data) or hsize < 12:
        raise ValueError("ICO/CUR: truncated bitmap header")
    dib = bytearray(data[pos:])
    if hsize == 12:
        w, h, _, bits = struct.unpack_from("<HHHH", dib, 4)
        half, colors, pad, masks = h // 2, 1 << bits, 3, 0
        struct.pack_into("<H", dib, 8, half)
    elif hsize in (40, 52, 56, 64, 108, 124):
        w, hv = struct.unpack_from("<Ii", dib, 4)
        flip = dib[11] == 0xFF
        h = (2 ** 32 - (hv & 0xFFFFFFFF)) if flip else hv & 0xFFFFFFFF
        half = int(h / 2)
        struct.pack_into("<i", dib, 8, -half if flip else half)
        bits, comp = struct.unpack_from("<HI", dib, 14)
        colors = struct.unpack_from("<I", dib, 32)[0] or (1 << bits)
        pad = 4
        masks = 12 if comp == 3 and hsize < 48 else 0
    else:
        raise ValueError(f"ICO/CUR: unsupported bitmap header size {hsize}")
    if half <= 0 or w <= 0:
        raise ValueError("ICO/CUR: empty bitmap")
    table = pad * colors if bits <= 8 else 0
    pixels = min(pos + hsize + masks + table, len(data))
    bmp = (b"BM" + struct.pack("<IHHI", 14 + len(dib), 0, 0,
                               14 + pixels - pos) + bytes(dib))
    return bmp, pixels, w, half


def decode_ico_rgb8(data: bytes) -> np.ndarray:
    """ICO bytes -> uint8 HxWx3 as PIL's IcoImagePlugin opens the file and
    ``convert("RGB")`` maps it. Raises ValueError where PIL raises."""
    if not data.startswith(b"\x00\x00\x01\x00"):
        raise ValueError("not an ICO file")
    n = struct.unpack_from("<H", data, 4)[0]
    entries = []
    for i in range(n):
        s = data[6 + 16 * i:22 + 16 * i]
        if len(s) < 16:
            raise NotThisFormat("ICO: truncated directory")
        colors, bpp = s[2], struct.unpack_from("<H", s, 6)[0]
        depth = bpp or (colors != 0 and math.ceil(math.log(colors, 2))) or 256
        w, h = s[0] or 256, s[1] or 256
        entries.append(dict(dim=(w, h), square=w * h, depth=depth, bpp=bpp,
                            size=struct.unpack_from("<I", s, 8)[0],
                            offset=struct.unpack_from("<I", s, 12)[0]))
    if not entries:
        raise NotThisFormat("ICO: no images")
    entries.sort(key=lambda e: e["depth"])
    entries.sort(key=lambda e: e["square"], reverse=True)
    e = entries[0]
    off = e["offset"]
    if data[off:off + 8] == PNG_SIGNATURE:
        return decode_png_rgb8(data[off:])
    bmp, pixels, w, h = _dib_as_bmp(data, off)
    if w * 2 * h > MAX_PIXELS:
        raise ValueError("ICO: too many pixels")
    if e["bpp"] == 32:  # the alpha bytes PIL reads from the pixel data
        if len(data) - pixels < 4 * w * h:
            raise ValueError("ICO: alpha data is not large enough")
    else:  # the AND mask: 1 bit a pixel, rows padded to 32 bits
        stride = (w + (-w) % 32) // 8
        start = off + e["size"] - stride * h
        if start < 0 or len(data) - start < (h - 1) * stride + (w + 7) // 8:
            raise ValueError("ICO: not enough AND mask data")
    return decode_bmp_rgb8(bmp)


def decode_cur_rgb8(data: bytes) -> np.ndarray:
    """CUR bytes -> uint8 HxWx3 as PIL's CurImagePlugin opens the file (the
    first entry, replaced by any later one larger in both dimensions; its
    bitmap at half height) and ``convert("RGB")`` maps it."""
    if not data.startswith(b"\x00\x00\x02\x00"):
        raise ValueError("not a CUR file")
    n = struct.unpack_from("<H", data, 4)[0]
    m = b""
    for i in range(n):
        s = data[6 + 16 * i:22 + 16 * i]
        if not m:
            m = s
        elif len(s) < 2:
            raise NotThisFormat("CUR: truncated directory")
        elif s[0] > m[0] and s[1] > m[1]:
            m = s
    if len(m) < 16:
        raise NotThisFormat("CUR: no cursors, or a truncated directory")
    # offset 0 reads on where the directory ends (PIL does not seek)
    off = struct.unpack_from("<I", m, 12)[0] or min(6 + 16 * n, len(data))
    bmp, _, w, h = _dib_as_bmp(data, off)
    return decode_bmp_rgb8(bmp)


# ---------------------------------------------------------------------------
# QOI
# ---------------------------------------------------------------------------

def decode_qoi_rgb8(data: bytes) -> np.ndarray:
    """QOI bytes -> uint8 HxWx3 as PIL's QoiImagePlugin decodes them (a
    channels byte of 3 is RGB, anything else RGBA) and ``convert("RGB")``
    drops the alpha. Raises ValueError where PIL raises."""
    if not data.startswith(b"qoif") or len(data) < 13:
        raise ValueError("not a QOI file")
    w, h = struct.unpack_from(">II", data, 4)
    bands = 3 if data[12] == 3 else 4
    if w == 0 or h == 0:
        raise ValueError("QOI: empty image")
    if w * h > MAX_PIXELS:
        raise ValueError(f"QOI: {w}x{h} exceeds {MAX_PIXELS} pixels")
    out = np.empty((h, w, bands), np.uint8)
    body = data[14:]
    if tiff_lib().f101qoi_decode(body, len(body), w, h, bands,
                                 out.ctypes.data) < 0:
        raise ValueError("QOI: data ends before the image is full")
    return np.ascontiguousarray(out[..., :3])
