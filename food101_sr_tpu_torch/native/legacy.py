"""The formats PIL's opener walk reaches past the common ones, decoded as
Pillow 12.1's plugins open them and ``convert("RGB")`` maps them: DIB,
PCX and DCX, IM, IMT, IPTC, PhotoCD, PSD, SGI, SPIDER, Sun raster and
TGA.

Each ``open_<format>(data)`` is the plugin's ``_open``: it raises
:class:`NotThisFormat` where PIL's raises an exception ``Image.open``
catches (the walk goes on), ValueError where PIL's raises another one,
and returns an ``Opened`` (PIL's size and the load step). Headers are
parsed here; the run-length loops and PhotoCD's YCC conversion are in
``fast_legacy.cpp``, the raw rows are unpacked with numpy as PIL's row
unpackers do.

- TGA: image types 1, 2, 3 (raw) and 9, 10, 11 (PIL's ``tga_rle``: runs
  do not cross rows, literals do; a 1-bit RLE image never completes),
  depths 1, 8, 16 (``BGRA;15Z``), 24 and 32, colour maps of 16 and 24
  bits after ``start`` zero entries (32-bit maps and more than 256
  entries are PIL's load errors), a colour map on a grey image used as
  its palette, bottom-up and mirrored layouts.
- PCX: 1 bit in 1, 2 or 4 planes (the header's 16-colour palette), 8
  bits in 1 plane (the VGA palette after ``0x0C`` unless it is the grey
  ramp) or 3; PIL's stride; DCX: the first PCX of its table.
- SGI: raw and RLE, 1 or 2 bytes a channel (the high byte kept), 1, 3 or
  4 channels, rows bottom-up; PIL's ``sgi_rle`` table checks and its
  early stop on a packet at a row's last byte.
- Sun raster: 1, 4, 8, 24 and 32 bits, types 0-5 (2 is run-length coded,
  its rows without the 16-bit padding, as in PIL), planar RGB colour maps.
- IM: the text header (lines of at most 100 bytes, ``Key: value``, the
  first frame), the modes its ``OPEN`` table maps that convert to RGB,
  and a ``Lut`` palette.
- IMT (NIH Image), "L". IPTC: the embedded image through the walk again,
  raw data as the PGM PIL writes around it, one band placed as
  ``Image.merge`` places it. PhotoCD: the 768 x 512 base image, turned by
  the orientation byte. SPIDER: float32 in either byte order.
- PSD: the merged image of each mode PIL's table maps (bitmap, grey,
  indexed, RGB(A), CMYK, Lab, multichannel and duotone as grey), raw or
  PackBits (PackDecode.c: one stream a channel, a packet cut at its
  row's end), Lab through ``cielab.py``.
"""
from __future__ import annotations

import ctypes
import re
import struct
from typing import Callable, NamedTuple

import numpy as np

from . import (_BMP_MASKS, NotThisFormat, UnsupportedImage, _load,
               build_error, decode_bmp_rgb8)
from .cielab import lab_to_rgb
from .tiff import UNPACKERS, _pixels4 as _four, to_rgb


class Opened(NamedTuple):
    """What an opener's ``_open`` leaves: PIL's ``im.size`` (for the
    decompression-bomb check) and the load step (-> uint8 HxWx3)."""
    size: tuple
    load: Callable[[], np.ndarray]


def _i16(b: bytes, at: int = 0, e: str = "<") -> int:
    return struct.unpack_from(e + "H", b, at)[0]


def _i32(b: bytes, at: int = 0, e: str = "<") -> int:
    return struct.unpack_from(e + "I", b, at)[0]


def _register(lib):
    p, ll, i, cp = ctypes.c_void_p, ctypes.c_long, ctypes.c_int, \
        ctypes.c_char_p
    lib.f101tga_rle.argtypes = [cp, ll, p, ll, ll, i]
    lib.f101pcx_rle.argtypes = [cp, ll, p, ll, ll]
    lib.f101sun_rle.argtypes = [cp, ll, p, ll, ll]
    lib.f101sgi_rle.argtypes = [cp, ll, p, ll, ll, i, i]
    lib.f101pcd_rgb.argtypes = [cp, ll, p]
    lib.f101packbits.argtypes = [cp, ll, p, ll, ll]
    for f in (lib.f101tga_rle, lib.f101pcx_rle, lib.f101sun_rle,
              lib.f101sgi_rle, lib.f101pcd_rgb, lib.f101packbits):
        f.restype = i


def legacy_lib() -> ctypes.CDLL:
    lib = _load("fast_legacy", (), _register)
    if lib is None:
        raise UnsupportedImage("the legacy raster unit (native/"
                               "fast_legacy.cpp, no library needed) did not "
                               f"build here: {build_error('fast_legacy')}")
    return lib


# ---------------------------------------------------------------------------
# PIL's row unpackers and decoders
# ---------------------------------------------------------------------------

def _bgr(r, n, size, alpha=False):
    k = r[:, :n * size].reshape(r.shape[0], n, size)
    bands = {0: k[..., 2], 1: k[..., 1], 2: k[..., 0]}
    if alpha:
        bands[3] = k[..., 3]
    return _four(r.shape[0], n, bands)


def _bgra15z(r, n):
    v = r[:, :2 * n].view("<u2").astype(np.int32)
    c = [((v >> s) & 31) * 255 // 31 for s in (10, 5, 0)]
    return _four(r.shape[0], n, {0: c[0], 1: c[1], 2: c[2],
                                 3: np.where(v >> 15, 0, 255)})


def _lines(k):
    """Line-interleaved planes (``RGB;L`` and the like): k bands a row."""
    return lambda r, n: _four(r.shape[0], n, {
        i: r[:, i * n:(i + 1) * n] for i in range(k)})


def _planes_bits(k, spacing=None):
    """``P;2L``/``P;4L``: k bit planes ``spacing`` bytes apart (ceil(n /
    8) where not given)."""
    def f(r, n):
        s = spacing or (n + 7) // 8
        out = np.zeros((r.shape[0], n), np.uint8)
        for i in range(k):
            plane = np.unpackbits(r[:, i * s:(i + 1) * s], axis=1)[:, :n]
            out |= plane << i
        return out
    return f


def _floats(dt):
    return lambda r, n: r[:, :n * np.dtype(dt).itemsize].view(dt).astype(
        np.float64)


_UNPACK = {
    "BGR": (24, lambda r, n: _bgr(r, n, 3)),
    "BGRX": (32, lambda r, n: _bgr(r, n, 4)),
    "BGRA": (32, lambda r, n: _bgr(r, n, 4, True)),
    "BGRA;15Z": (16, _bgra15z),
    "RGB;L": (24, _lines(3)), "RGBX;L": (32, _lines(3)),
    "RGBA;L": (32, _lines(4)), "CMYK;L": (32, _lines(4)),
    "LA;L": (16, lambda r, n: _four(r.shape[0], n, {
        0: r[:, :n], 1: r[:, :n], 2: r[:, :n], 3: r[:, n:2 * n]})),
    "PA;L": (16, lambda r, n: _four(r.shape[0], n, {0: r[:, :n],
                                                    3: r[:, n:2 * n]})),
    "P;2L": (2, _planes_bits(2)), "P;4L": (4, _planes_bits(4)),
    "F;8": (8, _floats("u1")), "F;8S": (8, _floats("i1")),
    "F;16": (16, _floats("<u2")), "F;16S": (16, _floats("<i2")),
    "F;32": (32, _floats("<u4")), "F;32S": (32, _floats("<i4")),
    "I;16L": UNPACKERS["I;16"], "I;32": UNPACKERS["I;32S"],
}


def _unpacker(rawmode: str):
    if rawmode in _UNPACK:
        return _UNPACK[rawmode]
    if rawmode in UNPACKERS:
        return UNPACKERS[rawmode]
    raise ValueError(f"unknown raw mode {rawmode!r}")


def _row_bytes(w: int, bits: int) -> int:
    return (w * bits + 7) // 8


def _raw(data: bytes, offset: int, w: int, h: int, rawmode: str,
         stride: int = 0, ystep: int = 1) -> np.ndarray:
    """PIL's raw decoder: h rows of ``rawmode`` from ``offset`` (``stride``
    bytes apart, 0 for packed; ``ystep`` -1 for the bottom row first),
    unpacked top-down. The data must hold every row, not the padding
    after the last."""
    bits, fn = _unpacker(rawmode)
    row = _row_bytes(w, bits)
    stride = stride or row
    if offset < 0:
        raise ValueError("tile offset cannot be negative")
    need = stride * (h - 1) + row
    if len(data) - offset < need:
        raise ValueError("image file is truncated")
    buf = np.frombuffer(data, np.uint8, count=need, offset=offset)
    rows = np.zeros((h, stride), np.uint8)
    rows.reshape(-1)[:need] = buf
    rows = rows[:, :row]
    if ystep < 0:
        rows = rows[::-1]
    return fn(np.ascontiguousarray(rows), w)


def _unpack_rows(rows: np.ndarray, rawmode: str, w: int):
    return _unpacker(rawmode)[1](np.ascontiguousarray(rows), w)


def _rle_error(rc: int, name: str):
    if rc == -1:
        raise ValueError(f"{name}: buffer overrun when reading image file")
    if rc:
        raise ValueError(f"{name}: image file is truncated")


def _palette(entries: np.ndarray) -> np.ndarray:
    """PIL's palette of a P image: the entries given, zero past them; more
    than 256 is its "invalid palette size"."""
    if len(entries) > 256:
        raise ValueError("invalid palette size")
    pal = np.zeros((256, 3), np.uint8)
    pal[:len(entries)] = entries
    return pal


def _rgb_palette(raw: bytes) -> np.ndarray:
    n = len(raw) // 3
    return _palette(np.frombuffer(raw[:3 * n], np.uint8).reshape(n, 3))


def _planar_palette(raw: bytes) -> np.ndarray:
    """``RGB;L``: n reds, n greens, then n blues."""
    n = len(raw) // 3
    v = np.frombuffer(raw[:3 * n], np.uint8)
    return _palette(np.stack([v[:n], v[n:2 * n], v[2 * n:]], 1))


def _with_palette(mode: str, img: np.ndarray, pal) -> np.ndarray:
    """``convert("RGB")`` of a decoded image; a palette on an L or LA
    image is PIL's ``putpalette`` there (the first band indexes it), and
    on any other mode but P an error."""
    if pal is None:
        return to_rgb(mode, img)
    if mode in ("P", "L"):
        return pal[img]
    if mode in ("LA", "PA"):
        return pal[img[..., 0]]
    raise ValueError(f"unrecognized image mode: a palette on {mode}")


# ---------------------------------------------------------------------------
# DIB
# ---------------------------------------------------------------------------

def open_dib(data: bytes) -> Opened:
    """DibImageFile: a BMP info header with no file header; the pixels
    follow the header, its bit masks and its palette. The header's own
    checks (PIL's ``_bitmap``) end the walk; only then does a width or
    height of 0 fall through."""
    hsize = _i32(data)
    if len(data) < hsize:
        raise ValueError("DIB: truncated header")
    masks = ()
    if hsize == 12:
        w, h, _, bits = struct.unpack_from("<HHHH", data, 4)
        comp, colors, pad = 0, 0, 3
    else:
        w, hv = struct.unpack_from("<Ii", data, 4)
        flip = data[11] == 0xFF
        h = (2 ** 32 - (hv & 0xFFFFFFFF)) if flip else hv & 0xFFFFFFFF
        bits, comp = struct.unpack_from("<HI", data, 14)
        colors = _i32(data, 32)
        pad = 4
        if comp == 3:
            if hsize >= 52:
                masks = struct.unpack_from("<III", data, 40) + (
                    (_i32(data, 52),) if hsize >= 56 else (0,))
            elif len(data) < hsize + 12:  # struct.error reading the masks
                raise NotThisFormat("DIB: truncated bit masks")
            else:
                masks = struct.unpack_from("<III", data, hsize) + (0,)
    colors = colors or (1 << bits)
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"Unsupported BMP pixel depth ({bits})")
    if comp == 3 and (bits, masks if bits == 32 else masks[:3]) not in \
            _BMP_MASKS:
        raise ValueError("Unsupported BMP bitfields layout")
    if comp not in (0, 1, 2, 3):
        raise ValueError(f"Unsupported BMP compression ({comp})")
    if bits <= 8 and not 0 < colors <= 65536:
        raise ValueError(f"Unsupported BMP Palette size ({colors})")
    if w == 0 or h == 0:
        raise NotThisFormat("DIB: empty image")
    table = pad * colors if bits <= 8 else 0
    pixels = min(hsize + (12 if comp == 3 and hsize < 52 else 0) + table,
                 len(data))
    bmp = b"BM" + struct.pack("<IHHI", 14 + len(data), 0, 0,
                              14 + pixels) + data
    return Opened((w, h), lambda: decode_bmp_rgb8(bmp))


# ---------------------------------------------------------------------------
# TGA
# ---------------------------------------------------------------------------

_TGA_MODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA",
              (2, 16): "BGRA;15Z", (2, 24): "BGR", (2, 32): "BGRA"}


def open_tga(data: bytes) -> Opened:
    s = data[:18]
    if len(s) < 18:
        raise NotThisFormat("TGA: short header")
    id_len, cmaptype, imagetype, depth, flags = s[0], s[1], s[2], s[16], \
        s[17]
    w, h = _i16(s, 12), _i16(s, 14)
    if cmaptype not in (0, 1) or w <= 0 or h <= 0 or depth not in (
            1, 8, 16, 24, 32):
        raise NotThisFormat("not a TGA file")
    if imagetype in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif imagetype in (1, 9):
        mode = "P" if cmaptype else "L"
    elif imagetype in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        raise NotThisFormat("unknown TGA mode")
    orientation = flags & 0x30
    flip = orientation in (0x10, 0x30)
    ystep = 1 if orientation in (0x20, 0x30) else -1
    pos = min(18 + id_len, len(data))
    pal = None
    if cmaptype:
        start, size, mapdepth = _i16(s, 3), _i16(s, 5), s[7]
        if mapdepth not in (16, 24, 32):
            raise NotThisFormat("unknown TGA map depth")
        k = mapdepth // 8
        raw = data[pos:pos + k * size]
        pos += len(raw)
        pal = (mapdepth, bytes(k * start) + raw)
    rawmode = _TGA_MODES.get((imagetype & 7, depth))
    offset = pos

    def load():
        if rawmode is None:
            raise ValueError("TGA: cannot load this image")
        if mode == "L" and rawmode == "P":
            raise ValueError("TGA: unknown raw mode for given image mode")
        bits = _unpacker(rawmode)[0]
        if imagetype & 8:
            row = _row_bytes(w, bits)
            out = np.zeros((h, row), np.uint8)
            src = data[offset:]
            _rle_error(legacy_lib().f101tga_rle(src, len(src),
                                                out.ctypes.data, row, h,
                                                depth // 8), "TGA")
            img = _unpack_rows(out[::-1] if ystep < 0 else out, rawmode, w)
        else:
            img = _raw(data, offset, w, h, rawmode, 0, ystep)
        if flip:
            img = img[:, ::-1]
        palette = None
        if pal is not None:
            mapdepth, raw = pal
            if mapdepth == 32:
                raise ValueError("TGA: unrecognized raw mode (BGRA palette)")
            if mapdepth == 16:
                n = len(raw) // 2
                palette = _palette(_bgra15z(
                    np.frombuffer(raw[:2 * n], np.uint8)[None], n)[0, :, :3])
            else:
                n = len(raw) // 3
                palette = _palette(np.frombuffer(raw[:3 * n], np.uint8)
                                   .reshape(n, 3)[:, ::-1])
        return _with_palette(mode, img, palette)
    return Opened((w, h), load)


# ---------------------------------------------------------------------------
# PCX and DCX
# ---------------------------------------------------------------------------

def pcx_accept(s: bytes) -> bool:
    """PcxImagePlugin._accept (DCX's frames are held to it too)."""
    return len(s) >= 2 and s[0] == 10 and s[1] in (0, 2, 3, 5)


def _open_pcx_at(data: bytes, base: int) -> Opened:
    s = data[base:base + 68]
    if not pcx_accept(s):
        raise NotThisFormat("not a PCX file")
    if len(s) < 68:  # IndexError / struct.error reading the header
        raise NotThisFormat("PCX: short header")
    x0, y0, x1, y1 = (_i16(s, k) for k in (4, 6, 8, 10))
    if x1 + 1 <= x0 or y1 + 1 <= y0:
        raise NotThisFormat("bad PCX image size")
    offset = base + len(s) + 60
    version, bits, planes, provided = s[1], s[3], s[65], _i16(s, 66)
    pal = None
    if bits == 1 and planes == 1:
        mode = rawmode = "1"
    elif bits == 1 and planes in (2, 4):
        mode, rawmode = "P", f"P;{planes}L"
        pal = _rgb_palette(s[16:64])
    elif version == 5 and bits == 8 and planes == 1:
        mode = rawmode = "L"
        tail = data[-769:]  # the whole file where it is shorter
        if len(tail) == 769 and tail[0] == 12 and tail[1:] != bytes(
                np.arange(256, dtype=np.uint8).repeat(3)):
            mode = rawmode = "P"
            pal = _rgb_palette(tail[1:])
    elif version == 5 and bits == 8 and planes == 3:
        mode, rawmode = "RGB", "RGB;L"
    else:
        raise ValueError("unknown PCX mode")
    w, h = x1 + 1 - x0, y1 + 1 - y0
    stride = (w * bits + 7) // 8
    if provided != stride:
        stride += stride % 2
    row = planes * stride

    def load():
        nbits = _unpacker(rawmode)[0]
        if (w * nbits + 7) // 8 > row:
            raise ValueError("PCX: buffer overrun")
        out = np.zeros((h, row), np.uint8)
        src = data[offset:] if offset <= len(data) else b""
        _rle_error(legacy_lib().f101pcx_rle(src, len(src), out.ctypes.data,
                                            row, h), "PCX")
        if bits == 8 and row % w and row > w:  # PcxDecode.c: planes w apart
            bands = row // w
            step = row // bands
            packed = out.copy()
            for i in range(1, bands):
                packed[:, i * w:(i + 1) * w] = out[:, i * step:i * step + w]
            out = packed
        if bits == 1 and planes > 1:  # the bit planes, ``stride`` apart
            return _with_palette(mode, _planes_bits(planes, stride)(out, w),
                                 pal)
        return _with_palette(mode, _unpack_rows(out, rawmode, w), pal)
    return Opened((w, h), load)


def open_pcx(data: bytes) -> Opened:
    return _open_pcx_at(data, 0)


def open_dcx(data: bytes) -> Opened:
    """DcxImageFile: a table of up to 1024 offsets after the magic, the
    first frame opened as a PCX."""
    offsets = []
    for i in range(1024):
        b = data[4 + 4 * i:8 + 4 * i]
        if len(b) < 4:
            raise NotThisFormat("DCX: truncated offset table")
        off = _i32(b)
        if not off:
            break
        offsets.append(off)
    if not offsets:
        raise NotThisFormat("DCX: no frames")
    return _open_pcx_at(data, offsets[0])


# ---------------------------------------------------------------------------
# SGI
# ---------------------------------------------------------------------------

_SGI_MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L;16B",
              (2, 2, 1): "L;16B", (1, 3, 3): "RGB", (2, 3, 3): "RGB;16B",
              (1, 3, 4): "RGBA", (2, 3, 4): "RGBA;16B"}


def open_sgi(data: bytes) -> Opened:
    s = data[:512]
    if len(s) < 12:
        raise NotThisFormat("SGI: short header")
    compression, bpc = s[2], s[3]
    dim, w, h, z = (_i16(s, k, ">") for k in (4, 6, 8, 10))
    rawmode = _SGI_MODES.get((bpc, dim, z))
    if rawmode is None:
        raise ValueError("Unsupported SGI image mode")
    if w == 0 or h == 0:
        raise NotThisFormat("SGI: empty image")
    mode = rawmode.split(";")[0]
    bands = len(mode)

    def load():
        if compression == 0:
            page = w * h * bpc
            img = np.zeros((h, w, 4), np.uint8)
            for k in range(bands):
                off = 512 + k * page
                if bpc == 1:
                    v = _raw(data, off, w, h, "L", 0, -1)
                else:
                    if len(data) - off < 2 * w * h:
                        raise ValueError("not enough image data")
                    v = _raw(data, off, w, h, "I;16B", 0, -1) >> 8
                img[..., k] = v
        elif compression == 1:
            row = w * bands * bpc
            out = np.zeros((h, row), np.uint8)
            body = data[512:]
            rc = legacy_lib().f101sgi_rle(body, len(data) - 512,
                                          out.ctypes.data, w, h, bands, bpc)
            _rle_error(rc, "SGI")
            px = out[::-1].reshape(h, w, bands, bpc)[..., 0]
            img = np.zeros((h, w, 4), np.uint8)
            img[..., :bands] = px
        else:
            raise ValueError("SGI: cannot load this image")
        if mode == "L":
            return to_rgb("L", img[..., 0])
        return np.ascontiguousarray(img[..., :3])
    return Opened((w, h), load)


# ---------------------------------------------------------------------------
# Sun raster
# ---------------------------------------------------------------------------

def open_sun(data: bytes) -> Opened:
    s = data[:32]
    if len(s) < 32:
        raise NotThisFormat("Sun: short header")
    w, h, depth, _, ftype, ptype, plen = struct.unpack_from(">7I", s, 4)
    if depth == 1:
        mode, rawmode = "1", "1;I"
    elif depth == 4:
        mode, rawmode = "L", "L;4"
    elif depth == 8:
        mode = rawmode = "L"
    elif depth == 24:
        mode, rawmode = "RGB", ("RGB" if ftype == 3 else "BGR")
    elif depth == 32:
        mode, rawmode = "RGB", ("RGBX" if ftype == 3 else "BGRX")
    else:
        raise NotThisFormat("Unsupported Mode/Bit Depth")
    offset, pal = 32, None
    if plen:
        if plen > 1024:
            raise NotThisFormat("Unsupported Color Palette Length")
        if ptype != 1:
            raise NotThisFormat("Unsupported Palette Type")
        offset += plen
        pal = data[32:32 + plen]
        if mode == "L":
            mode, rawmode = "P", rawmode.replace("L", "P")
    if ftype not in (0, 1, 2, 3, 4, 5):
        raise NotThisFormat("Unsupported Sun Raster file type")
    if w == 0 or h == 0:
        raise NotThisFormat("Sun: empty image")
    stride = ((w * depth + 15) // 16) * 2

    def load():
        if ftype == 2:
            row = _row_bytes(w, _unpacker(rawmode)[0])
            out = np.zeros((h, row), np.uint8)
            src = data[offset:]
            _rle_error(legacy_lib().f101sun_rle(src, len(src),
                                                out.ctypes.data, row, h),
                       "Sun")
            img = _unpack_rows(out, rawmode, w)
        else:
            img = _raw(data, offset, w, h, rawmode, stride)
        return _with_palette(mode, img, None if pal is None
                             else _planar_palette(pal))
    return Opened((w, h), load)


# ---------------------------------------------------------------------------
# PhotoCD
# ---------------------------------------------------------------------------

def open_pcd(data: bytes) -> Opened:
    s = data[2048:2048 + 1539]
    if not s.startswith(b"PCD_"):
        raise NotThisFormat("not a PCD file")
    if len(s) < 1539:
        raise NotThisFormat("PCD: short header")
    orientation = s[1538] & 3
    turn = {1: 1, 3: 3}.get(orientation, 0)

    def load():
        out = np.empty((512, 768, 3), np.uint8)
        src = data[96 * 2048:]
        _rle_error(legacy_lib().f101pcd_rgb(src, len(src), out.ctypes.data),
                   "PCD")
        return np.ascontiguousarray(np.rot90(out, turn))
    return Opened((512, 768) if turn else (768, 512), load)


# ---------------------------------------------------------------------------
# SPIDER
# ---------------------------------------------------------------------------

def _is_int(f: float) -> bool:
    try:
        return f - int(f) == 0
    except (ValueError, OverflowError):
        return False


def _spider_header(t: tuple) -> int:
    h = (99,) + t
    if not all(_is_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    return labbyt if labbyt == labrec * lenbyt else 0


def _int(v: float) -> int:
    """Python's int() of a header float, NaN and infinity PIL's error."""
    try:
        return int(v)
    except (ValueError, OverflowError) as e:
        raise ValueError(f"SPIDER: {e}") from None


def open_spider(data: bytes) -> Opened:
    f = data[:108]
    if len(f) < 108:
        raise NotThisFormat("not a valid Spider file")
    big, t = True, struct.unpack(">27f", f)
    hdrlen = _spider_header(t)
    if hdrlen == 0:
        big, t = False, struct.unpack("<27f", f)
        hdrlen = _spider_header(t)
    if hdrlen == 0:
        raise NotThisFormat("not a valid Spider file")
    h = (99,) + t
    if int(h[5]) != 1:
        raise NotThisFormat("not a Spider 2D image")
    w, ht = int(h[12]), int(h[2])
    istack, imgnumber = _int(h[24]), _int(h[27])
    if istack == 0 and imgnumber == 0:
        offset = hdrlen
    elif istack > 0 and imgnumber == 0:
        _int(h[26])
        offset = 2 * hdrlen
    elif istack == 0 and imgnumber > 0:  # self.stkoffset is unset
        raise ValueError("SPIDER: an image within a stack, opened alone")
    else:
        raise NotThisFormat("inconsistent stack header values")
    if w <= 0 or ht <= 0:
        raise NotThisFormat("SPIDER: empty image")
    rawmode = "F;32BF" if big else "F;32F"
    return Opened((w, ht), lambda: to_rgb("F", _raw(data, offset, w, ht,
                                                   rawmode)))


# ---------------------------------------------------------------------------
# IMT
# ---------------------------------------------------------------------------

_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def open_imt(data: bytes) -> Opened:
    """ImtImageFile._open: ``key value`` lines up to a form feed."""
    buffer = data[:100]
    pos = len(buffer)
    if b"\n" not in buffer:
        raise NotThisFormat("not an IM file")
    w = h = 0
    mode, offset = "", None
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = data[pos:pos + 1]
            pos += len(s)
        if not s:
            break
        if s == b"\x0c":
            offset = pos - len(buffer)
            break
        if b"\n" not in buffer:
            more = data[pos:pos + 100]
            buffer += more
            pos += len(more)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = _IMT_FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        if k == b"width":
            w = int(v)
        elif k == b"height":
            h = int(v)
        elif k == b"pixel" and v == b"n8":
            mode = "L"
    if not mode or w <= 0 or h <= 0:
        raise NotThisFormat("IMT: not identified")

    def load():
        if offset is None:
            raise ValueError("IMT: cannot load this image")
        return to_rgb("L", _raw(data, offset, w, h, "L"))
    return Opened((w, h), load)


# ---------------------------------------------------------------------------
# IPTC
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes, pos: int = 0):
        self.d, self.pos = data, pos

    def read(self, n: int) -> bytes:
        out = self.d[self.pos:self.pos + max(n, 0)]
        self.pos += len(out)
        return out


def _iptc_int(c: bytes) -> int:
    return _i32((b"\0\0\0\0" + c)[-4:], 0, ">")


def _iptc_field(r: _Reader):
    """IptcImageFile.field: (tag, size), or (None, 0) at zeros or the
    end."""
    s = r.read(5)
    if not s.strip(b"\x00"):
        return None, 0
    if len(s) < 4:
        raise NotThisFormat("IPTC: short field header")
    tag = s[1], s[2]
    if s[0] != 0x1C or tag[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
        raise NotThisFormat("invalid IPTC/NAA file")
    size = s[3]
    if size > 132:
        raise ValueError("illegal field length in IPTC/NAA file")
    if size == 128:
        size = 0
    elif size > 128:
        size = _iptc_int(r.read(size - 128))
    else:
        if len(s) < 5:
            raise NotThisFormat("IPTC: short field header")
        size = _i16(s, 3, ">")
    return tag, size


def _getint(info, key):
    if key not in info:
        raise NotThisFormat(f"IPTC: no {key} field")
    v = info[key]
    if not isinstance(v, bytes):  # None or a list: PIL's TypeError
        raise NotThisFormat(f"IPTC: field {key} is not one value")
    return _iptc_int(v)


def _jpeg_components(data: bytes):
    """The component count of a JPEG's frame header, or None."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker, n = data[pos + 1], _i16(data, pos + 2, ">")
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return data[pos + 9] if pos + 9 < len(data) else None
        pos += 2 + n
    return None


# PIL's IptcImageFile.load loads the embedded image in a Python frame of
# its own, so IPTC images wrapped in IPTC images run into CPython's
# recursion limit (1000 frames): the JAX package's HTTP server answers 400
# past 984 levels around a JPEG. The port unwraps them in a loop and
# stops at the same depth.
IPTC_LEVELS = 984


class _IptcLoad:
    """An IPTC image's load step: the image its (8, 10) fields embed
    (``payload()``), opened through the walk again, whole where ``band``
    is None, else as that band of ``mode`` (``Image.merge``)."""

    def __init__(self, payload, band, mode):
        self.payload, self.band, self.mode = payload, band, mode

    def __call__(self) -> np.ndarray:
        size, got, inner = _embedded(self.payload())
        if self.band is None:
            return got.load()
        # Image.merge(mode, bands): the embedded image must load as "L",
        # at the size it opened with (that of the outermost image an
        # IPTC wrapper embeds, the other bands' size)
        if isinstance(got.load, _IptcLoad):  # of 3 or 4 bands
            raise ValueError("IPTC: mode mismatch merging a band")
        px = got.load()
        if inner.startswith(b"\xff\xd8\xff"):
            if _jpeg_components(inner) != 1:
                raise ValueError("IPTC: mode mismatch merging a band")
        elif not inner.startswith(b"P5"):
            if (px != px[..., :1]).any():  # colour: not an "L" image
                raise ValueError("IPTC: mode mismatch merging a band")
            raise UnsupportedImage("IPTC: a grey embedded image other than "
                                   "PGM or JPEG in one band is not "
                                   "supported")
        gray = px[..., 0]
        if gray.shape != (size[1], size[0]):
            raise ValueError("IPTC: size mismatch merging a band")
        n = 3 if self.mode == "RGB" else 4
        if not -n <= self.band < n:
            raise ValueError("IPTC: band index out of range")
        img = np.zeros(gray.shape + (4,), np.uint8)
        img[..., self.band % n] = gray
        return to_rgb(self.mode, img)


def _embedded(inner: bytes):
    """(the size the embedded image opens with, the image under the IPTC
    images of one band-less layer wrapped around it, its bytes): each
    such wrapper is unwrapped in turn, up to ``IPTC_LEVELS`` with the
    IPTC image that embeds ``inner``."""
    from .openers import open_image
    got = open_image(inner)
    size = got.size
    for _ in range(IPTC_LEVELS):
        if not (isinstance(got.load, _IptcLoad) and got.load.band is None):
            return size, got, inner
        inner = got.load.payload()
        got = open_image(inner)
    raise ValueError(f"IPTC: more than {IPTC_LEVELS} levels of IPTC "
                     "images (PIL's RecursionError)")


def open_iptc(data: bytes) -> Opened:
    r = _Reader(data)
    info: dict = {}
    while True:
        offset = r.pos
        tag, size = _iptc_field(r)
        if not tag or tag == (8, 10):
            break
        v = r.read(size) if size else None
        if tag in info:
            if isinstance(info[tag], list):
                info[tag].append(v)
            else:
                info[tag] = [info[tag], v]
        else:
            info[tag] = v
    if (3, 60) not in info or info[(3, 60)] is None:
        raise NotThisFormat("IPTC: no layers field")
    spec = info[(3, 60)]
    if len(spec) < 2:
        raise NotThisFormat("IPTC: short layers field")
    layers, component = spec[0], spec[1]
    mode, band = "", None
    if layers == 1 and not component:
        mode = "L"
    else:
        if layers == 3 and component:
            mode = "RGB"
        elif layers == 4 and component:
            mode = "CMYK"
        if (3, 65) in info:
            v = info[(3, 65)]
            if v is None or len(v) < 1:
                raise NotThisFormat("IPTC: bad band field")
            band = v[0] - 1 if isinstance(v, bytes) else None
            if band is None:  # a list: its first value minus one
                raise NotThisFormat("IPTC: repeated band field")
        else:
            band = 0
    w, h = _getint(info, (3, 20)), _getint(info, (3, 30))
    if (3, 120) not in info:
        raise ValueError("Unknown IPTC image compression")
    comp = {1: "raw", 5: "jpeg"}.get(_getint(info, (3, 120)))
    if comp is None:
        raise ValueError("Unknown IPTC image compression")
    if not mode or w <= 0 or h <= 0:
        raise NotThisFormat("IPTC: not identified")
    has_tile = tag == (8, 10)

    def payload() -> bytes:
        if not has_tile:
            raise ValueError("IPTC: cannot load this image")
        rr = _Reader(data, offset)
        parts = [b"P5\n%d %d\n255\n" % (w, h)] if comp == "raw" else []
        while True:
            t, size = _iptc_field(rr)
            if t != (8, 10):
                break
            parts.append(rr.read(size))
        return b"".join(parts)
    return Opened((w, h), _IptcLoad(payload, band, mode))


# ---------------------------------------------------------------------------
# IM
# ---------------------------------------------------------------------------

_IM_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_IM_TAGS = ("Comment", "Date", "Digitalization equipment",
            "File size (no of images)", "Lut", "Name", "Scale (x,y)",
            "Image size (x*y)", "Image type")
_IM_OPEN = {
    "0 1 image": ("1", "1"), "L 1 image": ("1", "1"),
    "Greyscale image": ("L", "L"), "Grayscale image": ("L", "L"),
    "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
    "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"),
    "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"),
    "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
    "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
    "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"),
    "PA image": ("LA", "PA;L"), "RGBA image": ("RGBA", "RGBA;L"),
    "RGBX image": ("RGB", "RGBX;L"), "CMYK image": ("CMYK", "CMYK;L"),
    "YCC image": ("YCbCr", "YCbCr;L"),
}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    _IM_OPEN[f"L {_i} image"] = ("F", f"F;{_i}")
    _IM_OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    _IM_OPEN[f"L {_i} image"] = (f"I;{_i}", f"I;{_i}")
    _IM_OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
_IM_OPEN["L 32S image"] = _IM_OPEN["L*32S image"] = ("I", "I;32S")
for _j in range(2, 33):
    _IM_OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")
# (mode, raw mode) pairs decoded here; of PIL's others, YCbCr and the bit
# decoder's F;n are refused by name, the rest have no unpacker in PIL
_IM_DECODED = {("1", "1"), ("L", "L"), ("P", "P"), ("P", "L"), ("P", "P;2"),
               ("P", "P;4"), ("RGB", "RGB;L"), ("RGB", "RGB"),
               ("RGB", "RGBX;L"), ("RGBA", "RGBA;L"), ("CMYK", "CMYK;L"),
               ("LA", "LA;L"), ("PA", "PA;L"), ("I", "I;32S"), ("I", "I;32"),
               ("RGB", "RGB;T"), ("RGB", "RYB;T"),
               ("F", "F;8"), ("F", "F;8S"), ("F", "F;16"), ("F", "F;16S"),
               ("F", "F;32"), ("F", "F;32F"), ("I;16", "I;16"),
               ("I;16L", "I;16L"), ("I;16B", "I;16B")}


def _number(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)


def open_im(data: bytes) -> Opened:
    """ImImageFile._open: ``Key: value`` lines until a NUL or ^Z, the
    image type mapped by PIL's table, a 768-byte ``Lut`` after the
    header; the first frame, bottom-up."""
    if b"\n" not in data[:100]:
        raise NotThisFormat("not an IM file")
    info = {"Image type": "L", "Image size (x*y)": (512, 512)}
    rawmode, n, pos = "L", 0, 0
    s = b""
    while True:
        s = data[pos:pos + 1]
        pos += len(s)
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end + 1
        s += data[pos:end]
        pos = end
        if len(s) > 100:
            raise NotThisFormat("not an IM file")
        if s.endswith(b"\r\n"):
            s = s[:-2]
        elif s.endswith(b"\n"):
            s = s[:-1]
        m = _IM_SPLIT.match(s)
        if not m:
            raise NotThisFormat("Syntax error in IM header")
        k, v = (x.decode("latin-1") for x in m.group(1, 2))
        if k in ("File size (no of images)", "Scale (x,y)",
                 "Image size (x*y)"):
            v = tuple(map(_number, v.replace("*", ",").split(",")))
            if len(v) == 1:
                v = v[0]
        elif k == "Image type" and v in _IM_OPEN:
            v, rawmode = _IM_OPEN[v]
        if k != "Comment":
            info[k] = v
        if k in _IM_TAGS:
            n += 1
    if not n:
        raise NotThisFormat("Not an IM file")
    size, mode = info["Image size (x*y)"], info["Image type"]
    if s == b"\0":  # the header ends at a NUL: the data after the ^Z
        pos = data.find(b"\x1a", pos) + 1
    if not s or not pos:
        raise NotThisFormat("File truncated")
    pal = None
    if "Lut" in info:
        lut = data[pos:pos + 768]
        pos += len(lut)
        if len(lut) < 768:  # IndexError in PIL's palette scan
            raise NotThisFormat("IM: short palette")
        v = np.frombuffer(lut, np.uint8).reshape(3, 256)
        grey = bool((v[0] == v[1]).all() and (v[1] == v[2]).all())
        if mode in ("L", "LA", "P", "PA") and not grey:
            if mode in ("L", "P"):
                mode = rawmode = "P"
            else:
                mode, rawmode = "PA", "PA;L"
            pal = v.T.copy()
        # (a grey Lut that is not the ramp, or any on RGB, PIL keeps as
        # ``im.lut``, which nothing reads)
    if not mode:
        raise NotThisFormat("IM: no mode")
    if not isinstance(size, tuple):
        raise NotThisFormat("IM: the size is not a pair")
    if len(size) < 2 or size[0] <= 0 or size[1] <= 0:
        raise NotThisFormat("IM: empty image")
    offset = pos

    def load():
        if len(size) != 2 or not all(isinstance(x, int) for x in size):
            raise ValueError("IM: the size is not two integers")
        if (mode, rawmode) not in _IM_DECODED:
            if mode == "YCbCr" or re.fullmatch(r"F;\d+", rawmode):
                raise UnsupportedImage(f"IM: mode {mode} from {rawmode} is "
                                       "not supported")
            raise ValueError(f"IM: unknown raw mode {rawmode} for {mode}")
        w, h = size
        if rawmode in ("RGB;T", "RYB;T"):  # three planes: G, R, then B
            img = np.zeros((h, w, 4), np.uint8)
            for k, band in enumerate((1, 0, 2)):
                img[..., band] = _raw(data, offset + k * w * h, w, h, "L", 0,
                                      -1)
            return np.ascontiguousarray(img[..., :3])
        img = _raw(data, offset, w, h, rawmode, 0, -1)
        if mode in ("P", "PA"):
            return (pal if pal is not None else np.zeros((256, 3), np.uint8))[
                img if mode == "P" else img[..., 0]]
        return to_rgb({"I;16L": "I;16", "I;16B": "I;16", "PA": "LA"}.get(
            mode, mode), img)
    return Opened(size[:2], load)


# ---------------------------------------------------------------------------
# PSD
# ---------------------------------------------------------------------------

# (Photoshop colour mode, bits) -> (PIL mode, channels read)
_PSD_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1),
              (2, 8): ("P", 1), (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4),
              (7, 8): ("L", 1), (8, 8): ("L", 1), (9, 8): ("LAB", 3)}


def open_psd(data: bytes) -> Opened:
    """PsdImageFile: the 26-byte header (version 1 only; a (mode, depth)
    pair outside PIL's table falls through, too few channels ends the
    walk), the colour mode data (a 768-byte planar palette for P), the
    image resources and the layer section skipped as PIL walks them, then
    the merged image: one tile per channel over the whole image, raw or
    PackBits (a stream from the tile's offset, its rows as PackDecode.c
    fills them), at offsets summed from the row byte-count table."""
    try:
        return _open_psd(data)
    except (struct.error, IndexError, KeyError) as e:
        raise NotThisFormat(f"PSD: {e or 'unknown mode'}") from None


def _open_psd(data: bytes) -> Opened:
    r = _Reader(data)
    s = r.read(26)
    if not s.startswith(b"8BPS") or _i16(s, 4, ">") != 1:
        raise NotThisFormat("not a PSD file")
    bits, nch, psd_mode = (_i16(s, k, ">") for k in (22, 12, 24))
    mode, channels = _PSD_MODES[(psd_mode, bits)]
    if channels > nch:
        raise ValueError("PSD: not enough channels")
    if mode == "RGB" and nch == 4:
        mode, channels = "RGBA", 4
    w, h = _i32(s, 18, ">"), _i32(s, 14, ">")
    palette = None
    size = _i32(r.read(4), 0, ">")
    if size:
        color = r.read(size)
        if mode == "P" and size == 768:
            palette = color
    size = _i32(r.read(4), 0, ">")
    if size:  # the image resources, each read as PIL reads them
        end = r.pos + size
        while r.pos < end:
            r.read(4)
            _i16(r.read(2), 0, ">")
            name = r.read(r.read(1)[0])
            if not len(name) & 1:
                r.read(1)
            if len(r.read(_i32(r.read(4), 0, ">"))) & 1:
                r.read(1)
    size = _i32(r.read(4), 0, ">")
    if size:  # the layer and mask section: skipped (frame 0 is the merged
        end = r.pos + size  # image)
        _i32(r.read(4), 0, ">")
        r.pos = end
    compression = _i16(r.read(2), 0, ">")
    offsets = []
    if compression == 0:
        offsets = [r.pos + c * w * h for c in range(channels)]
    elif compression == 1:
        counts = r.read(channels * h * 2)
        offset = r.pos
        for c in range(channels):
            offsets.append(offset)
            offset += sum(_i16(counts, 2 * (c * h + y), ">") for y in range(h))
    if w <= 0 or h <= 0:
        raise NotThisFormat("PSD: empty image")

    def load():
        return _psd_pixels(data, mode, w, h, compression, offsets, palette)
    return Opened((w, h), load)


def _psd_pixels(data, mode, w, h, compression, offsets, palette):
    if not offsets:  # a compression PIL does not read leaves no tiles
        raise ValueError(f"PSD: cannot load this image (compression "
                         f"{compression})")
    rawmode_bits = 1 if mode == "1" else 8
    row = _row_bytes(w, rawmode_bits)
    img = np.zeros((h, w, 4) if len(mode) > 1 else (h, w), np.uint8)
    # PIL's ImageFile.load decodes the tiles in order of their offsets
    for c, off in sorted(enumerate(offsets), key=lambda t: t[1]):
        if compression == 0:
            rows = _raw(data, off, row, h, "L")
        else:
            rows = np.zeros((h, row), np.uint8)
            src = data[off:] if off <= len(data) else b""
            _rle_error(legacy_lib().f101packbits(src, len(src),
                                                 rows.ctypes.data, row, h),
                       "PSD")
        if mode == "1":
            img[:] = _unpack_rows(rows, "1", w)
        elif img.ndim == 2:
            img[:] = rows
        else:
            img[..., c] = 255 - rows if mode == "CMYK" else rows
    if len(mode) > 1:
        img[..., len(mode):] = 255  # PIL's 4-byte storage: alpha/pad 255
    if mode == "LAB":
        return lab_to_rgb(img)
    if mode == "P":
        return _with_palette("P", img, None if palette is None
                             else _planar_palette(palette))
    return to_rgb(mode, img)
