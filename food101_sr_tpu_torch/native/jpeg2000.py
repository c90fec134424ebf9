"""JPEG 2000 uploads (JP2 and raw codestreams), decoded as Pillow 12.1
opens them: ``Jpeg2KImagePlugin``'s ``_open`` (its box reader, the SIZ and
``ihdr`` mode rules, the ``colr`` CMYK and ``pclr`` palette cases, the
comment walk), then ``Jpeg2KDecode.c`` over OpenJPEG 2.5.4 (the colour
space and unpacker tables, tile by tile, its sYCC conversion) and
``convert("RGB")``.

OpenJPEG's part is ``fast_j2k.cpp`` (the JP2 boxes OpenJPEG reads, the
codestream, tier-2, tier-1, the wavelets and colour transforms, no
library). HTJ2K (Part 15) and Part 2 extensions are refused by name
(:class:`UnsupportedImage`, 415).
"""
from __future__ import annotations

import ctypes
import io
import os
import struct

import numpy as np

from . import NotThisFormat, UnsupportedImage, _load, build_error
from .legacy import Opened
from .tiff import to_rgb

_SIG_JP2 = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
_SIG_J2K = b"\xffO\xffQ"
# OpenJPEG's colour spaces as fast_j2k.cpp reports them (4, eYCC, has no
# unpacker in PIL)
_UNSPECIFIED, _SRGB, _GRAY, _SYCC, _CMYK = 0, 1, 2, 3, 5


def _register(lib):
    p, ll, i, cp = ctypes.c_void_p, ctypes.c_long, ctypes.c_int, \
        ctypes.c_char_p
    lib.f101j2k_open.argtypes = [cp, ll, i, ctypes.POINTER(i), cp, ll]
    lib.f101j2k_open.restype = p
    lib.f101j2k_image.argtypes = [p, i, p, ll]
    lib.f101j2k_image.restype = ll
    lib.f101j2k_next_tile.argtypes = [p, p, cp, ll]
    lib.f101j2k_next_tile.restype = i
    lib.f101j2k_decode_tile.argtypes = [p, p, ll, cp, ll]
    lib.f101j2k_decode_tile.restype = i
    lib.f101j2k_end.argtypes = [p, i, cp, ll]
    lib.f101j2k_end.restype = i
    lib.f101j2k_close.argtypes = [p]
    lib.f101j2k_close.restype = None


def j2k_lib() -> ctypes.CDLL:
    lib = _load("fast_j2k", (), _register)
    if lib is None:
        raise UnsupportedImage("JPEG 2000 is not supported here: its unit "
                               "(native/fast_j2k.cpp, no library needed) "
                               f"did not build: {build_error('fast_j2k')}")
    return lib


# ---------------------------------------------------------------------------
# Jpeg2KImagePlugin._open
# ---------------------------------------------------------------------------

class _Box:
    """PIL's BoxReader over a file-like object (``length`` -1: unknown)."""

    def __init__(self, fp, length: int = -1):
        self.fp, self.has_length, self.length = fp, length >= 0, length
        self.remaining = -1

    def _can_read(self, n: int) -> bool:
        if self.has_length and self.fp.tell() + n > self.length:
            return False
        if self.remaining >= 0:
            return n <= self.remaining
        return True

    def _read(self, n: int) -> bytes:
        if not self._can_read(n):
            raise NotThisFormat("JPEG 2000: not enough data in header")
        data = self.fp.read(n)
        if len(data) < n:  # PIL's OSError: the walk ends
            raise ValueError(f"JPEG 2000: expected to read {n} bytes but "
                             f"only got {len(data)}")
        if self.remaining > 0:
            self.remaining -= n
        return data

    def fields(self, fmt: str) -> tuple:
        return struct.unpack(fmt, self._read(struct.calcsize(fmt)))

    def boxes(self) -> "_Box":
        size = self.remaining
        return _Box(io.BytesIO(self._read(size)), size)

    def has_next(self) -> bool:
        if self.has_length:
            return self.fp.tell() + self.remaining < self.length
        return True

    def next_type(self) -> bytes:
        if self.remaining > 0:
            self.fp.seek(self.remaining, os.SEEK_CUR)
        self.remaining = -1
        lbox, tbox = self.fields(">I4s")
        hlen = 8
        if lbox == 1:
            lbox, hlen = self.fields(">Q")[0], 16
        if lbox < hlen or not self._can_read(lbox - hlen):
            raise NotThisFormat("JPEG 2000: invalid header length")
        self.remaining = lbox - hlen
        return tbox


class _Palette:
    """ImagePalette.getcolor's allocation (duplicates share an index)."""

    def __init__(self, mode: str):
        self.mode, self.data, self.colors = mode, bytearray(), {}

    def getcolor(self, color: tuple):
        if self.mode == "RGB" and len(color) == 4:
            if color[3] != 255:
                raise ValueError("cannot add non-opaque RGBA color to RGB "
                                 "palette")
            color = color[:3]
        if color in self.colors:
            return
        index = len(self.data) // 3
        if index >= 256:
            raise ValueError("cannot allocate more than 256 colors")
        self.colors[color] = index
        if index * 3 < len(self.data):
            self.data[index * 3:index * 3 + 3] = bytes(color)
        else:
            self.data += bytes(color)

    def table(self) -> np.ndarray:
        """putpalette: the entries given, black past them."""
        k = len(self.mode)
        n = min(len(self.data) // k, 256)
        pal = np.zeros((256, 3), np.uint8)
        raw = np.frombuffer(bytes(self.data[:n * k]), np.uint8).reshape(n, k)
        pal[:n] = raw[:, :3]
        return pal


def _parse_codestream(fp):
    hdr = fp.read(2)
    lsiz = struct.unpack(">H", hdr)[0] if len(hdr) == 2 else None
    if lsiz is None:
        raise NotThisFormat("JPEG 2000: short SIZ")
    siz = hdr + (fp.read(lsiz - 2) if lsiz >= 2 else fp.read())
    (_, _, xsiz, ysiz, xosiz, yosiz, _, _, _, _,
     csiz) = struct.unpack_from(">HHIIIIIIIIH", siz)
    size = (xsiz - xosiz, ysiz - yosiz)
    if csiz == 1:
        ssiz = struct.unpack_from(">B", siz, 38)[0]
        mode = "I;16" if (ssiz & 0x7F) + 1 > 8 else "L"
    elif csiz in (2, 3, 4):
        mode = {2: "LA", 3: "RGB", 4: "RGBA"}[csiz]
    else:
        raise NotThisFormat("unable to determine J2K image mode")
    return size, mode


def _parse_jp2_header(fp):
    reader = _Box(fp)
    header = None
    while reader.has_next():
        tbox = reader.next_type()
        if tbox == b"jp2h":
            header = reader.boxes()
            break
        if tbox == b"ftyp":
            reader.fields(">4s")
    size = mode = nc = None
    palette = None
    while header.has_next():
        tbox = header.next_type()
        if tbox == b"ihdr":
            height, width, nc, bpc = header.fields(">IIHB")
            size = (width, height)
            if nc == 1 and (bpc & 0x7F) > 8:
                mode = "I;16"
            elif nc in (1, 2, 3, 4):
                mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[nc]
        elif tbox == b"colr" and nc == 4:
            meth, _, _, enumcs = header.fields(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = header.fields(">HB")
            depths = header.fields(">" + "B" * npc)
            if max(depths, default=0) <= 8:
                palette = _Palette("RGBA" if npc == 4 else "RGB")
                for _ in range(ne):
                    palette.getcolor(header.fields(">" + "B" * npc))
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = header.boxes()
            while res.has_next():
                if res.next_type() == b"resc":
                    res.fields(">HHHHBB")
                    break
    if size is None or mode is None:
        raise NotThisFormat("Malformed JP2 header")
    return size, mode, palette


def _parse_comment(fp):
    while True:
        marker = fp.read(2)
        if not marker:
            break
        if len(marker) < 2:  # IndexError
            raise NotThisFormat("JPEG 2000: truncated marker")
        if marker[1] in (0x90, 0xD9):
            break
        hdr = fp.read(2)
        if len(hdr) < 2:
            raise NotThisFormat("JPEG 2000: truncated marker length")
        length = struct.unpack(">H", hdr)[0]
        if marker[1] == 0x64:
            break
        fp.seek(max(fp.tell() + length - 2, 0))


def open_jpeg2000(data: bytes) -> Opened:
    """Jpeg2KImageFile._open: SyntaxError and struct.error fall through
    (:class:`NotThisFormat`), a short read in the box reader ends the walk
    (ValueError); the load step is OpenJPEG's decode as PIL drives it."""
    fp = io.BytesIO(data)
    try:
        sig = fp.read(4)
        if sig == _SIG_J2K:
            jp2 = False
            size, mode = _parse_codestream(fp)
            palette = None
            _parse_comment(fp)
        else:
            if sig + fp.read(8) != _SIG_JP2:
                raise NotThisFormat("not a JPEG 2000 file")
            jp2 = True
            size, mode, palette = _parse_jp2_header(fp)
            if fp.read(12).endswith(b"jp2c\xffO\xffQ"):
                hdr = fp.read(2)
                if len(hdr) < 2:
                    raise NotThisFormat("JPEG 2000: truncated SIZ")
                fp.seek(max(fp.tell() + struct.unpack(">H", hdr)[0] - 2, 0))
                _parse_comment(fp)
    except struct.error as e:
        raise NotThisFormat(f"JPEG 2000: {e}") from None
    except OverflowError as e:  # a box length past 2^63: ends the walk
        raise ValueError(f"JPEG 2000: {e}") from None
    if size[0] <= 0 or size[1] <= 0:
        raise NotThisFormat("JPEG 2000: empty image")
    return Opened(size, lambda: _load_rgb(data, jp2, mode, size, palette))


# ---------------------------------------------------------------------------
# Jpeg2KDecode.c
# ---------------------------------------------------------------------------

# (PIL mode, colour space, components) -> (unpacker, takes subsampling)
_UNPACKERS = {
    ("L", _GRAY, 1): ("gray_l", False), ("P", _SRGB, 1): ("gray_l", False),
    ("PA", _SRGB, 2): ("graya_la", False), ("I;16", _GRAY, 1): ("gray_i", False),
    ("LA", _GRAY, 2): ("graya_la", False),
    ("RGB", _GRAY, 1): ("gray_rgb", False), ("RGB", _GRAY, 2): ("gray_rgb", False),
    ("RGB", _SRGB, 3): ("srgb_rgb", True), ("RGB", _SYCC, 3): ("sycc_rgb", True),
    ("RGB", _SRGB, 4): ("srgb_rgb", True), ("RGB", _SYCC, 4): ("sycc_rgb", True),
    ("RGBA", _GRAY, 1): ("gray_rgb", False),
    ("RGBA", _GRAY, 2): ("graya_la", False),
    ("RGBA", _SRGB, 3): ("srgb_rgb", True),
    ("RGBA", _SYCC, 3): ("sycc_rgb", True),
    ("RGBA", _SRGB, 4): ("srgba_rgba", True),
    ("RGBA", _SYCC, 4): ("sycca_rgba", True),
    ("CMYK", _CMYK, 4): ("srgba_rgba", True),
}


def _ycbcr_rgb(px: np.ndarray) -> np.ndarray:
    """ImagingConvertYCbCr2RGB (ConvertYCbCr.c): fixed point, 6 bits."""
    y = px[..., 0].astype(np.int64)
    cb = px[..., 1].astype(np.int64) - 128
    cr = px[..., 2].astype(np.int64) - 128
    r = y + ((_R_CR[cr + 128]) >> 6)
    g = y + ((_G_CB[cb + 128] + _G_CR[cr + 128]) >> 6)
    b = y + ((_B_CB[cb + 128]) >> 6)
    out = px.copy()
    for i, v in enumerate((r, g, b)):
        out[..., i] = np.clip(v, 0, 255)
    return out


# ConvertYCbCr.c's tables: int(c * 64 * (v - 128) + 0.5), C truncation
_k = np.arange(256) - 128
_R_CR, _G_CB, _G_CR, _B_CB = (np.trunc(c * 64 * _k + 0.5).astype(np.int64)
                              for c in (1.40200, -0.34414, -0.71414, 1.77200))


class _Comp:
    def __init__(self, dx, dy, prec, sgnd):
        self.dx, self.dy, self.prec, self.sgnd = dx, dy, prec, sgnd
        self.shift8 = 8 - prec
        csiz = (prec + 7) >> 3
        self.csiz = 4 if csiz == 3 else csiz

    def offset(self, shift: int) -> int:
        off = 1 << (self.prec - 1) if self.sgnd else 0
        if shift < 0:
            off += 1 << (-shift - 1)
        return off

    def words(self, buf: np.ndarray, at: int, count: int) -> np.ndarray:
        dt = {1: np.uint8, 2: "<u2", 4: "<u4"}[self.csiz]
        n = count * self.csiz
        raw = np.zeros(n, np.uint8)
        got = buf[at:at + n]
        raw[:len(got)] = got
        return raw.view(dt).astype(np.uint64)


def _shift(words: np.ndarray, off: int, shift: int, bits: int = 8):
    """j2ku_shift(offset + word, shift), kept to ``bits`` as PIL stores."""
    v = (words + np.uint64(off)) & np.uint64(0xFFFFFFFF)
    v = v >> np.uint64(-shift) if shift < 0 else (v << np.uint64(shift))
    return (v & np.uint64((1 << bits) - 1)).astype(
        np.uint8 if bits == 8 else np.uint16)


def _unpack(kind, comps, buf, w, h):
    """One tile of OpenJPEG's buffer as PIL's unpacker reads it -> PIL's
    storage of the tile (h, w) or (h, w, 4)."""
    if kind in ("gray_l", "gray_i", "gray_rgb"):
        c = comps[0]
        bits = 16 if kind == "gray_i" else 8
        shift = (16 if kind == "gray_i" else 8) - c.prec
        v = _shift(c.words(buf, 0, w * h), c.offset(shift), shift, bits)
        v = v.reshape(h, w)
        if kind == "gray_rgb":
            out = np.full((h, w, 4), 255, np.uint8)
            out[..., :3] = v[..., None]
            return out
        return v
    if kind == "graya_la":
        c, a = comps[0], comps[1]
        v = _shift(c.words(buf, 0, w * h), c.offset(c.shift8), c.shift8)
        av = _shift(a.words(buf, c.csiz * w * h, w * h), a.offset(a.shift8),
                    a.shift8)
        out = np.empty((h, w, 4), np.uint8)
        out[..., :3] = v.reshape(h, w)[..., None]
        out[..., 3] = av.reshape(h, w)
        return out
    # srgb_rgb, sycc_rgb, srgba_rgba, sycca_rgba: PIL's strides are
    # w / dx and h / dy (floor) for each component
    nb = 4 if kind in ("srgba_rgba", "sycca_rgba") else 3
    out = np.full((h, w, 4), 255, np.uint8)
    at = 0
    ys, xs = np.arange(h), np.arange(w)
    for n, c in enumerate(comps[:nb]):
        cw, ch = w // c.dx, h // c.dy
        rows = (ys // c.dy) * cw
        idx = rows[:, None] + (xs // c.dx)[None, :]
        count = int(idx.max()) + 1 if idx.size else 0
        words = c.words(buf, at, max(count, 0))
        out[..., n] = _shift(words, c.offset(c.shift8), c.shift8)[idx]
        at += c.csiz * cw * ch
        if n == 2 and nb == 3:
            break
    if kind in ("sycc_rgb", "sycca_rgba"):
        out = _ycbcr_rgb(out)
    return out


def _err(buf) -> str:
    return buf.value.decode("latin-1", "replace")


def _load_rgb(data: bytes, jp2: bool, mode: str, size: tuple,
              palette) -> np.ndarray:
    lib = j2k_lib()
    err = ctypes.create_string_buffer(256)
    refused = ctypes.c_int(0)
    h = lib.f101j2k_open(data, len(data), int(jp2), ctypes.byref(refused),
                         err, 256)
    if refused.value:
        if h:
            lib.f101j2k_close(h)
        raise UnsupportedImage(
            "JPEG 2000 " + ("HTJ2K (Part 15)" if refused.value == 1 else
                            "Part 2 extensions") + " is not supported")
    if not h:
        raise ValueError(f"JPEG 2000: broken data stream ({_err(err)})")
    try:
        return _decode(lib, h, jp2, mode, size, palette, err)
    finally:
        lib.f101j2k_close(h)


def _decode(lib, h, jp2, mode, size, palette, err):
    info = np.zeros(6 + 4 * 16384, np.int64)
    lib.f101j2k_image(h, int(jp2), info.ctypes.data, len(info))
    ix0, iy0 = int(info[0]), int(info[1])
    nc, cs = int(info[4]), int(info[5])
    comps = [_Comp(*(int(v) for v in info[6 + 4 * i:10 + 4 * i]))
             for i in range(nc)]
    if nc < 1 or nc > 4:
        raise ValueError("JPEG 2000: broken data stream (colour space or "
                         "components PIL does not read)")
    # the first subsampled component: YCbCr where it is the 2nd or 3rd and
    # the colour space is unspecified; only some unpackers take any
    sub = next((i for i, c in enumerate(comps) if c.dx != 1 or c.dy != 1),
               -1)
    if cs == _UNSPECIFIED:
        cs = _GRAY if nc <= 2 else _SYCC if sub in (1, 2) else _SRGB
    got = _UNPACKERS.get((mode, cs, nc))
    if got is None or not (got[1] or sub == -1):
        raise ValueError(f"JPEG 2000: broken data stream (no unpacker for "
                         f"{mode} from {nc} components)")
    kind = got[0]
    w, hh = size
    img = np.zeros((hh, w), np.uint16 if mode == "I;16" else np.uint8) \
        if mode in ("L", "P", "I;16") else np.zeros((hh, w, 4), np.uint8)
    tinfo = np.zeros(7, np.int64)
    while True:
        rc = lib.f101j2k_next_tile(h, tinfo.ctypes.data, err, 256)
        if rc < 0:
            raise ValueError(f"JPEG 2000: broken data stream ({_err(err)})")
        if rc == 0:
            break
        _, tx0, ty0, tx1, ty1, tnc, dsize = (int(v) for v in tinfo)
        if (tx0 >= tx1 or ty0 >= ty1 or tx0 < ix0 or ty0 < iy0
                or tx1 - ix0 > w or ty1 - iy0 > hh or tnc != nc):
            raise ValueError("JPEG 2000: broken data stream (tile bounds)")
        buf = np.zeros(max(dsize, 1), np.uint8)
        if lib.f101j2k_decode_tile(h, buf.ctypes.data, dsize, err, 256):
            raise ValueError(f"JPEG 2000: broken data stream ({_err(err)})")
        tile = _unpack(kind, comps, buf, tx1 - tx0, ty1 - ty0)
        img[ty0 - iy0:ty1 - iy0, tx0 - ix0:tx1 - ix0] = tile
    if lib.f101j2k_end(h, int(jp2), err, 256):
        raise ValueError(f"JPEG 2000: broken data stream ({_err(err)})")
    if mode in ("P", "PA"):
        pal = palette.table() if palette is not None else np.zeros(
            (256, 3), np.uint8)
        return pal[img if mode == "P" else img[..., 0]]
    return to_rgb(mode, img.astype(np.int64) if mode == "I;16" else img)
