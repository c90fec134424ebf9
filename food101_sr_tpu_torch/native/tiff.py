"""TIFF uploads decoded as the JAX package's server decodes them: PIL's
TiffImagePlugin opens the first image file directory, reads an
uncompressed image with its own raw decoder and hands every compressed one
to libtiff, and ``convert("RGB")`` maps the mode it chose.

What is replicated, and where:

- the header and the directory as PIL's ImageFileDirectory_v2 loads them
  (both byte orders, classic and BigTIFF, PIL's two misordered headers);
- ``_setup``: the (byte order, photometric, sample format, fill order,
  bits, extra samples) key into ``OPEN_INFO`` (PIL's table, copied), which
  gives PIL's mode and raw mode; the decompression-bomb limit;
- uncompressed images: PIL's tile list (strips or tiles,
  ``PlanarConfiguration`` 2 one band a layer), ``ImageFile.load``'s reads (each tile reads on
  from its offset, StripByteCounts unused) and ``RawDecode``'s rows;
- compressed images, libtiff 4.7 as PIL's TiffDecode drives it: each strip
  or tile read by its byte count, bits reversed for ``FillOrder`` 2 except
  where the codec reads them itself, decompressed (PackBits, LZW, CCITT,
  raw-16 and ThunderScan in ``fast_tiff.cpp``; ZSTD in ``fast_zstd.cpp``;
  Deflate with the stdlib ``zlib``, LZMA with ``lzma``; JPEG with
  ``JPEGTables`` through ``fast_jpeg.cpp`` as libtiff's JPEG codec drives
  libjpeg), the predictors undone, samples in native
  order, then PIL's unpacker per row (per plane for ``PlanarConfiguration``
  2, as its libtiff decoder copies planes);
- PIL's unpackers (``Unpack.c``) for every raw mode the table names,
  ``ImageOps.exif_transpose`` for the Orientation tag, and
  ``convert("RGB")`` for each mode (``I``/``I;16``/``F`` clip to 0..255).

The compressions libtiff decodes with code of its own or libzstd's are
the port's own code too: raw-16 and ThunderScan in ``fast_tiff.cpp``, ZSTD
in ``fast_zstd.cpp`` (no library; a host where it does not build answers
415 naming it), old-style JPEG (``_Ojpeg``: tif_ojpeg.c's header parse,
the stream it hands libjpeg, decoded by ``fast_jpeg.cpp`` to raw YCbCr)
through libtiff's RGBA reader (``ycbcr_rgba``), as PIL reads YCbCr that is
not contiguous JPEG.

CIELab converts to RGB as PIL's LittleCMS transform does (``cielab.py``).
Refused by name (:class:`UnsupportedImage`, 415): YCbCr JPEG or
old-style JPEG in separate planes whose headers libtiff accepts. Everything PIL refuses (WebP and
SGILog TIFFs among them) raises ValueError.
"""
from __future__ import annotations

import ctypes
import lzma
import struct
import zlib
from fractions import Fraction

import numpy as np

from . import MAX_PIXELS, UnsupportedImage, _jpeg_lib, _load, build_error
from .cielab import lab_to_rgb

II, MM = b"II", b"MM"

# PIL's TiffImagePlugin.OPEN_INFO: (byte order, photometric, sample
# format, fill order, bits per sample, extra samples) -> (mode, raw mode)
_OPEN_INFO_ANY = {
    (0, (1,), 1, (1,), ()): ("1", "1;I"),
    (0, (1,), 2, (1,), ()): ("1", "1;IR"),
    (1, (1,), 1, (1,), ()): ("1", "1"),
    (1, (1,), 2, (1,), ()): ("1", "1;R"),
    (0, (1,), 1, (2,), ()): ("L", "L;2I"),
    (0, (1,), 2, (2,), ()): ("L", "L;2IR"),
    (1, (1,), 1, (2,), ()): ("L", "L;2"),
    (1, (1,), 2, (2,), ()): ("L", "L;2R"),
    (0, (1,), 1, (4,), ()): ("L", "L;4I"),
    (0, (1,), 2, (4,), ()): ("L", "L;4IR"),
    (1, (1,), 1, (4,), ()): ("L", "L;4"),
    (1, (1,), 2, (4,), ()): ("L", "L;4R"),
    (0, (1,), 1, (8,), ()): ("L", "L;I"),
    (0, (1,), 2, (8,), ()): ("L", "L;IR"),
    (1, (1,), 1, (8,), ()): ("L", "L"),
    (1, (2,), 1, (8,), ()): ("L", "L"),
    (1, (1,), 2, (8,), ()): ("L", "L;R"),
    (1, (1,), 1, (8, 8), (2,)): ("LA", "LA"),
    (2, (1,), 1, (8, 8, 8), ()): ("RGB", "RGB"),
    (2, (1,), 2, (8, 8, 8), ()): ("RGB", "RGB;R"),
    (2, (1,), 1, (8, 8, 8, 8), ()): ("RGBA", "RGBA"),
    (2, (1,), 1, (8, 8, 8, 8), (0,)): ("RGB", "RGBX"),
    (2, (1,), 1, (8, 8, 8, 8, 8), (0, 0)): ("RGB", "RGBXX"),
    (2, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0, 0)): ("RGB", "RGBXXX"),
    (2, (1,), 1, (8, 8, 8, 8), (1,)): ("RGBA", "RGBa"),
    (2, (1,), 1, (8, 8, 8, 8, 8), (1, 0)): ("RGBA", "RGBaX"),
    (2, (1,), 1, (8, 8, 8, 8, 8, 8), (1, 0, 0)): ("RGBA", "RGBaXX"),
    (2, (1,), 1, (8, 8, 8, 8), (2,)): ("RGBA", "RGBA"),
    (2, (1,), 1, (8, 8, 8, 8, 8), (2, 0)): ("RGBA", "RGBAX"),
    (2, (1,), 1, (8, 8, 8, 8, 8, 8), (2, 0, 0)): ("RGBA", "RGBAXX"),
    (2, (1,), 1, (8, 8, 8, 8), (999,)): ("RGBA", "RGBA"),
    (3, (1,), 1, (1,), ()): ("P", "P;1"),
    (3, (1,), 2, (1,), ()): ("P", "P;1R"),
    (3, (1,), 1, (2,), ()): ("P", "P;2"),
    (3, (1,), 2, (2,), ()): ("P", "P;2R"),
    (3, (1,), 1, (4,), ()): ("P", "P;4"),
    (3, (1,), 2, (4,), ()): ("P", "P;4R"),
    (3, (1,), 1, (8,), ()): ("P", "P"),
    (3, (1,), 1, (8, 8), (0,)): ("P", "PX"),
    (3, (1,), 1, (8, 8), (2,)): ("PA", "PA"),
    (3, (1,), 2, (8,), ()): ("P", "P;R"),
    (5, (1,), 1, (8, 8, 8, 8), ()): ("CMYK", "CMYK"),
    (5, (1,), 1, (8, 8, 8, 8, 8), (0,)): ("CMYK", "CMYKX"),
    (5, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0)): ("CMYK", "CMYKXX"),
    (6, (1,), 1, (8,), ()): ("L", "L"),
    (6, (1,), 1, (8, 8, 8), ()): ("RGB", "RGBX"),
    (8, (1,), 1, (8, 8, 8), ()): ("LAB", "LAB"),
}
OPEN_INFO = {(bo,) + k: v for k, v in _OPEN_INFO_ANY.items()
             for bo in (II, MM)}
OPEN_INFO.update({
    (II, 1, (1,), 1, (12,), ()): ("I;16", "I;12"),
    (II, 0, (1,), 1, (16,), ()): ("I;16", "I;16"),
    (II, 1, (1,), 1, (16,), ()): ("I;16", "I;16"),
    (MM, 1, (1,), 1, (16,), ()): ("I;16B", "I;16B"),
    (II, 1, (1,), 2, (16,), ()): ("I;16", "I;16R"),
    (II, 1, (2,), 1, (16,), ()): ("I", "I;16S"),
    (MM, 1, (2,), 1, (16,), ()): ("I", "I;16BS"),
    (II, 0, (3,), 1, (32,), ()): ("F", "F;32F"),
    (MM, 0, (3,), 1, (32,), ()): ("F", "F;32BF"),
    (II, 1, (1,), 1, (32,), ()): ("I", "I;32N"),
    (II, 1, (2,), 1, (32,), ()): ("I", "I;32S"),
    (MM, 1, (2,), 1, (32,), ()): ("I", "I;32BS"),
    (II, 1, (3,), 1, (32,), ()): ("F", "F;32F"),
    (MM, 1, (3,), 1, (32,), ()): ("F", "F;32BF"),
    (II, 2, (1,), 1, (16, 16, 16), ()): ("RGB", "RGB;16L"),
    (MM, 2, (1,), 1, (16, 16, 16), ()): ("RGB", "RGB;16B"),
    (II, 2, (1,), 1, (16, 16, 16, 16), ()): ("RGBA", "RGBA;16L"),
    (MM, 2, (1,), 1, (16, 16, 16, 16), ()): ("RGBA", "RGBA;16B"),
    (II, 2, (1,), 1, (16, 16, 16, 16), (0,)): ("RGB", "RGBX;16L"),
    (MM, 2, (1,), 1, (16, 16, 16, 16), (0,)): ("RGB", "RGBX;16B"),
    (II, 2, (1,), 1, (16, 16, 16, 16), (1,)): ("RGBA", "RGBa;16L"),
    (MM, 2, (1,), 1, (16, 16, 16, 16), (1,)): ("RGBA", "RGBa;16B"),
    (II, 2, (1,), 1, (16, 16, 16, 16), (2,)): ("RGBA", "RGBA;16L"),
    (MM, 2, (1,), 1, (16, 16, 16, 16), (2,)): ("RGBA", "RGBA;16B"),
    (II, 5, (1,), 1, (16, 16, 16, 16), ()): ("CMYK", "CMYK;16L"),
    (MM, 5, (1,), 1, (16, 16, 16, 16), ()): ("CMYK", "CMYK;16B"),
})
MAX_SAMPLES = 6  # the most samples a key of OPEN_INFO has

# compression -> PIL's name (TiffImagePlugin.COMPRESSION_INFO)
COMPRESSIONS = {1: "raw", 2: "tiff_ccitt", 3: "group3", 4: "group4",
                5: "tiff_lzw", 6: "tiff_jpeg", 7: "jpeg",
                8: "tiff_adobe_deflate", 32771: "tiff_raw_16",
                32773: "packbits", 32809: "tiff_thunderscan",
                32946: "tiff_deflate", 34676: "tiff_sgilog",
                34677: "tiff_sgilog24", 34925: "lzma", 50000: "zstd",
                50001: "webp"}
# the CCITT codecs (they read FillOrder themselves), and the ones
# PredictorSetup runs for
_FAX = (2, 3, 4, 32771)
_PREDICTED = (5, 8, 32946, 34925, 50000)
# the ones PIL never decodes: its libtiff is built without WebP, and
# SGILog needs a LogLuv photometric, which OPEN_INFO does not hold (its
# libtiff refuses SGILog data under any photometric OPEN_INFO holds)
_PIL_REFUSES = {34676: "SGILog (34676)", 34677: "SGILog24 (34677)",
                50001: "WebP (50001), which PIL's libtiff is built without"}

# tags
(WIDTH, LENGTH, BITS, COMPRESSION, PHOTOMETRIC, FILLORDER, STRIPOFFSETS,
 ORIENTATION, SAMPLES, ROWSPERSTRIP, STRIPBYTECOUNTS, PLANAR, T4OPTIONS,
 PREDICTOR, COLORMAP, TILEWIDTH, TILELENGTH, TILEOFFSETS, TILEBYTECOUNTS,
 EXTRASAMPLES, SAMPLEFORMAT, JPEGTABLES, YCBCRSUBSAMPLING) = (
    256, 257, 258, 259, 262, 266, 273, 274, 277, 278, 279, 284, 292, 317,
    320, 322, 323, 324, 325, 338, 339, 347, 530)
# tags PIL reads as one value (TiffTags' length 1): the first of several
_SCALAR = {WIDTH, LENGTH, COMPRESSION, PHOTOMETRIC, FILLORDER, ORIENTATION,
           SAMPLES, ROWSPERSTRIP, PLANAR, T4OPTIONS, 293, PREDICTOR,
           TILEWIDTH, TILELENGTH, JPEGTABLES, 531}
# tag type -> (bytes per value, struct code); 1 BYTE, 2 ASCII, 7 UNDEFINED
# load as bytes, 5 and 10 as rationals
_TYPES = {1: (1, None), 2: (1, None), 3: (2, "H"), 4: (4, "L"), 5: (8, "L"),
          6: (1, "b"), 7: (1, None), 8: (2, "h"), 9: (4, "l"),
          10: (8, "l"), 11: (4, "f"), 12: (8, "d"), 13: (4, "L"),
          16: (8, "Q")}


def _register(lib):
    p, ll, i = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    cp = ctypes.c_char_p
    lib.f101tiff_packbits.argtypes = [cp, ll, p, ll]
    lib.f101tiff_packbits.restype = i
    lib.f101tiff_lzw.argtypes = [cp, ll, p, ll, i]
    lib.f101tiff_lzw.restype = i
    lib.f101tiff_fax.argtypes = [cp, ll, i, i, i, i, i, i, p,
                                 ctypes.POINTER(i), p]
    lib.f101tiff_fax.restype = i
    lib.f101tiff_thunder.argtypes = [cp, ll, p, i, i]
    lib.f101tiff_thunder.restype = i
    lib.f101tiff_fax_runs.argtypes = [i, i]
    lib.f101tiff_fax_runs.restype = ll
    lib.f101qoi_decode.argtypes = [cp, ll, i, i, i, p]
    lib.f101qoi_decode.restype = ll


def tiff_lib() -> ctypes.CDLL:
    lib = _load("fast_tiff", (), _register)
    if lib is None:
        raise UnsupportedImage("the TIFF/QOI unit (native/fast_tiff.cpp, no "
                               "library needed) did not build here: "
                               f"{build_error('fast_tiff')}")
    return lib


def _register_zstd(lib):
    lib.f101zstd_tiff.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                  ctypes.c_void_p, ctypes.c_long,
                                  ctypes.POINTER(ctypes.c_long)]
    lib.f101zstd_tiff.restype = ctypes.c_int
    lib.f101zstd_error.restype = ctypes.c_char_p


def zstd_lib() -> ctypes.CDLL:
    lib = _load("fast_zstd", (), _register_zstd)
    if lib is None:
        raise UnsupportedImage("the ZSTD unit (native/fast_zstd.cpp, no "
                               "library needed) did not build here: "
                               f"{build_error('fast_zstd')}")
    return lib


# ---------------------------------------------------------------------------
# the header and the first directory, as PIL loads them
# ---------------------------------------------------------------------------

class _Dir:
    """The tags of the first image file directory: tag -> a tuple of
    numbers (bytes for BYTE, ASCII and UNDEFINED), the value alone for the
    tags PIL reads as one, and ``offset`` where the directory starts."""

    def __init__(self, data: bytes):
        if len(data) < 8:
            raise ValueError("TIFF: truncated header")
        self.prefix = data[:2]
        self.e = "<" if self.prefix == II else ">"
        self.big = data[2] == 43
        if self.big:
            if len(data) < 16:
                raise ValueError("TIFF: truncated header")
            first = struct.unpack_from(self.e + "Q", data, 8)[0]
        else:
            first = struct.unpack_from(self.e + "L", data, 4)[0]
        if first == 0:
            raise ValueError("TIFF: no image in the file")
        if first >= 2 ** 63:
            raise ValueError("TIFF: unable to seek to the first image")
        self.offset = first
        self.tags: dict = {}
        self._load(data, first)

    def _load(self, data: bytes, pos: int):
        """ImageFileDirectory_v2.load: a directory cut short keeps the tags
        read before the cut (PIL warns and goes on)."""
        e, big = self.e, self.big
        n_fmt, ent_fmt, ent = ("Q", "HHQ8s", 20) if big else ("H", "HHL4s", 12)
        inline = 8 if big else 4
        if pos + struct.calcsize(n_fmt) > len(data):
            return
        count = struct.unpack_from(e + n_fmt, data, pos)[0]
        pos += struct.calcsize(n_fmt)
        for _ in range(count):
            if pos + ent > len(data):
                return
            tag, typ, n, raw = struct.unpack_from(e + ent_fmt, data, pos)
            pos += ent
            if typ not in _TYPES:
                continue
            size = n * _TYPES[typ][0]
            if size > inline:
                off = struct.unpack_from(e + ("Q" if big else "L"), raw)[0]
                if off + size > len(data):
                    return  # "Truncated File Read": the directory ends here
                raw = data[off:off + size]
            else:
                raw = raw[:size]
            if raw:
                self.tags[tag] = self._value(tag, typ, raw)

    def _value(self, tag: int, typ: int, raw: bytes):
        unit, code = _TYPES[typ]
        if code is None:
            return raw  # bytes: PIL's value for BYTE is the bytes too
        n = len(raw) // unit * (2 if typ in (5, 10) else 1)
        vals = struct.unpack(f"{self.e}{n}{code}", raw)
        if typ in (5, 10):
            vals = tuple(Fraction(a, b) if b else float("nan")
                         for a, b in zip(vals[::2], vals[1::2]))
        if tag in _SCALAR or len(vals) == 1 and tag not in (
                BITS, STRIPOFFSETS, STRIPBYTECOUNTS, COLORMAP, TILEOFFSETS,
                TILEBYTECOUNTS, EXTRASAMPLES, SAMPLEFORMAT, YCBCRSUBSAMPLING):
            return vals[0]
        return vals

    def get(self, tag, default=None):
        return self.tags.get(tag, default)

    def ints(self, tag, default=()) -> tuple:
        v = self.tags.get(tag, default)
        if isinstance(v, (int, Fraction, float)):
            v = (v,)
        if isinstance(v, bytes) or not all(isinstance(x, int) for x in v):
            raise ValueError(f"TIFF: tag {tag} does not hold integers")
        return tuple(v)


class _Image:
    """What TiffImageFile._setup decides: sizes, PIL's mode and raw mode,
    the layout of the strips or tiles."""

    def __init__(self, data: bytes):
        d = self.d = _Dir(data)
        if 0xBC01 in d.tags:
            raise ValueError("TIFF: Windows Media Photo is not supported")
        comp = d.get(COMPRESSION, 1)
        if comp not in COMPRESSIONS:
            raise ValueError(f"TIFF: unknown compression {comp!r}")
        self.compression = comp
        self.planar = d.get(PLANAR, 1)
        photo = d.get(PHOTOMETRIC, 0)
        if comp == 6:
            photo = 6
        self.photometric = photo
        self.fillorder = d.get(FILLORDER, 1)
        if WIDTH not in d.tags or LENGTH not in d.tags:
            raise ValueError("TIFF: missing dimensions")
        xs, ys = d.get(WIDTH), d.get(LENGTH)
        if not isinstance(xs, int) or not isinstance(ys, int):
            raise ValueError("TIFF: invalid dimensions")
        self.xsize, self.ysize = xs, ys
        self.orientation = d.get(ORIENTATION)
        fmt = d.get(SAMPLEFORMAT, (1,))
        if isinstance(fmt, (int, Fraction, float)):
            fmt = (fmt,)
        if isinstance(fmt, tuple) and len(fmt) > 1 and \
                max(fmt) == min(fmt) == 1:
            fmt = (1,)
        bps = d.get(BITS, (1,))
        extra = d.get(EXTRASAMPLES, ())
        bps_count = (3 if photo in (2, 6, 8) else 4 if photo == 5 else 1) \
            + len(extra)
        spp = d.get(SAMPLES, 3 if comp == 6 and photo in (2, 6) else 1)
        if not isinstance(spp, (int, Fraction, float)):
            raise ValueError("TIFF: invalid samples per pixel")
        if spp > MAX_SAMPLES:
            raise ValueError("TIFF: invalid value for samples per pixel")
        if isinstance(bps, bytes):
            bps = (bps,)
        if spp < len(bps):
            bps = bps[:int(spp)]
        elif spp > len(bps) and len(bps) == 1:
            bps = bps * int(spp)
        if len(bps) != spp:
            raise ValueError("TIFF: unknown data organization")
        self.bps, self.extra, self.bps_count = bps, extra, bps_count
        self.samples = int(spp)
        key = self.key = (d.prefix, photo, fmt, self.fillorder, bps, extra)
        try:
            self.mode, self.rawmode = OPEN_INFO[key]
        except (KeyError, TypeError):
            raise ValueError(f"TIFF: unknown pixel mode {key[1:]}") from None
        size = (ys, xs) if self.orientation in (5, 6, 7, 8) else (xs, ys)
        if size[0] <= 0 or size[1] <= 0:
            raise ValueError("TIFF: empty image")
        if xs * ys > MAX_PIXELS:
            raise ValueError(f"TIFF: {xs}x{ys} exceeds {MAX_PIXELS} pixels")
        self.palette = None
        if self.mode in ("P", "PA"):
            if COLORMAP not in d.tags:
                raise ValueError("TIFF: palette image without a ColorMap")
            cmap = d.ints(COLORMAP)
            # ImagePalette.raw("RGB;L", o8(v // 256) ...): all reds, then
            # all greens, then all blues
            b = bytes((v // 256) & 255 for v in cmap)
            n = len(b) // 3
            pal = np.zeros((256, 3), np.uint8)
            if n:
                k = min(n, 256)
                for c in range(3):
                    pal[:k, c] = np.frombuffer(b[c * n:c * n + k], np.uint8)
            self.palette = pal


# ---------------------------------------------------------------------------
# PIL's unpackers (Unpack.c) and convert("RGB")
# ---------------------------------------------------------------------------

_REV = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)
# PIL's storage of a mode: one band (uint8, int64 or float64) or 4 bytes
_BANDS4 = ("LA", "PA", "RGB", "RGBA", "CMYK", "LAB")


def _bits(rows: np.ndarray, depth: int, n: int, rev: bool) -> np.ndarray:
    if rev:
        rows = _REV[rows]
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
    return vals.reshape(rows.shape[0], -1)[:, :n]


def _words(rows, n, k, dt):
    return rows[:, :n * k * np.dtype(dt).itemsize].view(dt).astype(np.int64)


def _unpremultiply(rgb: np.ndarray, a: np.ndarray) -> np.ndarray:
    """Unpack.c unpackRGBa: c * 255 / a, clipped; 0 where a is 0."""
    a = a.astype(np.int64)[..., None]
    out = np.where(a == 255, rgb, np.minimum(rgb.astype(np.int64) * 255
                                             // np.maximum(a, 1), 255))
    return np.where(a == 0, 0, out).astype(np.uint8)


def _pixels4(n_rows, n, bands: dict) -> np.ndarray:
    out = np.zeros((n_rows, n, 4), np.uint8)
    for i, v in bands.items():
        out[..., i] = v
    return out


def _rgbx(rows, n, size, hi=None, alpha=None, premul=False):
    """Interleaved samples of ``size`` bytes each (1, or 2 with ``hi`` the
    byte PIL keeps) -> R, G, B (and A) of PIL's RGB/RGBA storage."""
    k = rows[:, :n * size].reshape(rows.shape[0], n, size)
    if hi is not None:  # 16-bit samples: the high byte
        k = k[..., hi::2]
    rgb = k[..., :3]
    if alpha is None:
        return _pixels4(rows.shape[0], n, {i: rgb[..., i] for i in range(3)})
    a = k[..., alpha]
    if premul:
        rgb = _unpremultiply(rgb, a)
    return _pixels4(rows.shape[0], n, {0: rgb[..., 0], 1: rgb[..., 1],
                                       2: rgb[..., 2], 3: a})


def _make_unpackers() -> dict:
    """raw mode -> (bits per pixel, fn(rows uint8 (r, bytes), n) -> PIL's
    storage of those rows)."""
    u = {}
    for inv in ("", "I"):
        for rev in ("", "R"):
            for depth in (1, 2, 4):
                name = ("1" if depth == 1 else f"L;{depth}") + (
                    (";" if depth == 1 and (inv or rev) else "") + inv + rev)
                scale = 255 // ((1 << depth) - 1)

                def f(rows, n, depth=depth, inv=inv, rev=rev, scale=scale):
                    v = _bits(rows, depth, n, bool(rev)) * np.uint8(scale)
                    return 255 - v if inv else v
                u[name] = (depth, f)
    u["L"] = (8, lambda r, n: r[:, :n].copy())
    u["L;I"] = (8, lambda r, n: 255 - r[:, :n])
    u["L;R"] = (8, lambda r, n: _REV[r[:, :n]])
    u["L;IR"] = (8, lambda r, n: 255 - _REV[r[:, :n]])
    for depth in (1, 2, 4):
        u[f"P;{depth}"] = (depth, lambda r, n, d=depth: _bits(r, d, n, False))
        u[f"P;{depth}R"] = (depth, lambda r, n, d=depth: _bits(r, d, n, True))
    u["P"] = (8, lambda r, n: r[:, :n].copy())
    u["P;R"] = (8, lambda r, n: _REV[r[:, :n]])
    u["PX"] = (16, lambda r, n: r[:, :2 * n:2].copy())
    u["PA"] = (16, lambda r, n: _pixels4(r.shape[0], n, {0: r[:, :2 * n:2],
                                                         3: r[:, 1:2 * n:2]}))
    u["LA"] = (16, lambda r, n: _pixels4(r.shape[0], n, {
        0: r[:, :2 * n:2], 1: r[:, :2 * n:2], 2: r[:, :2 * n:2],
        3: r[:, 1:2 * n:2]}))

    def i12(r, n):
        t = r[:, :(3 * n + 1) // 2].astype(np.int64)
        pad = np.zeros((r.shape[0], 3 * ((n + 1) // 2)), np.int64)
        pad[:, :t.shape[1]] = t
        g = pad.reshape(r.shape[0], -1, 3)
        a = (g[..., 0] << 4) | (g[..., 1] >> 4)
        b = ((g[..., 1] & 15) << 8) | g[..., 2]
        return np.stack([a, b], 2).reshape(r.shape[0], -1)[:, :n]
    u["I;12"] = (12, i12)
    u["I;16"] = u["I;16N"] = (16, lambda r, n: _words(r, n, 1, "<u2"))
    u["I;16B"] = (16, lambda r, n: _words(r, n, 1, ">u2"))
    u["I;16R"] = (16, lambda r, n: _words(_REV[r], n, 1, "<u2"))
    u["I;16S"] = (16, lambda r, n: _words(r, n, 1, "<i2"))
    u["I;16BS"] = (16, lambda r, n: _words(r, n, 1, ">i2"))
    u["I;32N"] = u["I;32S"] = (32, lambda r, n: _words(r, n, 1, "<i4"))
    u["I;32BS"] = (32, lambda r, n: _words(r, n, 1, ">i4"))
    u["F;32F"] = (32, lambda r, n: r[:, :4 * n].view("<f4").astype(np.float64))
    u["F;32BF"] = (32, lambda r, n: r[:, :4 * n].view(">f4").astype(
        np.float64))
    u["RGB"] = (24, lambda r, n: _rgbx(r, n, 3))
    # unpackLAB: a and b are signed in the file, offset by 128 in PIL
    u["LAB"] = (24, _lab)
    u["RGB;R"] = (24, lambda r, n: _rgbx(_REV[r], n, 3))
    for x in range(4):
        tail = "X" * x
        u["RGB" + tail] = (8 * (3 + x), lambda r, n, x=x: _rgbx(r, n, 3 + x))
        if x < 3:
            u["RGBA" + tail] = (8 * (4 + x), lambda r, n, x=x: _rgbx(
                r, n, 4 + x, alpha=3))
            u["RGBa" + tail] = (8 * (4 + x), lambda r, n, x=x: _rgbx(
                r, n, 4 + x, alpha=3, premul=True))
    for end, hi in (("L", 1), ("N", 1), ("B", 0)):
        u[f"RGB;16{end}"] = (48, lambda r, n, hi=hi: _rgbx(r, n, 6, hi))
        u[f"RGBX;16{end}"] = (64, lambda r, n, hi=hi: _rgbx(r, n, 8, hi))
        u[f"RGBA;16{end}"] = (64, lambda r, n, hi=hi: _rgbx(r, n, 8, hi, 3))
        u[f"RGBa;16{end}"] = (64, lambda r, n, hi=hi: _rgbx(r, n, 8, hi, 3,
                                                           True))
        u[f"CMYK;16{end}"] = (64, lambda r, n, hi=hi: _cmyk(r, n, 8, hi))
    for x in range(3):
        u["CMYK" + "X" * x] = (8 * (4 + x), lambda r, n, x=x: _cmyk(
            r, n, 4 + x))
    return u


def _lab(rows, n):
    out = _rgbx(rows, n, 3)
    out[..., 1:3] ^= 128
    return out


def _cmyk(rows, n, size, hi=None):
    k = rows[:, :n * size].reshape(rows.shape[0], n, size)
    if hi is not None:
        k = k[..., hi::2]
    return _pixels4(rows.shape[0], n, {i: k[..., i] for i in range(4)})


UNPACKERS = _make_unpackers()

# one band of a layer (PlanarConfiguration 2 in PIL's raw path): mode ->
# {raw mode: band}; a raw mode not listed is PIL's "unknown raw mode"
_BAND_UNPACKERS = {"RGB": {"R": 0, "G": 1, "B": 2},
                   "RGBA": {"R": 0, "G": 1, "B": 2, "A": 3},
                   "CMYK": {"C": 0, "M": 1, "Y": 2, "K": 3}}


def unpacker(mode: str, rawmode: str):
    """(bits per pixel, fn) of PIL's unpacker for (mode, raw mode), or
    ValueError where PIL has none."""
    if mode in _BAND_UNPACKERS and rawmode in _BAND_UNPACKERS[mode]:
        band = _BAND_UNPACKERS[mode][rawmode]
        return 8, lambda r, n: {band: r[:, :n].copy()}
    # (OPEN_INFO names L;IR, P;1R, P;2R and P;4R, which PIL has no
    # unpacker for: its raw decoder refuses them)
    single = {"1": ("1", "1;I", "1;R", "1;IR"),
              "L": ("L", "L;I", "L;R", "L;2", "L;2I", "L;2R", "L;2IR", "L;4",
                    "L;4I", "L;4R", "L;4IR"),
              "P": ("P", "P;1", "P;2", "P;4", "P;R", "PX"),
              "I;16": ("I;16", "I;16N", "I;16R", "I;12"),
              "I;16B": ("I;16B",), "I": ("I", "I;16S", "I;16BS", "I;32N",
                                        "I;32S", "I;32BS"),
              "F": ("F", "F;32F", "F;32BF"),
              "LA": ("LA",), "PA": ("PA",),
              "RGB": ("RGB", "RGB;R", "RGBX", "RGBXX", "RGBXXX", "RGB;16L",
                      "RGB;16B", "RGB;16N", "RGBX;16L", "RGBX;16B",
                      "RGBX;16N"),
              "RGBA": ("RGBA", "RGBAX", "RGBAXX", "RGBa", "RGBaX", "RGBaXX",
                       "RGBA;16L", "RGBA;16B", "RGBA;16N", "RGBa;16L",
                       "RGBa;16B", "RGBa;16N"),
              "CMYK": ("CMYK", "CMYKX", "CMYKXX", "CMYK;16L", "CMYK;16B",
                       "CMYK;16N"),
              "LAB": ("LAB",)}
    if rawmode not in single.get(mode, ()):
        raise ValueError(f"TIFF: unknown raw mode {rawmode!r} for {mode}")
    if rawmode == "F":  # native float32 and int32
        return 32, UNPACKERS["F;32F"][1]
    if rawmode == "I":
        return 32, UNPACKERS["I;32N"][1]
    return UNPACKERS[rawmode]


def _new(mode: str, h: int, w: int) -> np.ndarray:
    if mode in _BANDS4:
        return np.zeros((h, w, 4), np.uint8)
    if mode in ("I", "I;16", "I;16B"):
        return np.zeros((h, w), np.int64)
    if mode == "F":
        return np.zeros((h, w), np.float64)
    return np.zeros((h, w), np.uint8)


def _put(img: np.ndarray, y0: int, x0: int, vals) -> None:
    """Write unpacked rows at (y0, x0): a band dict writes only its bands."""
    if isinstance(vals, dict):
        for band, v in vals.items():
            img[y0:y0 + v.shape[0], x0:x0 + v.shape[1], band] = v
    else:
        img[y0:y0 + vals.shape[0], x0:x0 + vals.shape[1]] = vals


def to_rgb(mode: str, img: np.ndarray, palette=None) -> np.ndarray:
    """PIL's ``convert("RGB")`` of an image in PIL's storage of ``mode``."""
    if mode in ("1", "L"):
        g = img
    elif mode in ("P", "PA"):
        pal = palette if palette is not None else np.zeros((256, 3), np.uint8)
        return pal[(img if mode == "P" else img[..., 0]).astype(np.uint8)]
    elif mode in ("I", "I;16", "I;16B"):
        g = np.clip(img, 0, 255).astype(np.uint8)
    elif mode == "F":
        with np.errstate(invalid="ignore"):
            v = np.where(np.isnan(img), 0.0, np.clip(img, 0, 255))
        g = np.trunc(v).astype(np.uint8)
    elif mode == "LA":
        g = img[..., 0]
    elif mode in ("RGB", "RGBA"):
        return np.ascontiguousarray(img[..., :3])
    elif mode == "LAB":  # LittleCMS's Lab -> sRGB, as PIL converts it
        return lab_to_rgb(img)
    elif mode == "CMYK":  # Convert.c cmyk2rgb
        nk = 255 - img[..., 3:4].astype(np.int32)
        tmp = img[..., :3].astype(np.int32) * nk + 128
        return np.clip(nk - (((tmp >> 8) + tmp) >> 8), 0, 255).astype(np.uint8)
    else:
        raise ValueError(f"no conversion of {mode} to RGB")
    return np.repeat(g[..., None].astype(np.uint8), 3, axis=2)


# ---------------------------------------------------------------------------
# uncompressed: PIL's raw decoder over its tile list
# ---------------------------------------------------------------------------

def _raw_tiles(im: _Image) -> list:
    """TiffImageFile._setup's tiles: (offset, extents, rawmode, stride)."""
    d = im.d
    xsize, ysize = im.xsize, im.ysize
    if STRIPOFFSETS in d.tags:
        offsets = d.ints(STRIPOFFSETS)
        h, w = d.get(ROWSPERSTRIP, ysize), xsize
    elif TILEOFFSETS in d.tags:
        offsets = d.ints(TILEOFFSETS)
        w, h = d.get(TILEWIDTH), d.get(TILELENGTH)
    else:
        raise ValueError("TIFF: unknown data organization")
    if not isinstance(w, int) or not isinstance(h, int):
        raise ValueError("TIFF: invalid tile dimensions")
    if w == xsize and h == ysize and im.planar != 2:
        offsets = offsets[-1:]
    tiles = []
    x = y = layer = 0
    for off in offsets:
        stride = w * sum(im.bps) / 8 if x + w > xsize else 0
        raw = im.rawmode
        if im.planar == 2:
            if layer >= len(raw):
                raise ValueError("TIFF: more layers than bands")
            raw = raw[layer]
            stride /= im.bps_count
        tiles.append((off, (x, y, min(x + w, xsize), min(y + h, ysize)), raw,
                      int(stride)))
        x += w
        if x >= xsize:
            x, y = 0, y + h
            if y >= ysize:
                y = 0
                layer += 1
    return tiles


def _decode_raw(im: _Image, data: bytes) -> np.ndarray:
    """ImageFile.load with RawDecode over the tiles: each tile's rows are
    the bytes from its offset on (the file ending first is an error); a
    raw mode PIL has no unpacker for, or a tile outside the image, too.
    Only the last tile's decoder status counts, as in ImageFile.load."""
    tiles = sorted(_raw_tiles(im), key=lambda t: t[0])
    dedup = []
    for t in tiles:  # consecutive equal (extents, args): the last one
        if dedup and dedup[-1][1:] == t[1:]:
            dedup[-1] = t
        else:
            dedup.append(t)
    img = _new(im.mode, im.ysize, im.xsize)
    err = 0
    for off, (x0, y0, x1, y1), raw, stride in dedup:
        bits, fn = unpacker(im.mode, raw)
        xs, ys = x1 - x0, y1 - y0
        if xs <= 0 or ys <= 0 or x1 > im.xsize or y1 > im.ysize:
            raise ValueError("TIFF: tile cannot extend outside image")
        if off < 0:
            raise ValueError("TIFF: negative tile offset")
        nbytes = (xs * bits + 7) // 8
        skip = stride - nbytes if stride else 0
        if skip < 0:
            err = -8  # IMAGING_CODEC_CONFIG
            continue
        need = ys * nbytes + (ys - 1) * skip
        if off + need > len(data):
            raise ValueError("TIFF: image file is truncated")
        block = np.frombuffer(data, np.uint8, need, off) if need else \
            np.zeros(0, np.uint8)
        if skip:
            block = np.concatenate([block, np.zeros(skip, np.uint8)])
            rows = block.reshape(ys, nbytes + skip)[:, :nbytes]
        else:
            rows = block.reshape(ys, nbytes)
        _put(img, y0, x0, fn(np.ascontiguousarray(rows), xs))
        err = 0
    if err:
        raise ValueError("TIFF: raw decoder configuration error")
    return img


# ---------------------------------------------------------------------------
# compressed: libtiff's strips and tiles, then PIL's TiffDecode
# ---------------------------------------------------------------------------

def _inflate(raw: bytes, occ: int, what: str, partial: bool = False) -> bytes:
    """tif_zip.c ZIPDecode: zlib until the strip is full; ``partial``
    returns what inflate wrote before an error or the data's end (fed in
    small pieces, as the output of the call that fails is lost)."""
    try:
        out = zlib.decompressobj().decompress(raw, occ)
    except zlib.error as e:
        if not partial:
            raise ValueError(f"TIFF: {what} decoding error ({e})") from None
        d, out = zlib.decompressobj(), b""
        try:
            for i in range(0, len(raw), 16):
                out += d.decompress(raw[i:i + 16], occ - len(out))
        except zlib.error:
            pass
    if len(out) < occ and not partial:
        raise ValueError(f"TIFF: not enough {what} data")
    return out


# xz filter IDs liblzma decodes before LZMA2 (lzma_filter_flags_decode):
# delta, and the branch converters Python's lzma module names
_XZ_BCJ = {4: lzma.FILTER_X86, 5: lzma.FILTER_POWERPC, 6: lzma.FILTER_IA64,
           7: lzma.FILTER_ARM, 8: lzma.FILTER_ARMTHUMB, 9: lzma.FILTER_SPARC}


def _xz_block(raw: bytes) -> tuple:
    """The LZMA2 data of an xz stream's first block, its filter chain
    (libtiff's encoder writes delta, then LZMA2), LZMA2's dictionary size
    and the delta distance (0 for none), with the header checks liblzma
    makes before it decodes (stream header, block header and their
    CRC32s, lzma_block_header_decode's flags, filter flags and padding)."""
    if len(raw) < 13 or raw[:6] != b"\xfd7zXZ\x00" or \
            zlib.crc32(raw[6:8]) != struct.unpack_from("<I", raw, 8)[0] \
            or raw[6] or raw[7] & 0xF0 or raw[12] == 0:
        raise ValueError("TIFF: bad xz header")
    size = (raw[12] + 1) * 4
    hdr = raw[12:12 + size]
    if len(hdr) < size or zlib.crc32(hdr[:-4]) != struct.unpack_from(
            "<I", hdr, size - 4)[0]:
        raise ValueError("TIFF: bad xz block header")
    pos, flags = 2, hdr[1]

    def varint():
        nonlocal pos
        v = shift = 0
        while pos < size - 4:
            b = hdr[pos]
            pos += 1
            v |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return v
        raise ValueError("TIFF: bad xz block header")
    if flags & 0x3C:
        raise ValueError("TIFF: xz block header with reserved flags")
    for bit in (0x40, 0x80):  # compressed and uncompressed sizes
        if flags & bit:
            varint()
    chain, dict_size, delta = [], 0, 0
    for k in range((flags & 3) + 1):
        fid, n = varint(), varint()
        if n > size - 4 - pos:
            raise ValueError("TIFF: bad xz filter flags")
        props = hdr[pos:pos + n]
        pos += n
        last = k == flags & 3
        if fid == 0x21 and last and n == 1 and props[0] <= 40:
            d = props[0]
            dict_size = 0xFFFFFFFF if d == 40 else \
                (2 | (d & 1)) << (d // 2 + 11)
            chain.append({"id": lzma.FILTER_LZMA2, "dict_size": dict_size})
        elif fid == 3 and not last and n == 1:
            delta = props[0] + 1
            chain.append({"id": lzma.FILTER_DELTA, "dist": delta})
        elif fid in _XZ_BCJ and not last and n in (0, 4):
            chain.append({"id": _XZ_BCJ[fid], "start_offset":
                          int.from_bytes(props, "little")})
        else:
            raise ValueError(f"TIFF: xz filter {fid:#x} liblzma refuses here")
    if any(hdr[pos:size - 4]):
        raise ValueError("TIFF: xz block header padding")
    return raw[12 + size:], chain, dict_size, delta


def _lzma2_through(payload: bytes, occ: int) -> bytes:
    """The LZMA2 chunks up to the one whose end reaches output byte
    ``occ``: liblzma stops reading there once the strip is full, so what
    follows (the end marker, the block's check) cannot fail it."""
    pos = done = 0
    while pos < len(payload) and done < occ and payload[pos]:
        c = payload[pos]
        if c < 0x80:  # an uncompressed chunk
            size = int.from_bytes(payload[pos + 1:pos + 3], "big") + 1
            pos, done = pos + 3 + size, done + size
        else:
            done += ((c & 0x1F) << 16 |
                     int.from_bytes(payload[pos + 1:pos + 3], "big")) + 1
            packed = int.from_bytes(payload[pos + 3:pos + 5], "big") + 1
            pos += 5 + (c >= 0xC0) + packed
    return payload[:pos]


def _lzma2_first_chunk(payload: bytes, dict_size: int, delta: int,
                       occ: int):
    """The first ``occ`` bytes of LZMA2 data whose first chunk holds them,
    decoded as the raw LZMA1 data of that chunk: liblzma checks a chunk's
    range coder as its last byte is written, and an error there, with the
    strip already full, does not fail libtiff's decode, while Python's
    decoder raises it and loses the call's output. None where the strip
    spans chunks or the first is not LZMA-coded with its properties.
    ``delta`` (a distance, 0 for none) undoes the delta filter after it."""
    if len(payload) < 6 or payload[0] < 0xE0:
        return None
    unpacked = ((payload[0] & 0x1F) << 16 |
                struct.unpack_from(">H", payload, 1)[0]) + 1
    packed = struct.unpack_from(">H", payload, 3)[0] + 1
    props = payload[5]
    if unpacked < occ or props >= 9 * 5 * 5:
        return None
    lc, lp, pb = props % 9, props // 9 % 5, props // 45
    try:  # a range coder at the chunk's end reads zeros, as liblzma's
        out = lzma.LZMADecompressor(lzma.FORMAT_RAW, filters=[{
            "id": lzma.FILTER_LZMA1, "lc": lc, "lp": lp, "pb": pb,
            "dict_size": dict_size}]).decompress(
                payload[6:6 + packed] + bytes(8), occ)
    except lzma.LZMAError:
        return None
    if delta:  # delta.c: each byte plus the one `delta` before it
        a = bytearray(out)
        for i in range(delta, len(a)):
            a[i] = (a[i] + a[i - delta]) & 0xFF
        out = bytes(a)
    return out


def _unlzma(raw: bytes, occ: int) -> bytes:
    """tif_lzma.c LZMADecode: liblzma until the strip is full. An error
    liblzma reports once the strip is full (its last chunk's end, the
    block's check and sizes) does not fail it, so where Python's decoder
    raises, the strip is decoded again without those checks
    (_lzma2_first_chunk)."""
    try:
        out = lzma.LZMADecompressor(lzma.FORMAT_XZ).decompress(raw, occ)
    except lzma.LZMAError as e:
        payload, chain, dict_size, delta = _xz_block(raw)
        out = None
        # without the block's check and sizes: the chunks up to the strip's
        # end, or all of them where a branch filter holds bytes back until
        # it sees the ones after them
        for data in ((_lzma2_through(payload, occ),) if len(chain) - (
                delta > 0) == 1 else (payload, _lzma2_through(payload, occ))):
            try:
                out = lzma.LZMADecompressor(lzma.FORMAT_RAW, filters=chain) \
                    .decompress(data, occ)
            except lzma.LZMAError:
                continue
            if len(out) >= occ:
                break
        if (out is None or len(out) < occ) and len(chain) - (delta > 0) == 1:
            # a chunk's end: that of the first
            first = _lzma2_first_chunk(payload, dict_size, delta, occ)
            out = first if first is not None else out
        if out is None:
            raise ValueError(f"TIFF: LZMA decoding error ({e})") from None
    if len(out) < occ:
        raise ValueError("TIFF: LZMA data ends or breaks before the strip "
                         "is full")
    return out[:occ]


# libtiff's field types: code -> (bytes, struct code); the integer ones
_LT_TYPES = {1: (1, "B"), 2: (1, "B"), 3: (2, "H"), 4: (4, "L"),
             5: (8, None), 6: (1, "b"), 7: (1, "B"), 8: (2, "h"),
             9: (4, "l"), 10: (8, None), 11: (4, "f"), 12: (8, "d"),
             13: (4, "L"), 16: (8, "Q"), 17: (8, "q"), 18: (8, "Q")}
_LT_INTS = (1, 3, 4, 6, 8, 9, 13, 16, 17, 18)


class _LtDir:
    """The first directory as libtiff's TIFFReadDirectory reads it, which
    is not how PIL reads it: every entry is read (a value past the end of
    the file fails only its own tag), the first of duplicate tags counts,
    a value of the wrong type or count is an error where the tag is
    essential (then the file does not open) and ignored elsewhere (the
    default stands), and arrays longer than needed are cut."""

    def __init__(self, data: bytes, d: _Dir):
        e, big = d.e, d.big
        pos = d.offset
        n_fmt, n_size, ent, inline = ("Q", 8, 20, 8) if big else \
            ("H", 2, 12, 4)
        if pos + n_size > len(data):
            raise ValueError("TIFF: libtiff cannot read the directory")
        count = struct.unpack_from(e + n_fmt, data, pos)[0]
        if pos + n_size + count * ent > len(data):
            raise ValueError("TIFF: libtiff cannot read the directory")
        self.e, self.data = e, data
        self.entries: dict = {}
        for i in range(count):
            at = pos + n_size + i * ent
            tag, typ = struct.unpack_from(e + "HH", data, at)
            n = struct.unpack_from(e + ("Q" if big else "L"), data, at + 4)[0]
            field = data[at + (12 if big else 8):at + ent]
            # later duplicates are ignored (TIFFReadDirectory)
            self.entries.setdefault(tag, (typ, n, field, inline))

    def raw(self, tag, limit=None):
        """(type, count read, value bytes or None where they lie past the
        end of the file) of the first ``limit`` values, None for an absent
        tag."""
        if tag not in self.entries:
            return None
        typ, n, field, inline = self.entries[tag]
        if typ not in _LT_TYPES:
            return typ, n, None
        unit = _LT_TYPES[typ][0]
        k = n if limit is None else min(n, limit)
        if n * unit <= inline:
            return typ, k, field[:k * unit]
        off = struct.unpack_from(self.e + ("Q" if inline == 8 else "L"),
                                 field)[0]
        if off + k * unit > len(self.data):
            return typ, k, None
        return typ, k, self.data[off:off + k * unit]

    def ints(self, tag, limit=None):
        """The values of an integer-typed tag (up to ``limit``); None for
        an absent tag; ValueError for another type or unreadable data."""
        r = self.raw(tag, limit)
        if r is None:
            return None
        typ, k, raw = r
        if typ not in _LT_INTS or raw is None:
            raise ValueError(f"TIFF: libtiff cannot read tag {tag}")
        return struct.unpack_from(f"{self.e}{k}{_LT_TYPES[typ][1]}", raw)

    def one(self, tag, default, top=0xFFFFFFFF, essential=True):
        """TIFFReadDirEntryShort/Long: one value in range. A bad value is
        fatal for an essential tag, else the default stands."""
        try:
            v = self.ints(tag)
            if v is None:
                return default
            if len(v) != 1 or not 0 <= v[0] <= top:
                raise ValueError(f"TIFF: libtiff refuses tag {tag}")
            return v[0]
        except ValueError:
            if essential:
                raise
            return default

    def per_sample(self, tag, default, spp):
        """TIFFReadDirEntryPersampleShort: one value, or at least spp equal
        ones."""
        v = self.ints(tag)
        if v is None:
            return default
        if len(v) == 1:
            return v[0]
        if len(v) < spp or len(set(v[:spp])) != 1 or not 0 <= v[0] < 65536:
            raise ValueError(f"TIFF: libtiff refuses tag {tag}")
        return v[0]


def _jpeg_tables(stream: bytes, tables: dict, strip: bool = False) -> None:
    """Add the quantization and Huffman tables a JPEG stream defines to
    ``tables`` ((marker, table id) -> a segment defining that one table):
    libjpeg keeps each table until another stream redefines it. The stream
    is read as libjpeg's jdmarker.c reads it (its source ends in fake EOI
    markers). JPEGTables (tif_jpeg.c JPEGSetupDecode: jpeg_read_header
    (FALSE)): SOI first, then DQT, DHT, DRI, DAC, APPn, COM, RSTn, TEM and
    DNL until EOI; a frame or scan header, another marker, or a table
    segment whose lengths or table numbers libjpeg refuses is "Bogus
    JPEGTables field", and the file does not decode. A ``strip``, once it
    has decoded: its tables up to its first SOS, other segments passed
    over."""
    n = len(stream)

    def at(i: int) -> int:
        return stream[i] if i < n else (0xFF, 0xD9)[(i - n) & 1]

    def u16(i: int) -> int:
        return at(i) << 8 | at(i + 1)

    def bogus(why: str):
        raise ValueError(f"TIFF: bogus JPEGTables field ({why})")
    if at(0) != 0xFF or at(1) != 0xD8:
        bogus("no SOI")
    pos = 2
    while True:
        while at(pos) != 0xFF:  # next_marker: garbage, fill, FF 00
            pos += 1
        while at(pos) == 0xFF:
            pos += 1
        m = at(pos)
        pos += 1
        if m == 0:
            continue
        if m == 0xD9 or (strip and m == 0xDA):
            return
        if 0xD0 <= m <= 0xD7 or m == 0x01:
            continue
        if not strip and (m == 0xD8 or m == 0xDA or (
                0xC0 <= m <= 0xCF and m not in (0xC4, 0xCC))):
            bogus(f"marker {m:#04x}")
        length = u16(pos) - 2
        body = pos + 2
        if m == 0xC4:  # get_dht
            q = body
            while length > 16:
                index, count = at(q), sum(at(q + 1 + i) for i in range(16))
                length -= 17
                if count > 256 or count > length:
                    bogus("Huffman table")
                if (index & ~0x10) >= 4:
                    bogus("Huffman table number")
                one = bytes(at(q + i) for i in range(17 + count))
                tables[(0xC4, index)] = b"\xff\xc4" + struct.pack(
                    ">H", len(one) + 2) + one
                q += 17 + count
                length -= count
            if length != 0:
                bogus("DHT length")
            pos = q
        elif m == 0xDB:  # get_dqt
            q = body
            while length > 0:
                size = 1 + 64 * (2 if at(q) >> 4 else 1)
                if at(q) & 0x0F >= 4:
                    bogus("quantization table number")
                one = bytes(at(q + i) for i in range(size))
                tables[(0xDB, at(q) & 0x0F)] = b"\xff\xdb" + struct.pack(
                    ">H", len(one) + 2) + one
                q += size
                length -= size
            if length != 0:
                bogus("DQT length")
            pos = q
        elif m == 0xDD:  # get_dri
            if length != 2:
                bogus("DRI length")
            pos = body + 2
        elif m == 0xCC:  # get_dac
            q = body
            while length > 0:
                index, val = at(q), at(q + 1)
                q += 2
                length -= 2
                if index >= 32 or (index < 16 and val & 15 > val >> 4):
                    bogus("arithmetic conditioning")
            if length != 0:
                bogus("DAC length")
            pos = q
        elif strip or 0xE0 <= m <= 0xEF or m in (0xFE, 0xDC):  # by length
            pos = body + max(length, 0)
        else:
            bogus(f"marker {m:#04x}")


class _Unreadable(ValueError):
    """A strip or tile libtiff cannot read from the file."""


class _Libtiff:
    """libtiff's view of the directory and its TIFFRead{EncodedStrip,Tile}."""

    def __init__(self, im: _Image, data: bytes):
        self.im, self.data, d = im, data, im.d
        magic = data[:4]
        if not (magic in (b"II*\x00", b"MM\x00*") or (
                magic in (b"II+\x00", b"MM\x00+")
                and struct.unpack_from(d.e + "HH", data, 4) == (8, 0))):
            raise ValueError("TIFF: libtiff refuses the header")
        lt = self.lt = _LtDir(data, d)
        # libtiff's compression (the first of duplicate tags), which can
        # differ from PIL's (the last)
        comp = self.comp = lt.per_sample(COMPRESSION, 1, 1)
        if comp in _PIL_REFUSES or comp not in COMPRESSIONS:
            raise ValueError(f"TIFF: libtiff reads compression {comp}")
        width = lt.one(WIDTH, None)
        length = lt.one(LENGTH, None)
        if width is None or length is None:
            raise ValueError("TIFF: missing required image dimensions")
        if (width, length) != (im.xsize, im.ysize):
            raise ValueError("TIFF: libtiff reads other dimensions")
        self.spp = lt.one(SAMPLES, 1, 0xFFFF)
        if comp == 6:  # TIFFReadDirectory's fixes for old-style JPEG
            photo = lt.one(PHOTOMETRIC, None, 0xFFFF, essential=False)
            if photo in (None, 2):
                photo = 6
            if SAMPLES not in lt.entries and photo == 6:
                self.spp = 3
        if self.spp == 0:
            raise ValueError("TIFF: zero samples per pixel")
        self.bits = lt.per_sample(BITS, 8 if comp == 6 else 1, self.spp)
        self.fmt = lt.per_sample(SAMPLEFORMAT, 1, self.spp)
        if not 1 <= self.fmt <= 6:  # TIFFSetField refuses it: no directory
            raise ValueError(f"TIFF: sample format {self.fmt}")
        self.planar = lt.one(PLANAR, 1, 0xFFFF)
        if self.planar not in (1, 2):
            raise ValueError("TIFF: bad PlanarConfiguration")
        if comp == 6 and self.planar == 2 and all(
                t in lt.entries and lt.entries[t][1] == 1
                for t in (STRIPOFFSETS, STRIPBYTECOUNTS)):
            self.planar = 1  # one strip's offset and count: contiguous
        ex = lt.ints(EXTRASAMPLES)
        self.extra = tuple(ex) if ex is not None else None
        self.fillorder = lt.one(FILLORDER, 1, 0xFFFF, essential=False)
        self.predictor = lt.one(PREDICTOR, 1, 0xFFFF, essential=False)
        if comp in _PREDICTED and self.predictor not in (1, 2, 3):
            # PredictorSetup fails the codec's setup, so every read
            raise ValueError(f"TIFF: predictor {self.predictor}")
        self.t4 = lt.one(T4OPTIONS, 0, essential=False)
        # libtiff's CCITT state that outlives a strip (fast_tiff.cpp, Fax):
        # the T.4 "without EOL" mode a strip can switch on, the run arrays
        self.noeol = ctypes.c_int(0)
        self.runs = None
        self.photometric = lt.one(PHOTOMETRIC, None, 0xFFFF,
                                  essential=False)
        if comp == 6:
            self.photometric = photo
        if self.photometric is None:  # libtiff's guess for a missing tag
            self.photometric = 0 if comp in _FAX or self.bits == 1 \
                else 2 if self.spp == 3 else 1
        if self.photometric == 3 and self.bits < 8:
            # a ColorMap of another count than 3 << bits is ignored, and a
            # palette image below 8 bits without one does not open
            cmap = lt.raw(COLORMAP)
            if cmap is None or cmap[1] != 3 << self.bits or \
                    cmap[0] not in _LT_INTS or cmap[2] is None:
                raise ValueError("TIFF: palette without a ColorMap libtiff "
                                 "reads")
        try:
            sub = lt.ints(YCBCRSUBSAMPLING)
        except ValueError:
            sub = None
        self.subsampling = tuple(sub) if sub is not None and len(sub) == 2 \
            else (2, 2)
        self.tiled = TILEWIDTH in lt.entries
        planes = self.spp if self.planar == 2 else 1
        if self.tiled:
            self.tw, self.th = lt.one(TILEWIDTH, 0), lt.one(TILELENGTH, 0)
            if self.tw <= 0 or self.th <= 0 or self.tw % 16 or self.th % 16:
                raise ValueError("TIFF: bad tile size")
            nchunks = (-(-width // self.tw)) * (-(-length // self.th)) * planes
            otag, ctag = TILEOFFSETS, TILEBYTECOUNTS
        else:
            self.tw = width
            self.th = lt.one(ROWSPERSTRIP, 2 ** 32 - 1)
            if self.th == 0:
                raise ValueError("TIFF: zero rows per strip")
            nchunks = -(-length // min(self.th, length)) * planes
            otag, ctag = STRIPOFFSETS, STRIPBYTECOUNTS
        self.pspp = 1 if self.planar == 2 else self.spp  # samples a plane
        offs = lt.ints(otag, nchunks)
        # an old-style JPEG of one strip may do without its offset and
        # count: its data can all lie in JPEGInterchangeFormat
        one_oj = comp == 6 and not self.tiled and nchunks == 1
        if offs is None and one_oj:
            offs = (0,)
        if offs is None:
            raise ValueError("TIFF: missing required strip or tile offsets")
        counts = lt.ints(ctag, nchunks)
        if comp == 6:  # libtiff leaves an old-style JPEG's counts alone
            counts = () if counts is None else counts
        elif counts is None:  # TIFFReadDirectory's rules for estimating them
            if (self.planar == 1 and nchunks > 1) or (
                    self.planar == 2 and nchunks != self.spp):
                raise ValueError("TIFF: missing required byte counts")
            counts = self.estimate(offs, nchunks)
        elif not self.tiled and nchunks == 1 and self.count_looks_bad(
                offs, counts):
            counts = self.estimate(offs, nchunks)
        elif self.planar == 1 and nchunks > 2 and comp == 1 and \
                len(counts) > 1 and counts[0] != counts[1] and \
                counts[0] and counts[1]:
            counts = self.estimate(offs, nchunks)
        if min(offs, default=0) < 0 or min(counts, default=0) < 0:
            raise ValueError("TIFF: negative strip offset or byte count")
        self.offs = tuple(offs) + (0,) * (nchunks - len(offs))
        self.counts = tuple(counts) + (0,) * (nchunks - len(counts))
        self.swab = d.prefix == MM
        self.buffer = None  # PIL's strip or tile buffer (pil_buffer)
        self.rgba_buffers: dict = {}  # libtiff's, a plane each (rgba_buffer)
        self.rgba_allocated = False  # libtiff allocates it at a read strip
        self.jpeg_tables = None  # the JPEG tables libjpeg holds so far
        self.row0 = 0  # the first row of the strip being read
        self.oj = None  # the old-style JPEG session (_Ojpeg)
        self.oj_force = False
        if comp == 6:
            if sub is not None and len(sub) == 2 and max(sub) <= 0xFFFF:
                self.subsampling = (sub[0] & 0xFF, sub[1] & 0xFF)
            hs, vs, self.oj_force = _oj_subsampling(self)
            self.subsampling = (hs, vs)

    def count_looks_bad(self, offs, counts) -> bool:
        """ByteCountLooksBad, for one strip: a count of 0, or for an
        uncompressed one a count past the end of the file or short of the
        image."""
        off = offs[0] if offs else 0
        cnt = counts[0] if counts else 0
        if off == 0:
            return False
        if cnt == 0:
            return True
        if self.comp != 1:
            return False
        size = len(self.data)
        return (off <= size and cnt > size - off) or \
            cnt < self.row_bytes(self.im.xsize) * self.im.ysize

    def estimate(self, offs, nchunks) -> tuple:
        """EstimateStripByteCounts: for an uncompressed image a strip's
        rows (the image's height over the strips) or a tile; else the file
        less the header, the directory and its values, shared by every
        strip (per plane), the last cut at the end of the file."""
        if self.comp == 1:
            if self.tiled:
                return (self.row_bytes(self.tw) * self.th,) * nchunks
            per = nchunks // (self.spp if self.planar == 2 else 1)
            return (self.row_bytes(self.im.xsize) * (
                self.im.ysize // max(per, 1)),) * nchunks
        big = self.im.d.big
        space = (16 + 8 + 20 * len(self.lt.entries) + 8) if big else \
            (8 + 2 + 12 * len(self.lt.entries) + 4)
        for tag in self.lt.entries:
            typ, n, _, inline = self.lt.entries[tag]
            size = n * _LT_TYPES.get(typ, (0,))[0]
            if size > inline:
                space += size
        size = len(self.data)
        space = size if size < space else size - space
        if self.planar == 2:
            space //= self.spp
        counts = [space] * nchunks
        if offs and nchunks:
            last = offs[min(len(offs), nchunks) - 1]
            if last + counts[-1] > size:
                counts[-1] = 0 if last >= size else size - last
        return tuple(counts)

    def row_bytes(self, width: int) -> int:
        return (width * self.bits * self.pspp + 7) // 8

    def read(self, index: int, width: int, rows: int, plane: int,
             occ: int | None = None, partial: bool = False) -> bytes:
        """Strip or tile ``index``: its decoded bytes, rows of width
        pixels (libtiff's output: samples in native byte order), or ``occ``
        bytes where libtiff's size is not rows of pixels (packed YCbCr).
        ``partial`` returns, where the decode fails, what libtiff leaves in
        its buffer (the bytes decoded before the error; zeros for a strip
        it cannot read) instead of raising."""
        im = self.im
        if occ is None:
            occ = self.row_bytes(width) * rows
        if self.comp == 6:  # the codec reads the file itself
            if self.oj is None:
                self.oj = _Ojpeg(self)
            return self.oj.strip(index, occ, partial)
        off = self.offs[index] if index < len(self.offs) else 0
        cnt = self.counts[index] if index < len(self.counts) else 0
        if cnt <= 0 or off + cnt > len(self.data):
            raise _Unreadable("TIFF: a strip or tile lies past the end of "
                              "the file")
        raw = self.data[off:off + cnt]
        comp = self.comp
        if comp == 7:
            return self.jpeg(raw, width, rows, plane)
        if self.fillorder == 2 and comp not in _FAX:
            raw = _REV[np.frombuffer(raw, np.uint8)].tobytes()
        if comp == 1:  # DumpModeDecode: the strip holds the bytes or fails
            if len(raw) < occ:
                if not partial:
                    raise ValueError("TIFF: not enough uncompressed data")
                return b""
            return self.postdecode(raw[:occ], width, rows)
        if comp == 50000:
            return self.zstd(raw, width, rows, occ, partial)
        lib = tiff_lib()
        if comp in _FAX:
            return self.fax(lib, raw, width, rows, off)
        if comp == 32809:
            return self.thunder(lib, raw, width, rows)
        if comp == 32773:
            out = np.empty(occ, np.uint8)
            if lib.f101tiff_packbits(raw, len(raw), out.ctypes.data, occ):
                if not partial:  # the rest is zeroed, as libtiff leaves it
                    raise ValueError("TIFF: not enough PackBits data")
            out = out.tobytes()
        elif comp == 5:
            compat = len(raw) >= 2 and raw[0] == 0 and raw[1] & 1
            out = np.empty(occ, np.uint8)
            rc = lib.f101tiff_lzw(raw, len(raw), out.ctypes.data, occ,
                                  int(compat))
            if rc:
                if not partial:
                    raise ValueError("TIFF: broken LZW data")
                return out[:-rc - 1].tobytes()
            out = out.tobytes()
        elif comp in (8, 32946):
            out = _inflate(raw, occ, "Deflate", partial)
        elif comp == 34925:
            try:
                out = _unlzma(raw, occ)
            except ValueError:
                if not partial:
                    raise
                return b""
        else:
            raise ValueError(f"TIFF: compression {comp}")
        if partial and len(out) < occ:
            return out
        return self.postdecode(out, width, rows)

    def postdecode(self, out: bytes, width: int, rows: int) -> bytes:
        """The predictor (tif_predict.c) and the byte swap to native order."""
        bits, pred = self.bits, self.predictor
        if pred == 2 and self.comp in _PREDICTED:
            if bits not in (8, 16, 32, 64):
                raise ValueError("TIFF: horizontal differencing with "
                                 f"{bits}-bit samples")
            dt = np.dtype(f"u{bits // 8}").newbyteorder(
                ">" if self.swab else "<")
            a = np.frombuffer(out, dt).reshape(rows, width, self.pspp)
            a = np.cumsum(a.astype(dt.newbyteorder("<")), axis=1,
                          dtype=dt.newbyteorder("<"))
            return a.tobytes()
        if pred == 3 and self.comp in _PREDICTED:
            if self.fmt != 3 or bits not in (16, 24, 32, 64):
                raise ValueError("TIFF: floating point predictor on "
                                 f"{bits}-bit samples of format {self.fmt}")
            nb = bits // 8
            rb = width * self.pspp * nb
            a = np.frombuffer(out, np.uint8).reshape(rows, rb)
            a = np.cumsum(a.reshape(rows, -1, self.pspp), axis=1,
                          dtype=np.uint8).reshape(rows, rb)
            # bytes stored most significant first, plane by plane
            planes = a.reshape(rows, nb, width * self.pspp)
            return np.ascontiguousarray(
                planes[:, ::-1].transpose(0, 2, 1)).tobytes()
        if self.swab and bits in (16, 32) and len(out) == \
                self.row_bytes(width) * rows:
            dt = np.dtype(f">u{bits // 8}")
            return np.frombuffer(out, dt).astype(dt.newbyteorder("<")) \
                .tobytes()
        return out

    def zstd(self, raw: bytes, width: int, rows: int, occ: int,
             partial: bool) -> bytes:
        """tif_zstd.c ZSTDDecode (fast_zstd.cpp): a strip the data does not
        fill is an error that keeps what was decoded; any other error
        zeroes the strip."""
        lib = zstd_lib()
        out = np.empty(occ, np.uint8)
        got = ctypes.c_long(0)
        rc = lib.f101zstd_tiff(raw, len(raw), out.ctypes.data, occ,
                               ctypes.byref(got))
        if rc:
            if not partial:
                raise ValueError("TIFF: ZSTD data does not fill the strip"
                                 if rc == 1 else "TIFF: ZSTD decoding error "
                                 f"({lib.f101zstd_error().decode()})")
            return out[:got.value].tobytes()
        return self.postdecode(out.tobytes(), width, rows)

    def thunder(self, lib, raw: bytes, width: int, rows: int) -> bytes:
        """tif_thunder.c ThunderDecodeRow (fast_tiff.cpp): 4-bit samples
        only, no tiles; a row of too few or too many pixels fails."""
        if self.bits != 4:
            raise ValueError("TIFF: ThunderScan with other than 4 bits")
        if self.tiled:
            raise ValueError("TIFF: ThunderScan tiles")
        out = np.zeros(self.row_bytes(width) * rows, np.uint8)
        if self.row_bytes(width) != (width + 1) // 2 or lib.f101tiff_thunder(
                raw, len(raw), out.ctypes.data, width, rows):
            raise ValueError("TIFF: ThunderScan data at a scanline")
        return out.tobytes()

    def fax(self, lib, raw: bytes, width: int, rows: int, off: int) -> bytes:
        """A CCITT strip or tile into PIL's one buffer, which it reuses
        for every strip (or tile): the rows a strip cut short leaves
        undecoded keep the previous strip's (zeros before the first).
        ``off``: where the strip lies in the file, whose parity decides
        raw-16's word alignment (libtiff reads it in place: PIL maps the
        file into memory)."""
        im = self.im
        if self.bits != 1 or self.pspp != 1:
            raise ValueError("TIFF: CCITT coding of a non-bilevel image")
        out = self.pil_buffer(((width + 7) // 8) * rows)
        twod = self.t4 & 1
        if self.runs is None:
            self.runs = np.zeros(lib.f101tiff_fax_runs(
                width, int(self.comp == 4 or (self.comp == 3 and twod))),
                np.uint32)
        rc = lib.f101tiff_fax(raw, len(raw), self.comp, twod,
                              int(self.fillorder != 2), off & 1, width, rows,
                              out.ctypes.data, ctypes.byref(self.noeol),
                              self.runs.ctypes.data)
        if rc < 0:
            raise ValueError("TIFF: CCITT data ends where libtiff fails the "
                             "strip" if rc == -1 else
                             "TIFF: CCITT runs overflow the row")
        return out.tobytes()

    def jpeg(self, raw: bytes, width: int, rows: int, plane: int) -> bytes:
        """tif_jpeg.c JPEGPreDecode + JPEGDecode: one libjpeg decompressor
        for the file, so the quantization and Huffman tables of JPEGTables
        and of every strip before stay defined; libtiff's checks on the
        frame; a frame smaller than its strip fills the rows and columns it
        has of PIL's buffer, which keeps the rest (the last strip may be
        coded at full height)."""
        im = self.im
        if self.jpeg_tables is None:
            t = self.lt.raw(JPEGTABLES)
            tables = t[2] if t is not None and t[0] in (1, 6, 7) else None
            self.jpeg_tables = {}
            if tables:
                _jpeg_tables(tables, self.jpeg_tables)
        if raw[:2] != b"\xff\xd8":
            raise ValueError("TIFF: a JPEG strip without SOI")
        stream = (b"\xff\xd8" + b"".join(self.jpeg_tables.values())
                  + raw[2:])
        ycc = self.photometric == 6
        contig = self.planar == 1
        hs, vs = self.subsampling if ycc else (1, 1)
        if ycc and not contig:
            raise UnsupportedImage("TIFF: separate-plane YCbCr JPEG is not "
                                   "supported")
        color = 1 if ycc and contig else 0
        lib = _jpeg_lib()
        info = (ctypes.c_int * 6)()
        rc = lib.fastjpeg_decode_tiff(stream, len(stream), color, None, 0,
                                      info)
        if rc != 0:
            raise ValueError(f"TIFF: JPEG strip does not decode "
                             f"({lib.fastjpeg_error().decode()})")
        jw, jh, nc, h0, v0, ones = info
        jh_out = jh
        if not self.tiled and jw == width and jh > rows and \
                self.row0 + rows == im.ysize:
            jh_out = rows  # the last strip, coded at full height
        if jw > width or jh_out > rows:
            raise ValueError("TIFF: JPEG strip/tile size exceeds expected "
                             "dimensions")
        if nc != (self.spp if contig else 1):
            raise ValueError("TIFF: improper JPEG component count")
        if contig and ((h0, v0) != (hs, vs) or not ones):
            raise ValueError("TIFF: improper JPEG sampling factors")
        if not contig and (h0, v0) != (1, 1):
            raise ValueError("TIFF: improper JPEG sampling factors")
        out_nc = 3 if color else nc
        out = np.empty(jw * jh * out_nc, np.uint8)
        info[2] = nc
        rc = lib.fastjpeg_decode_tiff(stream, len(stream), color,
                                      out.ctypes.data, out.nbytes, info)
        if rc != 0:
            raise ValueError(f"TIFF: JPEG strip does not decode "
                             f"({lib.fastjpeg_error().decode()})")
        _jpeg_tables(raw, self.jpeg_tables, strip=True)
        rb = width * out_nc
        buf = self.pil_buffer(rb * rows)
        px = out.reshape(jh, jw * out_nc)[:jh_out]
        buf.reshape(rows, rb)[:jh_out, :jw * out_nc] = px
        return buf.tobytes()

    def rgba_block(self) -> None:
        """Start one of PIL's TIFFRGBAImageGet calls (a strip, or a row of
        tiles): libtiff's gtStripContig/gtTileContig allocate their buffer
        afresh in each call, at its first read."""
        self.rgba_buffers = {}
        self.rgba_allocated = False

    def rgba_read(self, index: int, width: int, rows: int, plane: int,
                  occ: int) -> bytes:
        """_TIFFReadEncodedStripAndAllocBuffer: a strip libtiff cannot
        read fails the image before the call's buffer exists and is zeros
        after; a decode error leaves what was decoded."""
        try:
            got = self.read(index, width, rows, plane, occ, partial=True)
        except _Unreadable:
            if not self.rgba_allocated:
                raise
            return bytes(occ)
        self.rgba_allocated = True
        return got

    def rgba_buffer(self, n: int, plane: int = 0) -> np.ndarray:
        """libtiff's buffer of one TIFFRGBAImageGet call (one a plane),
        zeroed when allocated and reused for every tile of the call."""
        bufs = self.rgba_buffers
        if plane not in bufs or len(bufs[plane]) < n:
            grown = np.zeros(n, np.uint8)
            if plane in bufs:
                grown[:len(bufs[plane])] = bufs[plane]
            bufs[plane] = grown
        return bufs[plane][:n]

    def pil_buffer(self, n: int) -> np.ndarray:
        """The first n bytes of PIL's strip (or tile) buffer, which it
        reuses for every strip: what a decoder does not write keeps the
        previous strip's bytes (zeros before the first)."""
        if self.buffer is None or len(self.buffer) < n:
            grown = np.zeros(n, np.uint8)
            if self.buffer is not None:
                grown[:len(self.buffer)] = self.buffer
            self.buffer = grown
        return self.buffer[:n]

    def decode(self) -> np.ndarray:
        """PIL's TiffDecode: _decodeStrip or _decodeTile with the raw
        mode's unpacker (per plane for PlanarConfiguration 2)."""
        im = self.im
        mode, raw = im.mode, im.rawmode
        if im.fillorder == 2:  # libtiff reverses the bits itself
            try:
                mode, raw = OPEN_INFO[im.key[:3] + (1,) + im.key[4:]]
            except KeyError:
                raise ValueError("TIFF: no fill order 1 mode") from None
        if self.photometric == 6 and not (self.comp == 7
                                          and self.planar == 1):
            rgba = self.ycbcr_rgba()
            if raw == "RGBX":
                return rgba
            # PIL unpacks libtiff's RGBA rows with its own raw mode, which
            # is L where its directory ends before SamplesPerPixel
            img = _new(mode, im.ysize, im.xsize)
            _put(img, 0, 0, UNPACKERS[raw][1](
                rgba.reshape(im.ysize, -1), im.xsize))
            return img
        if self.photometric == 6 and self.comp == 7:
            raw = "RGB" if self.spp == 3 else raw
        elif raw == "I;16":
            raw = "I;16N"
        elif raw.endswith((";16B", ";16L")):
            raw = raw[:-1] + "N"
        bits, main = UNPACKERS[raw]
        # PIL copies the first of the mode's bands from separate planes
        # (one plane per band byte, the high byte of 16-bit samples)
        bands = 4 if mode in ("RGBA", "CMYK") else 3 if mode == "RGB" else \
            2 if mode in ("LA", "PA") else 1
        if self.planar == 2 and bands > 1:
            self.planes = bands
            b16 = self.bits == 16
            unpackers = []
            for p in range(self.planes):
                def fn(r, n, p=p, b16=b16):
                    v = r[:, 1:2 * n:2] if b16 else r[:, :n]
                    return {p: v.copy()}
                unpackers.append(fn)
        else:
            self.planes = 1
            unpackers = [main]
        img = _new(mode, im.ysize, im.xsize)
        per = (im.xsize * bits // self.planes + 7) // 8
        if self.planar == 2 and not self.tiled and \
                per > self.row_bytes(im.xsize):
            # _decodeStrip: the unpacker's row is longer than libtiff's
            # (a plane's) scanline, where the raw mode has samples the
            # planes do not give one a band
            raise ValueError("TIFF: separate planes PIL's strip reader "
                             "refuses")
        if self.tiled:
            tile_bytes = self.row_bytes(self.tw) * self.th
            per_tile = ((self.th * bits // self.planes + 7) // 8) * self.tw
            if tile_bytes > per_tile:
                raise ValueError("TIFF: tile size larger than PIL expects")
            across = -(-im.xsize // self.tw)
            down = -(-im.ysize // self.th)
            for y in range(0, im.ysize, self.th):
                for p in range(self.planes):
                    for x in range(0, im.xsize, self.tw):
                        idx = (p * down + y // self.th) * across + x // self.tw
                        self.row0 = y
                        buf = self.read(idx, self.tw, self.th, p)
                        cw = min(self.tw, im.xsize - x)
                        ch = min(self.th, im.ysize - y)
                        rb = self.row_bytes(self.tw)
                        # PIL's unpacker reads its raw mode's width from
                        # each row start, which is past the row where the
                        # planes are separate but the mode is not (PX);
                        # past the buffer it reads what follows it in
                        # memory, zeros here
                        need = max(rb, (cw * bits + 7) // 8)
                        flat = np.zeros(ch * rb + need, np.uint8)
                        flat[:len(buf)] = np.frombuffer(buf, np.uint8)[
                            :len(flat)]
                        rows = np.lib.stride_tricks.as_strided(
                            flat, (ch, need), (rb, 1)).copy()
                        _put(img, y, x, unpackers[p](rows, cw))
        else:
            rps = min(self.th, im.ysize)
            strip = self.row_bytes(im.xsize) * rps
            # PIL's buffer holds its RowsPerStrip rows (the image's where
            # the tag is missing), which may be more than the image has
            if strip > per * (im.ysize if self.th == 2 ** 32 - 1 else self.th):
                raise ValueError("TIFF: strip size larger than PIL expects")
            if 2 ** 31 <= self.th < 2 ** 32 - 1:  # past PIL's int rows
                raise ValueError(f"TIFF: {self.th} rows per strip")
            nstrips = -(-im.ysize // rps)
            for y in range(0, im.ysize, rps):
                rows_here = min(rps, im.ysize - y)
                for p in range(self.planes):
                    self.row0 = y
                    buf = self.read(p * nstrips + y // rps, im.xsize,
                                    rows_here, p)
                    rb = self.row_bytes(im.xsize)
                    got = len(buf) // rb if rb else 0
                    rows = np.zeros((rows_here, rb), np.uint8)
                    k = min(got, rows_here)
                    rows[:k] = np.frombuffer(buf, np.uint8, k * rb).reshape(
                        -1, rb)
                    _put(img, y, 0, unpackers[p](rows, im.xsize))
        if self.planes > 3 and mode == "RGBA":
            # libtiff counts samples past the photometric's as unspecified
            # extra samples when the tag is missing; PIL unpremultiplies
            # unspecified and associated alpha
            ex = self.extra if self.extra is not None else (
                (0,) * (self.spp - 3) if self.photometric == 2 else ())
            if len(ex) >= 1 and ex[0] in (0, 1):
                img = _rgbx(img.reshape(im.ysize, -1), im.xsize, 4, alpha=3,
                            premul=True)
        return img


    def ycbcr_rgba(self) -> np.ndarray:
        """A YCbCr image PIL reads through TIFFReadRGBAStrip/Tile (any
        compression but contiguous JPEG): libtiff's packed blocks of
        hs x vs Y samples and one Cb, Cr (tif_getimage.c putcontig8bit
        YCbCr*tile) through TIFFYCbCrtoRGB (tif_color.c) -> PIL's RGB."""
        im, d = self.im, self.im.d
        if self.spp != 3 or self.bits != 8:
            raise ValueError("TIFF: YCbCr other than 3 samples of 8 bits")
        hs, vs = self.subsampling
        if self.planar == 2 and (hs, vs) != (1, 1):
            raise ValueError("TIFF: separate-plane YCbCr libtiff's RGBA "
                             "reader has no routine for")
        if hs not in (1, 2, 4) or vs not in (1, 2, 4):
            raise ValueError("TIFF: invalid YCbCr subsampling")
        if (hs, vs) in ((1, 4), (2, 4)):
            raise ValueError("TIFF: YCbCr subsampling libtiff's RGBA reader "
                             "has no routine for")
        r, g, b = _ycbcr_tables(d)
        w, h = im.xsize, im.ysize
        out = np.zeros((h, w, 4), np.uint8)
        out[..., 3] = 255  # libtiff's PACK: opaque
        if self.tiled:
            boxes = [(y, x, self.th, self.tw) for y in range(0, h, self.th)
                     for x in range(0, w, self.tw)]
        else:
            if self.th != 2 ** 32 - 1 and self.th * w * 4 > 2 ** 31 - 1:
                raise ValueError("TIFF: PIL cannot allocate an RGBA block of "
                                 f"{self.th} rows")
            rps = min(self.th, h)
            boxes = [(y, 0, min(rps, h - y), w) for y in range(0, h, rps)]
        if self.planar == 2:  # putseparate8bitYCbCr11tile
            for i, (y, x, rows, cols) in enumerate(boxes):
                if x == 0:
                    self.rgba_block()
                planes = []
                for p in range(3):
                    buf = self.rgba_buffer(rows * cols, p)
                    got = self.rgba_read(p * len(boxes) + i, cols, rows, p,
                                         rows * cols)
                    buf[:len(got)] = np.frombuffer(got, np.uint8)
                    planes.append(buf.reshape(rows, cols).astype(np.int64))
                yy, cb, cr = planes
                ch, cw = min(rows, h - y), min(cols, w - x)
                yy, cb, cr = yy[:ch, :cw], cb[:ch, :cw], cr[:ch, :cw]
                out[y:y + ch, x:x + cw, 0] = r(yy, cr)
                out[y:y + ch, x:x + cw, 1] = g(yy, cb, cr)
                out[y:y + ch, x:x + cw, 2] = b(yy, cb)
            return out
        for i, (y, x, rows, cols) in enumerate(boxes):
            if x == 0:
                self.rgba_block()
            bw, bh = -(-cols // hs), -(-rows // vs)
            occ = bw * bh * (hs * vs + 2)
            # libtiff asks for whole rows of its per-row share of a block
            # row, rounded down: the last bytes of each block row are then
            # not decoded (zeros: the call's buffer is new)
            share = bw * (hs * vs + 2) // vs * vs * bh
            # TIFFRGBAImageGet(stoponerr 0): a strip that fails to decode
            # leaves what it decoded in the call's buffer
            buf = self.rgba_buffer(occ)
            got = self.rgba_read(i, cols, rows, 0, min(share, occ))
            buf[:len(got)] = np.frombuffer(got, np.uint8)
            blk = buf.reshape(bh, bw, hs * vs + 2).astype(np.int64)
            yy = blk[..., :hs * vs].reshape(bh, bw, vs, hs).transpose(
                0, 2, 1, 3).reshape(bh * vs, bw * hs)
            cb = np.repeat(np.repeat(blk[..., -2], vs, 0), hs, 1)
            cr = np.repeat(np.repeat(blk[..., -1], vs, 0), hs, 1)
            ch, cw = min(rows, h - y), min(cols, w - x)
            yy, cb, cr = yy[:ch, :cw], cb[:ch, :cw], cr[:ch, :cw]
            out[y:y + ch, x:x + cw, 0] = r(yy, cr)
            out[y:y + ch, x:x + cw, 1] = g(yy, cb, cr)
            out[y:y + ch, x:x + cw, 2] = b(yy, cb)
        return out


# ---------------------------------------------------------------------------
# old-style JPEG (compression 6): libtiff's tif_ojpeg.c
# ---------------------------------------------------------------------------

class _OjFail(ValueError):
    """What tif_ojpeg.c fails before a strip's data: the header parse, or
    libjpeg's jpeg_read_header / jpeg_start_decompress and libtiff's checks
    after them."""


class _OjReader:
    """OJPEGReadByte and its kin over OJPEGReadBufferFill's input: the
    JPEGInterchangeFormat stream, then each strip or tile with data in
    turn. Reading past the last is a failure."""

    def __init__(self, fills: list):
        self.fills, self.i, self.j = fills, 0, 0

    def peek(self) -> int:
        fills = self.fills
        while self.i < len(fills) and self.j >= len(fills[self.i][1]):
            self.i, self.j = self.i + 1, 0
        if self.i >= len(self.fills):
            raise _OjFail("TIFF: old-style JPEG data ends in its header")
        return self.fills[self.i][1][self.j]

    def byte(self) -> int:
        v = self.peek()
        self.j += 1
        return v

    def word(self) -> int:
        return self.byte() << 8 | self.byte()

    def block(self, n: int) -> bytes:
        return bytes(self.byte() for _ in range(n))

    def skip(self, n: int) -> None:  # OJPEGReadSkip: quietly to the end
        while n > 0 and self.i < len(self.fills):
            k = min(n, len(self.fills[self.i][1]) - self.j)
            self.j += k
            n -= k
            if n:
                self.i, self.j = self.i + 1, 0


class _Ojpeg:
    """One image's libjpeg session as tif_ojpeg.c runs it for PIL's reads:
    OJPEGSubsamplingCorrect (the JPEG's own subsampling), OJPEGReadHeaderInfo
    (the JPEG header from JPEGInterchangeFormat or the strips' own bytes, or
    rebuilt from JPEGQTables, JPEGDCTables and JPEGACTables), the stream
    libtiff writes for libjpeg (its tables, DRI, frame and scan headers,
    the data with restart markers between strips and an EOI after the
    last) decoded by fast_jpeg.cpp, then OJPEGDecodeRaw's packed YCbCr
    lines (raw data: hs x vs Y samples, Cb, Cr; for 3 samples a pixel) or
    the components' scanlines (one sample), handed out strip by strip."""

    def __init__(self, lt: "_Libtiff"):
        d = lt.lt
        self.lt = lt
        h = lt.im.ysize
        if lt.tiled:
            self.sw, self.sl = lt.tw, lt.th
            self.sl_total = -(-h // lt.th) * lt.th
        else:
            self.sw = lt.im.xsize
            self.sl = h if lt.th == 2 ** 32 - 1 else lt.th
            self.sl_total = h
        self.fills, self.count = _oj_fills(lt), len(lt.offs)
        self.hs, self.vs = lt.subsampling
        self.force = lt.oj_force
        self.restart = d.one(515, 0, 0xFFFF, essential=False)
        self.tables = {}
        for tag in (519, 520, 521):
            try:
                v = d.ints(tag)
            except ValueError:
                v = None
            v = tuple(v) if v is not None and 0 < len(v) <= 3 else ()
            self.tables[tag] = v + (0,) * (3 - len(v))
        self.header()
        self.stream = self.write_stream()
        self.decode()
        self.cursor = self.curstrile = 0
        self.fatal = False  # libjpeg's source ran dry in a strip

    # -- OJPEGReadHeaderInfo ------------------------------------------------

    def header(self) -> None:
        lt = self.lt
        if lt.spp == 1:
            self.spp = self.per_plane = 1
            self.hs = self.vs = 1
        elif lt.spp != 3:
            raise _OjFail("TIFF: old-style JPEG with other than 1 or 3 "
                          "samples a pixel")
        else:
            self.spp, self.per_plane = 3, 1 if lt.planar == 2 else 3
        hs, vs = self.hs, self.vs
        if self.sl < lt.im.ysize:
            if hs not in (1, 2, 4) or vs not in (1, 2, 4):
                raise _OjFail("TIFF: invalid old-style JPEG subsampling")
            if self.sl % (vs * 8):
                raise _OjFail("TIFF: old-style JPEG strips of rows other "
                              "than a multiple of the subsampling")
            self.restart = (-(-self.sw // (hs * 8)) *
                            (self.sl // (vs * 8))) & 0xFFFF
        self.q, self.dc, self.ac = {}, {}, {}
        self.sof = None
        self.sos_cs, self.sos_tda = [0] * 3, [0] * 3
        r = _OjReader(self.fills)
        m = 0
        while m != 0xDA:
            if r.peek() != 0xFF:
                break
            r.byte()
            m = r.byte()
            while m == 0xFF:
                m = r.byte()
            if m == 0xD8:
                continue
            if m == 0xFE or 0xE0 <= m <= 0xEF:
                n = r.word()
                if n < 2:
                    raise _OjFail("TIFF: corrupt old-style JPEG data")
                r.skip(n - 2)
            elif m == 0xDD:
                if r.word() != 4:
                    raise _OjFail("TIFF: corrupt DRI marker")
                self.restart = r.word()
            elif m == 0xDB:
                n = r.word()
                if n <= 2:
                    raise _OjFail("TIFF: corrupt DQT marker")
                n -= 2
                while n > 0:
                    if n < 65:
                        raise _OjFail("TIFF: corrupt DQT marker")
                    b = r.block(65)
                    if b[0] & 15 > 3:
                        raise _OjFail("TIFF: corrupt DQT marker")
                    self.q[b[0] & 15] = b"\xff\xdb\x00\x43" + b
                    n -= 65
            elif m == 0xC4:
                n = r.word()
                if n <= 2:
                    raise _OjFail("TIFF: corrupt DHT marker")
                b = r.block(n - 2)
                o = b[0]
                if o & 0xF0 not in (0, 0x10) or o & 15 > 3:
                    raise _OjFail("TIFF: corrupt DHT marker")
                (self.ac if o & 0x10 else self.dc)[o & 15] = \
                    b"\xff\xc4" + struct.pack(">H", n) + b
            elif m in (0xC0, 0xC1, 0xC3):
                self.read_sof(r, m)
            elif m == 0xDA:
                if self.sof is None:
                    raise _OjFail("TIFF: corrupt SOS marker")
                if r.word() != 6 + 2 * self.per_plane or \
                        r.byte() != self.per_plane:
                    raise _OjFail("TIFF: corrupt SOS marker")
                for o in range(self.per_plane):
                    self.sos_cs[o] = r.byte()
                    self.sos_tda[o] = r.byte()
                r.skip(3)
            else:
                raise _OjFail(f"TIFF: unknown marker {m:#04x} in old-style "
                              "JPEG data")
        self.data_at = (r.i, r.j)
        if self.sof is None:
            self.tables_from_tags()
        if lt.planar == 2:  # each plane's own scan (OJPEGReadSecondarySos)
            raise UnsupportedImage("TIFF: separate-plane old-style JPEG is "
                                   "not supported")

    def read_sof(self, r: _OjReader, marker: int) -> None:
        if self.sof is not None:
            raise _OjFail("TIFF: corrupt old-style JPEG data")
        m = r.word()
        if m < 11 or (m - 8) % 3:
            raise _OjFail("TIFF: corrupt SOF marker")
        n = (m - 8) // 3
        if n != self.spp or r.byte() != 8:
            raise _OjFail("TIFF: old-style JPEG frame of another kind")
        y = r.word()
        if y < self.lt.im.ysize and y < self.sl_total:
            raise _OjFail("TIFF: old-style JPEG of unexpected height")
        x = r.word()
        if (x < self.lt.im.xsize and x < self.sw) or x > self.sw:
            raise _OjFail("TIFF: old-style JPEG of unexpected width")
        if r.byte() != n:
            raise _OjFail("TIFF: corrupt SOF marker")
        comps = []
        for q in range(n):
            c, hv, tq = r.byte(), r.byte(), r.byte()
            if not self.force and hv != (
                    (self.hs << 4 | self.vs) if q == 0 else 17):
                raise _OjFail("TIFF: old-style JPEG of unexpected "
                              "subsampling")
            comps.append((c, hv, tq))
        self.sof = (marker, y, x, comps)

    def tables_from_tags(self) -> None:
        """OJPEGReadHeaderInfoSecTables{QTable,DcTable,AcTable}: each
        sample's table at its offset (one equal to the previous sample's is
        shared), the frame and scan headers built from the directory."""
        data, spp = self.lt.data, self.spp
        qo, dco, aco = (self.tables[t] for t in (519, 520, 521))
        tq, tda = [0] * 3, [0] * 3
        for offs, kind in ((qo, "q"), (dco, "dc"), (aco, "ac")):
            if offs[0] == 0:
                raise _OjFail("TIFF: missing old-style JPEG tables")
            for m in range(spp):
                if offs[m] and (m == 0 or offs[m] != offs[m - 1]):
                    if any(offs[m] == offs[k] for k in range(m - 1)):
                        raise _OjFail("TIFF: corrupt old-style JPEG table "
                                      "offsets")
                    at = offs[m]
                    if kind == "q":
                        b = data[at:at + 64]
                        if len(b) != 64:
                            raise _OjFail("TIFF: old-style JPEG table past "
                                          "the end of the file")
                        self.q[m] = b"\xff\xdb\x00\x43" + bytes([m]) + b
                        tq[m] = m
                        continue
                    counts = data[at:at + 16]
                    total = sum(counts)
                    vals = data[at + 16:at + 16 + total]
                    if len(counts) != 16 or len(vals) != total:
                        raise _OjFail("TIFF: old-style JPEG table past the "
                                      "end of the file")
                    cls = 0 if kind == "dc" else 16
                    seg = b"\xff\xc4" + struct.pack(">H", 19 + total) + \
                        bytes([cls | m]) + counts + vals
                    if kind == "dc":
                        self.dc[m] = seg
                        tda[m] = m << 4
                    else:
                        self.ac[m] = seg
                        tda[m] |= m
                elif kind == "q":
                    tq[m] = tq[m - 1]
                elif kind == "dc":
                    tda[m] = tda[m - 1]
                else:
                    tda[m] |= tda[m - 1] & 15
        comps = [(o, (self.hs << 4 | self.vs) if o == 0 else 17, tq[o])
                 for o in range(spp)]
        self.sof = (0xC0, self.sl_total, self.sw, comps)
        self.sos_cs = [0, 1, 2]
        self.sos_tda = tda

    # -- the stream libtiff hands libjpeg (OJPEGWriteStream) ---------------

    def write_stream(self) -> bytes:
        marker, y, x, comps = self.sof
        out = bytearray(b"\xff\xd8")
        for tab in (self.q, self.dc, self.ac):
            for k in range(4):
                out += tab.get(k, b"")
        if self.restart:
            out += b"\xff\xdd\x00\x04" + struct.pack(">H", self.restart)
        pp = self.per_plane
        out += bytes([0xFF, marker, 0, 8 + 3 * pp, 8]) + struct.pack(
            ">HH", y & 0xFFFF, x & 0xFFFF) + bytes([pp])
        for c, hv, tq in comps[:pp]:
            out += bytes([c & 0xFF, hv, tq])
        out += bytes([0xFF, 0xDA, 0, 6 + 2 * pp, pp])
        for o in range(pp):
            out += bytes([self.sos_cs[o], self.sos_tda[o]])
        out += b"\x00\x3f\x00"
        i, j = self.data_at
        rst = 0
        while i < len(self.fills):
            kind, b, nxt = self.fills[i]
            out += b[j:]
            if kind == "strile" and len(b) > j:
                if nxt < self.count:
                    out += bytes([0xFF, 0xD0 + rst])
                    rst = (rst + 1) & 7
                else:  # libtiff's EOI; without it libjpeg reads past the end
                    out += b"\xff\xd9"
                    break
            i, j = i + 1, 0
        return bytes(out)

    # -- libjpeg's decode, and libtiff's checks after jpeg_start_decompress -

    def decode(self) -> None:
        lib = _jpeg_lib()
        raw = self.per_plane > 1 and not self.force
        info = (ctypes.c_int * 14)()
        s = self.stream
        if lib.fastjpeg_decode_ojpeg(s, len(s), int(raw), None, 0, info):
            raise _OjFail("TIFF: libjpeg refuses the old-style JPEG stream "
                          f"({lib.fastjpeg_error().decode()})")
        w, h, nc = info[0], info[1], info[2]
        samp = [(info[6 + 2 * k], info[7 + 2 * k]) for k in range(nc)]
        if raw:
            size = sum(-(-(-(-w * hh // info[3])) // 8) * 8 *
                       -(-(-(-h * vv // info[4])) // 8) * 8
                       for hh, vv in samp)
        else:
            size = w * h * nc
        out = np.zeros(max(size, 1), np.uint8)
        if lib.fastjpeg_decode_ojpeg(s, len(s), int(raw), out.ctypes.data,
                                     out.nbytes, info):
            raise _OjFail("TIFF: libjpeg refuses the old-style JPEG stream "
                          f"({lib.fastjpeg_error().decode()})")
        if w != self.sw or (info[3], info[4]) != (self.hs, self.vs):
            raise _OjFail("TIFF: old-style JPEG frame disagrees with the "
                          "image")
        hmax, vmax = info[3], info[4]
        failed_row = info[5]
        if not raw:  # scanlines of the components
            self.bpl = self.per_plane * self.sw
            self.per_strile = self.sl
            self.lines = out[:size].reshape(h, w * nc)[:, :self.bpl]
            self.fail_line = 2 ** 62 if failed_row < 0 else \
                failed_row * 8 * vmax
            return
        hs, vs = self.hs, self.vs
        ylen = -(-self.sw // (hs * 8)) * hs * 8
        clen = ylen // hs
        planes, at = [], 0
        for hh, vv in samp:
            bw = -(-(-(-w * hh // hmax)) // 8)
            bh = -(-(-(-h * vv // vmax)) // 8)
            planes.append(out[at:at + bw * bh * 64].reshape(bh * 8, bw * 8))
            at += bw * bh * 64
        n_imcu = -(-planes[0].shape[0] // (vs * 8))
        cout = -(-self.sw // hs)
        self.bpl = cout * (hs * vs + 2)
        self.per_strile = -(-self.sl // vs)
        # libtiff's buffers of one iMCU row: rows libjpeg does not write in
        # the last one keep the row before's (zeros for the first)
        yb = np.zeros((vs * 8, ylen), np.uint8)
        cb = np.zeros((2, 8, clen), np.uint8)
        lines = np.zeros((n_imcu * 8, self.bpl), np.uint8)
        for r in range(n_imcu):
            part = planes[0][r * vs * 8:(r + 1) * vs * 8, :ylen]
            yb[:part.shape[0], :part.shape[1]] = part
            for k in (1, 2):
                part = planes[k][r * 8:(r + 1) * 8, :clen]
                cb[k - 1, :part.shape[0], :part.shape[1]] = part
            y4 = yb[:, :cout * hs].reshape(8, vs, cout, hs).transpose(
                0, 2, 1, 3).reshape(8, cout, hs * vs)
            blk = np.concatenate([y4, cb[0][:, :cout, None],
                                  cb[1][:, :cout, None]], 2)
            lines[r * 8:(r + 1) * 8] = blk.reshape(8, self.bpl)
        self.lines = lines
        self.fail_line = 2 ** 62 if failed_row < 0 else failed_row * 8

    # -- OJPEGPreDecode, OJPEGDecode, OJPEGPostDecode ----------------------

    def strip(self, index: int, cc: int, partial: bool) -> bytes:
        """The bytes of strip (or tile) ``index`` PIL asked cc of."""
        if self.curstrile > index:  # a new session from the first strip
            self.cursor = self.curstrile = 0
            self.fatal = False
        while self.curstrile < index:
            # OJPEGPreDecodeSkip*: the lines of a strip that failed are read
            # past; libjpeg failing there fails the strip before PIL's
            # buffer exists, and so the image
            if self.fatal or self.cursor + self.per_strile > self.fail_line:
                raise ValueError("TIFF: old-style JPEG data ends")
            self.cursor += self.per_strile
            self.curstrile += 1
        bad = cc % self.bpl
        lines = cc // self.bpl
        if not bad and self.cursor + lines > self.fail_line:
            self.fatal = bad = True
        if bad:
            if not partial:
                raise ValueError("TIFF: old-style JPEG strip does not decode")
            return bytes(cc)
        got = self.lines[self.cursor:self.cursor + lines]
        out = np.zeros((lines, self.bpl), np.uint8)
        out[:len(got)] = got
        self.cursor += lines
        self.curstrile += 1
        if self.curstrile % max(1, len(self.lt.offs)) == 0:
            self.cursor = self.curstrile = 0
        return out.tobytes()


def _oj_fills(lt: "_Libtiff") -> list:
    """OJPEGReadBufferFill's input in turn: (kind, bytes, the strips read
    after it) for JPEGInterchangeFormat (its length cut at the end of the
    file, or running to it where it is 0) and each strip or tile with data
    (offsets of 0 or past the end skipped, a count of 0 meaning up to the
    end of the file)."""
    data, size = lt.data, len(lt.data)
    jif = lt.lt.one(513, 0, 2 ** 64 - 1, essential=False)
    jlen = lt.lt.one(514, 0, 2 ** 64 - 1, essential=False)
    if jif >= size:
        jif = 0
    elif jif and (jlen == 0 or jif + jlen > size):
        jlen = size - jif
    fills = [("jif", data[jif:jif + jlen], 0)] if jif else []
    for k, (off, cnt) in enumerate(zip(lt.offs, lt.counts)):
        if off and off < size:
            togo = size - off if cnt == 0 else min(cnt, size - off)
            fills.append(("strile", data[off:off + togo], k + 1))
    return fills


def _oj_subsampling(lt: "_Libtiff") -> tuple:
    """OJPEGSubsamplingCorrect: for 3 YCbCr samples the first frame
    header's subsampling (hs, vs, forced): factors TIFF has none for are
    left to libjpeg (forced, then 1 x 1). The tag's (or 2 x 2) where no
    frame header comes before the data; 1 x 1 for another image."""
    if lt.spp != 3 or lt.photometric not in (6, 10):
        return 1, 1, False
    hs, vs = lt.subsampling
    r = _OjReader(_oj_fills(lt))
    force = False
    try:
        while True:
            if r.peek() != 0xFF:
                break
            r.byte()
            m = r.byte()
            while m == 0xFF:
                m = r.byte()
            if m == 0xD8:
                continue
            if m in (0xFE, 0xDB, 0xC4) or 0xE0 <= m <= 0xEF:
                n = r.word()
                if n < 2 or (n == 2 and m in (0xDB, 0xC4)):
                    break
                r.skip(n - 2)
            elif m == 0xDD:
                if r.word() != 4:
                    break
                r.word()
            elif m in (0xC0, 0xC1, 0xC3):
                n = r.word()
                if n < 11 or (n - 8) % 3 or r.byte() != 8:
                    break
                r.skip(4)
                if r.byte() != (n - 8) // 3:
                    break
                for q in range((n - 8) // 3):
                    r.byte()
                    o = r.byte()
                    if q == 0:
                        hs, vs = o >> 4, o & 15
                        force |= hs not in (1, 2, 4) or vs not in (1, 2, 4)
                    else:
                        force |= o != 17
                    r.byte()
                break
            else:  # SOS, or a marker the parse refuses
                break
    except _OjFail:
        pass
    return (1, 1, True) if force else (hs, vs, False)


def _ycbcr_tables(d: _Dir):
    """tif_color.c TIFFYCbCrToRGBInit with the file's (or libtiff's
    default) YCbCrCoefficients and ReferenceBlackWhite, in C's float and
    int arithmetic -> functions giving R, G and B."""
    luma = d.get(529, (Fraction(299, 1000), Fraction(587, 1000),
                       Fraction(114, 1000)))
    refbw = d.get(532, (0, 255, 128, 255, 128, 255))
    try:
        key = (tuple(float(v) for v in luma), tuple(float(v) for v in refbw))
    except (TypeError, ValueError):
        raise ValueError("TIFF: bad YCbCr coefficients") from None
    if key not in _YCBCR_TABLES:
        _YCBCR_TABLES[key] = _ycbcr_init(*key)
    return _YCBCR_TABLES[key]


_YCBCR_TABLES: dict = {}


def _ycbcr_init(luma: tuple, refbw: tuple):
    f32 = np.float32
    try:
        lr, lg, lb = (f32(v) for v in luma)
        rb = [f32(v) for v in refbw]
    except (TypeError, ValueError):
        raise ValueError("TIFF: bad YCbCr coefficients") from None
    if len(rb) != 6 or lg == 0 or not np.all(np.isfinite(rb)):
        raise ValueError("TIFF: bad YCbCr coefficients")
    shift, half = 16, 1 << 15

    def fix(x):
        return int(np.float64(f32(f32(x) * f32(1 << shift))) + 0.5)

    def clamp(f, lo, hi):
        return lo if f < lo else hi if f > hi else f
    f1 = f32(2) - f32(2) * lr
    d1 = fix(clamp(f1, f32(0), f32(2)))
    f2 = f32(lr * f1) / lg
    d2 = -fix(clamp(f2, f32(0), f32(2)))
    f3 = f32(2) - f32(2) * lb
    d3 = fix(clamp(f3, f32(0), f32(2)))
    f4 = f32(lb * f3) / lg
    d4 = -fix(clamp(f4, f32(0), f32(2)))

    def code2v(c, b, w, cr):
        den = f32(w - b) if w - b != 0 else f32(1)
        return f32(f32(f32(c - int(b)) * f32(cr)) / den)

    def clampw(f):
        return int(f32(-128 * 32)) if f < f32(-128 * 32) else \
            int(f32(128 * 32)) if f > f32(128 * 32) else int(f)
    cr_r, cb_b, cr_g, cb_g, y_t = (np.zeros(256, np.int64) for _ in range(5))
    for i in range(256):
        x = i - 128
        cr = clampw(code2v(x, rb[4] - f32(128), rb[5] - f32(128), 127))
        cb = clampw(code2v(x, rb[2] - f32(128), rb[3] - f32(128), 127))
        cr_r[i] = (d1 * cr + half) >> shift
        cb_b[i] = (d3 * cb + half) >> shift
        cr_g[i] = d2 * cr
        cb_g[i] = d4 * cb + half
        y_t[i] = clampw(code2v(x + 128, rb[0], rb[1], 255))

    def c8(v):
        return np.clip(v, 0, 255).astype(np.uint8)
    return (lambda yy, cr: c8(y_t[yy] + cr_r[cr]),
            lambda yy, cb, cr: c8(y_t[yy] + ((cb_g[cb] + cr_g[cr]) >> shift)),
            lambda yy, cb: c8(y_t[yy] + cb_b[cb]))


# ---------------------------------------------------------------------------
# Orientation, and the entry point
# ---------------------------------------------------------------------------

def _transpose(img: np.ndarray, orientation) -> np.ndarray:
    """ImageOps.exif_transpose for Orientation 2-8."""
    if orientation == 2:
        return img[:, ::-1]
    if orientation == 3:
        return img[::-1, ::-1]
    if orientation == 4:
        return img[::-1]
    if orientation == 5:
        return img.transpose(1, 0, 2)
    if orientation == 6:
        return img.transpose(1, 0, 2)[:, ::-1]
    if orientation == 7:
        return img.transpose(1, 0, 2)[::-1, ::-1]
    if orientation == 8:
        return img.transpose(1, 0, 2)[::-1]
    return img


def decode_tiff_rgb8(data: bytes) -> np.ndarray:
    """TIFF bytes -> uint8 HxWx3, as PIL's ``Image.open(...).convert(
    "RGB")`` gives them (module docstring). Raises ValueError where PIL
    raises, :class:`UnsupportedImage` naming what the port does not
    decode: YCbCr (old-style) JPEG in separate planes, or a unit
    that did not build."""
    if data[:4] not in (b"MM\x00*", b"II*\x00", b"MM*\x00", b"II\x00*",
                        b"MM\x00+", b"II+\x00"):
        raise ValueError("not a TIFF")
    im = _Image(data)
    if im.compression in _PIL_REFUSES:
        raise ValueError(f"TIFF compression {_PIL_REFUSES[im.compression]}:"
                         " PIL refuses it too")
    if im.compression == 1:
        img = _decode_raw(im, data)
    else:
        img = _Libtiff(im, data).decode()
    rgb = to_rgb(im.mode, img, im.palette)
    return np.ascontiguousarray(_transpose(rgb, im.orientation))
