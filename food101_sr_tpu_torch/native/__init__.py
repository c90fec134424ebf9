"""Image codecs of the serving path, without PIL (counterpart of
``food101_sr_tpu/native/``, whose functions keep their names here).

The JAX package decodes requests with PIL and encodes responses with C++
over libpng and libjpeg, falling back to PIL where a library is missing.
A GPU host need not have PIL, libpng or libjpeg, so this module owns its
codecs and never substitutes one codec for another:

- PNG, both ways, on any host with a C++ compiler: the container and the
  deflate stream in Python (``struct``, the stdlib ``zlib``), the row
  filters in ``fast_png.cpp``, which needs no library. The encoder writes
  the JAX package's fixed SUB filter at a caller-chosen zlib level. The
  decoder reads 1/2/4/8-bit gray, 8-bit gray+alpha, RGB and RGBA, and
  1/2/4/8-bit palette images, to RGB as PIL's ``convert("RGB")`` does:
  gray replicated, alpha dropped without compositing, the palette
  expanded. 16-bit and Adam7-interlaced PNGs raise :class:`UnsupportedImage`
  naming them.
- JPEG, both ways, with the port's own codec (``fast_jpeg.cpp``), which
  needs no library: libjpeg-turbo's integer pipeline (ISLOW IDCT, fancy
  upsampling, fixed-point color) written out, so decodes are pixel-equal
  and encodes byte-equal to the JAX package's libjpeg binding. Baseline
  and progressive Huffman streams with 1 or 3 components decode; a region
  decode returns full-decode-then-crop's pixels while decoding only the
  rows and blocks the region needs. Arithmetic coding, lossless and
  hierarchical streams, 12-bit samples and CMYK/YCCK raise
  :class:`UnsupportedImage` naming the feature; broken or truncated
  streams raise ValueError.

Each C++ unit is compiled with ``g++`` on first use into the package's
git-ignored ``_build/`` directory, under a name carrying a hash of its
source and command, and loaded with ctypes (which releases the GIL for
each call). Nothing is built when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
import zlib
from typing import Optional

import numpy as np

from .._build import BUILD_DIR

_DIR = os.path.dirname(os.path.abspath(__file__))
_lock = threading.Lock()
_libs: dict = {}
_errors: dict = {}

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PIL's decompression-bomb limit (Image.MAX_IMAGE_PIXELS * 2, where PIL
# raises instead of warning)
MAX_PIXELS = 178_956_970


class UnsupportedImage(ValueError):
    """An image in a format, variant or codec this host cannot decode or
    encode (the HTTP server answers 415 with the message)."""


def _load(stem: str, link: tuple, register) -> Optional[ctypes.CDLL]:
    """Build (if not built yet) and load ``<stem>.cpp`` as
    ``_build/lib<stem>-<hash>.so``; None when it does not build here (the
    compiler's message is kept for :func:`build_error`)."""
    with _lock:
        if stem in _libs:
            return _libs[stem]
        src = os.path.join(_DIR, f"{stem}.cpp")
        flags = ("-O3", "-shared", "-fPIC")
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(
                flags + link).encode()).hexdigest()[:16]
        so = os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")
        lib = None
        try:
            if not os.path.exists(so):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{so}.{os.getpid()}.tmp"
                proc = subprocess.run(["g++", *flags, src, *link, "-o", tmp],
                                      capture_output=True, text=True,
                                      timeout=120)
                if proc.returncode != 0:
                    raise OSError(proc.stderr.strip().splitlines()[0]
                                  if proc.stderr.strip()
                                  else f"g++ exited {proc.returncode}")
                os.replace(tmp, so)  # atomic: concurrent loaders see all
            lib = ctypes.CDLL(so)
            register(lib)
        except (OSError, subprocess.TimeoutExpired) as e:
            _errors[stem] = str(e)
            lib = None
        _libs[stem] = lib
        return lib


def build_error(stem: str) -> str | None:
    """Why ``stem``'s library did not build or load here (None if it did
    or was not tried)."""
    return _errors.get(stem)


# ---------------------------------------------------------------------------
# PNG: container and zlib in Python, row filters in fast_png.cpp
# ---------------------------------------------------------------------------

def _register_png(lib):
    p, ll, i = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    lib.f101png_filter_sub.argtypes = [p, ll, ll, i, p]
    lib.f101png_filter_sub.restype = None
    lib.f101png_unfilter.argtypes = [p, ll, ll, i, p]
    lib.f101png_unfilter.restype = i


def _png_lib() -> ctypes.CDLL:
    lib = _load("fast_png", (), _register_png)
    if lib is None:
        raise RuntimeError("the PNG filter unit (native/fast_png.cpp, no "
                           "library needed) did not build: "
                           f"{build_error('fast_png')}")
    return lib


def native_available() -> bool:
    """Whether the PNG codec's C++ unit builds and loads here."""
    return _load("fast_png", (), _register_png) is not None


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def encode_png_rgb8(arr: np.ndarray, level: int = 1) -> bytes:
    """uint8 HxWx3 -> PNG bytes: 8-bit RGB, every row SUB-filtered, one
    IDAT at zlib ``level`` (clamped to 0..9; below 0 means 1, as in the
    JAX package's encoder)."""
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected uint8 HxWx3, got {arr.dtype} {arr.shape}")
    h, w = arr.shape[:2]
    if h == 0 or w == 0:
        raise ValueError(f"empty image {arr.shape}")
    arr = np.ascontiguousarray(arr)
    filtered = np.empty(h * (3 * w + 1), np.uint8)
    _png_lib().f101png_filter_sub(arr.ctypes.data, h, 3 * w, 3,
                                  filtered.ctypes.data)
    level = 1 if level < 0 else min(int(level), 9)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return b"".join((PNG_SIGNATURE, _chunk(b"IHDR", ihdr),
                     _chunk(b"IDAT", zlib.compress(filtered.data, level)),
                     _chunk(b"IEND", b"")))


# color type -> (channels, allowed bit depths)
_PNG_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)),
              3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)), 6: (4, (8, 16))}


def _png_chunks(data: bytes):
    """(type, body) of each chunk through IEND; raises ValueError on a
    truncated chunk or a CRC mismatch."""
    pos = len(PNG_SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise ValueError("PNG: truncated before IEND")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"PNG: truncated {ctype!r} chunk")
        body = data[pos + 8:end]
        if zlib.crc32(ctype + body) != struct.unpack(">I", data[end:end + 4])[0]:
            raise ValueError(f"PNG: bad CRC in {ctype!r} chunk")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos = end + 4


def _unpack_bits(rows: np.ndarray, depth: int, n: int) -> np.ndarray:
    """(h, stride) bytes of ``depth``-bit samples -> (h, n) uint8 values,
    most significant bits first."""
    if depth == 8:
        return rows[:, :n]
    per = 8 // depth
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
    return vals.reshape(rows.shape[0], rows.shape[1] * per)[:, :n]


def decode_png_rgb8(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 HxWx3, with PIL's ``convert("RGB")`` semantics.
    Raises :class:`UnsupportedImage` for 16-bit and Adam7-interlaced
    images, ValueError for anything that is not a whole, valid PNG."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG")
    ihdr, plte, idat = None, None, []
    for ctype, body in _png_chunks(data):
        if ctype == b"IHDR":
            if len(body) != 13:
                raise ValueError("PNG: bad IHDR")
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            plte = np.frombuffer(body, np.uint8)
        elif ctype == b"IDAT":
            idat.append(body)
    if ihdr is None or not idat:
        raise ValueError("PNG: no IHDR or no IDAT")
    w, h, depth, color, comp, filt, interlace = ihdr
    if color not in _PNG_TYPES or depth not in _PNG_TYPES[color][1]:
        raise ValueError(f"PNG: invalid color type {color} at depth {depth}")
    if depth == 16:
        raise UnsupportedImage("16-bit PNG is not supported (8-bit and "
                               "lower depths only)")
    if interlace:
        raise UnsupportedImage("Adam7-interlaced PNG is not supported")
    if comp or filt or w == 0 or h == 0:
        raise ValueError("PNG: bad IHDR")
    if w * h > MAX_PIXELS:
        raise ValueError(f"PNG: {w}x{h} exceeds {MAX_PIXELS} pixels")
    channels = _PNG_TYPES[color][0]
    stride = (w * channels * depth + 7) // 8
    need = h * (stride + 1)
    raw = zlib.decompressobj().decompress(b"".join(idat), need)
    if len(raw) < need:
        raise ValueError("PNG: image data truncated")
    rows = np.empty((h, stride), np.uint8)
    err = _png_lib().f101png_unfilter(raw, h, stride,
                                      max(1, channels * depth // 8),
                                      rows.ctypes.data)
    if err:
        raise ValueError(f"PNG: bad filter type in row {-err - 1}")
    vals = _unpack_bits(rows, depth, w * channels).reshape(h, w, channels)
    if color == 3:
        if plte is None or len(plte) % 3:
            raise ValueError("PNG: palette image without a valid PLTE")
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(plte) // 3] = plte.reshape(-1, 3)[:256]
        return pal[vals[..., 0]]
    if color in (0, 4):
        g = vals[..., 0] * np.uint8(255 // ((1 << depth) - 1))
        return np.repeat(g[..., None], 3, axis=2)
    return np.ascontiguousarray(vals[..., :3])


# ---------------------------------------------------------------------------
# JPEG: the port's codec in fast_jpeg.cpp
# ---------------------------------------------------------------------------

def _register_jpeg(lib):
    p, ll, i = ctypes.c_char_p, ctypes.c_long, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    lib.fastjpeg_error.restype = ctypes.c_char_p
    lib.fastjpeg_error.argtypes = []
    lib.fastjpeg_dims.restype = i
    lib.fastjpeg_dims.argtypes = [p, ll, ip, ip]
    lib.fastjpeg_decode_rgb8.restype = i
    lib.fastjpeg_decode_rgb8.argtypes = [p, ll, ctypes.c_void_p, ll, ip, ip]
    lib.fastjpeg_decode_crop_rgb8.restype = i
    lib.fastjpeg_decode_crop_rgb8.argtypes = [p, ll, i, i, i, i,
                                              ctypes.c_void_p, ll]
    lib.fastjpeg_encode_rgb8.restype = ll
    lib.fastjpeg_encode_rgb8.argtypes = [ctypes.c_void_p, i, i, i,
                                         ctypes.c_void_p, ll]


def jpeg_available() -> bool:
    """Whether the JPEG codec's C++ unit builds and loads here (it needs
    only a C++ compiler)."""
    return _load("fast_jpeg", (), _register_jpeg) is not None


def _jpeg_lib() -> ctypes.CDLL:
    lib = _load("fast_jpeg", (), _register_jpeg)
    if lib is None:
        raise UnsupportedImage("the JPEG codec (native/fast_jpeg.cpp, no "
                               "library needed) did not build here: "
                               f"{build_error('fast_jpeg')}")
    return lib


def _jpeg_raise(lib, rc: int):
    """Raise for a failed codec call: -2 is a stream the codec refuses by
    name, anything else a broken one."""
    msg = lib.fastjpeg_error().decode()
    if rc == -2:
        raise UnsupportedImage(msg)
    raise ValueError(msg or "JPEG: stream does not decode")


def jpeg_dims(data: bytes) -> Optional[tuple]:
    """(width, height) from the JPEG frame header only; None if no frame
    header parses."""
    w, h = ctypes.c_int(), ctypes.c_int()
    if _jpeg_lib().fastjpeg_dims(data, len(data), ctypes.byref(w),
                                 ctypes.byref(h)) != 0:
        return None
    return w.value, h.value


def decode_jpeg_rgb8(data: bytes) -> np.ndarray:
    """JPEG bytes -> uint8 HxWx3, pixel-equal to libjpeg-turbo's RGB
    output (gray replicated). Raises :class:`UnsupportedImage` for a
    stream the codec refuses by name, ValueError for a broken one."""
    lib = _jpeg_lib()
    dims = jpeg_dims(data)
    if dims is None:
        raise ValueError(f"JPEG: header does not parse "
                         f"({lib.fastjpeg_error().decode()})")
    w, h = dims
    if w * h > MAX_PIXELS:
        raise ValueError(f"JPEG: {w}x{h} exceeds {MAX_PIXELS} pixels")
    out = np.empty((h, w, 3), np.uint8)
    w2, h2 = ctypes.c_int(), ctypes.c_int()
    rc = lib.fastjpeg_decode_rgb8(data, len(data), out.ctypes.data,
                                  out.nbytes, ctypes.byref(w2),
                                  ctypes.byref(h2))
    if rc != 0:
        _jpeg_raise(lib, rc)
    return out


def encode_jpeg_rgb8(arr: np.ndarray, quality: int = 90) -> bytes:
    """uint8 HxWx3 -> JPEG bytes at ``quality`` (clamped to 1..100): the
    bytes libjpeg-turbo writes with its defaults at that quality (4:2:0,
    the standard tables, JFIF)."""
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected uint8 HxWx3, got {arr.dtype} {arr.shape}")
    lib = _jpeg_lib()
    h, w = arr.shape[:2]
    arr = np.ascontiguousarray(arr)
    # at most 26 bits per coefficient, each 0xFF byte stuffed: well under
    # 4 bytes per sample
    out = np.empty(4 * arr.nbytes + 4096, np.uint8)
    n = lib.fastjpeg_encode_rgb8(arr.ctypes.data, w, h, int(quality),
                                 out.ctypes.data, out.nbytes)
    if n <= 0:
        raise ValueError(f"JPEG: encode of {arr.shape} failed")
    return out[:n].tobytes()


def decode_jpeg_crop_rgb8(data: bytes, x0: int, y0: int, cw: int,
                          ch: int) -> Optional[np.ndarray]:
    """Exactly the [y0:y0+ch, x0:x0+cw] region of a full decode, paying
    only for the iMCU rows up to the region's last (every scan's) and the
    blocks it touches. None when the region is not inside the image;
    raises as :func:`decode_jpeg_rgb8` for the stream."""
    lib = _jpeg_lib()
    out = np.empty((max(ch, 0), max(cw, 0), 3), np.uint8)
    rc = lib.fastjpeg_decode_crop_rgb8(data, len(data), int(x0), int(y0),
                                       int(cw), int(ch), out.ctypes.data,
                                       out.nbytes)
    if rc == -3:
        return None
    if rc != 0:
        _jpeg_raise(lib, rc)
    return out


# ---------------------------------------------------------------------------
# the request decoder
# ---------------------------------------------------------------------------

# formats recognised by their first bytes but not decoded here
_OTHER_FORMATS = ((b"BM", "BMP"), (b"GIF87a", "GIF"), (b"GIF89a", "GIF"),
                  (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"))


def decode_image(data: bytes) -> np.ndarray:
    """Image bytes -> (H, W, 3) uint8 RGB, by the format's signature: PNG
    (:func:`decode_png_rgb8`) or JPEG (:func:`decode_jpeg_rgb8`). Raises
    :class:`UnsupportedImage` for a recognised format or variant the port
    does not decode (BMP, GIF, TIFF, WebP; 16-bit or interlaced PNG;
    arithmetic, lossless, 12-bit or CMYK JPEG), ValueError for bytes that
    are no image or a broken one."""
    if data.startswith(PNG_SIGNATURE):
        return decode_png_rgb8(data)
    if data.startswith(b"\xff\xd8\xff"):
        return decode_jpeg_rgb8(data)
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        raise UnsupportedImage("WebP is not supported (PNG and JPEG only)")
    for magic, name in _OTHER_FORMATS:
        if data.startswith(magic):
            raise UnsupportedImage(f"{name} is not supported (PNG and JPEG "
                                   "only)")
    raise ValueError("not a PNG or JPEG image")
