"""Image codecs of the serving and data paths, without PIL (counterpart
of ``food101_sr_tpu/native/``, whose functions keep their names here).

The JAX package decodes requests with PIL, decodes its dataset with
libjpeg-turbo (falling back to PIL where libjpeg refuses a stream), and
encodes responses with C++ over libpng and libjpeg. A GPU host need not
have PIL, libpng or libjpeg, so this module owns its codecs, gives on
each path what the JAX package's function gives, and never substitutes
one codec for another:

- PNG, both ways, on any host with a C++ compiler: the container and the
  deflate stream in Python (``struct``, the stdlib ``zlib``), the row
  filters in ``fast_png.cpp``, which needs no library. The encoder writes
  the JAX package's fixed SUB filter at a caller-chosen zlib level. The
  decoder reads every color type at every depth (1 to 16 bits),
  Adam7-interlaced or not, to RGB as PIL's ``convert("RGB")`` does.
- JPEG, both ways, with the port's own codec (``fast_jpeg.cpp``), which
  needs no library: libjpeg-turbo's pipeline written out, so decodes are
  pixel-equal and encodes byte-equal to the JAX package's. Baseline,
  extended and progressive streams, Huffman- or arithmetic-coded, with
  1, 3 or 4 components (gray, YCbCr, RGB, CMYK, YCCK), and lossless
  (SOF3) ones decode. :func:`decode_jpeg_rgb8` and the region decode
  :func:`decode_jpeg_crop_rgb8` give the JAX package's libjpeg-turbo 2.1
  binding's pixels, a truncated stream included (what was read, the rest
  as libjpeg fills it), or its PIL fallback's where the binding refuses
  (CMYK, YCCK, lossless); the request decoder :func:`decode_image` gives
  PIL's (libjpeg-turbo 3.1 fed in PIL's 64 KiB blocks), which refuses a
  stream cut short unless libjpeg never needed the missing bytes, and an
  arithmetic-coded one whose scan runs past a block. 12-bit,
  hierarchical and arithmetic lossless streams raise
  :class:`UnsupportedImage` naming the feature from the dataset decoders,
  as the JAX package refuses them too; the request decoder raises
  ValueError for the first two (PIL refuses them: the JAX server answers
  400). Broken streams raise ValueError.
- GIF (the first frame) and BMP (every header, depth and compression PIL
  reads), decoded as PIL's ``convert("RGB")``: containers in Python,
  LZW, rows and RLE in ``fast_gifbmp.cpp``.
- WebP, decoded as PIL's ``convert("RGB")`` (libwebp 1.6 behind it): the
  RIFF container as libwebp's demuxer reads it in Python; lossy (VP8),
  lossless (VP8L) and alpha (ALPH) bitstreams in ``fast_webp.cpp``, which
  needs no library; animations give their first frame.
- TIFF (``tiff.py``: PIL's container and raw decoder, libtiff's
  strips and tiles, PackBits, LZW, CCITT, raw-16 and ThunderScan in
  ``fast_tiff.cpp``, ZSTD in ``fast_zstd.cpp``, Deflate and LZMA with the
  stdlib, JPEG and old-style JPEG with ``fast_jpeg.cpp``), Netpbm, ICO,
  CUR and QOI (``rasters.py``; QOI's ops in ``fast_tiff.cpp``), decoded as
  PIL's ``convert("RGB")``.
- The request decoder :func:`decode_image` is PIL's ``Image.open`` walk
  (``openers.py``): each format in Pillow 12.1's ``Image.ID`` order by
  its test of the first 16 bytes, a header that PIL's plugin rejects
  falling through to the next (:class:`NotThisFormat`). It reaches DIB,
  TGA, IM, IMT, IPTC, PhotoCD, SPIDER, PCX/DCX, SGI, Sun raster and PSD
  too (``legacy.py``; run-length loops, PSD's PackBits and PhotoCD's YCC
  conversion in ``fast_legacy.cpp``), and JPEG 2000 (``jpeg2000.py``:
  PIL's plugin and unpackers over ``fast_j2k.cpp``, OpenJPEG 2.5.4's
  decoder written out). Lab images (PSD, CIELab TIFF) convert as PIL's
  LittleCMS transform does (``cielab.py``).
- The other formats PIL opens raise :class:`UnsupportedImage` naming
  them.

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


class NotThisFormat(ValueError):
    """Bytes a format's header parse rejects where PIL's ``_open`` raises
    an exception that ``Image.open`` catches: the request decoder's walk
    (``openers.py``) goes on to the next format; called alone, a decoder
    that raises it has refused the bytes like any ValueError."""


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


def _png_parts(data: bytes) -> tuple:
    """(IHDR body, PLTE body or None, the image data) as PIL's PNG plugin
    reads them: the chunks before the first IDAT whole and CRC-checked,
    then the data of the IDAT chunks that follow one another (cut where
    the file ends), their CRCs and whatever follows unread. Raises
    ValueError for a chunk cut short or a bad CRC before the image data,
    or no image data."""
    pos = len(PNG_SIGNATURE)
    ihdr = plte = None
    while True:
        if pos + 8 > len(data):
            raise NotThisFormat("PNG: truncated before the image data")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        if ctype == b"IDAT":
            break
        end = pos + 8 + length
        if end + 4 > len(data):
            raise NotThisFormat(f"PNG: truncated {ctype!r} chunk")
        body = data[pos + 8:end]
        if zlib.crc32(ctype + body) != struct.unpack(">I", data[end:end + 4])[0]:
            raise NotThisFormat(f"PNG: bad CRC in {ctype!r} chunk")
        if ctype == b"IEND":
            raise NotThisFormat("PNG: no image data")
        if ctype == b"IHDR":
            ihdr = body
        elif ctype == b"PLTE":
            plte = body
        pos = end + 4
    idat = []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        if ctype != b"IDAT":
            break
        idat.append(data[pos + 8:pos + 8 + length])
        pos += 12 + length
    return ihdr, plte, b"".join(idat)


def _unpack_bits(rows: np.ndarray, depth: int, n: int) -> np.ndarray:
    """(h, stride) bytes of ``depth``-bit samples -> (h, n) values, most
    significant bits first (uint16 at depth 16, else uint8)."""
    if depth == 16:
        return rows[:, :2 * n].view(">u2").astype(np.uint16)
    if depth == 8:
        return rows[:, :n]
    per = 8 // depth
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
    return vals.reshape(rows.shape[0], rows.shape[1] * per)[:, :n]


# Adam7: (x0, y0, dx, dy) of the seven passes
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_passes(w: int, h: int, channels: int, depth: int,
                interlace: int) -> list:
    """(x0, y0, dx, dy, width, height, stride) of each pass that has rows:
    the image itself, or Adam7's seven sub-images (an empty one has no
    rows, not even filter bytes)."""
    out = []
    for x0, y0, dx, dy in _ADAM7 if interlace else ((0, 0, 1, 1),):
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw > 0 and ph > 0:
            out.append((x0, y0, dx, dy, pw, ph,
                        (pw * channels * depth + 7) // 8))
    return out


def _png_samples(raw: bytes, passes: list, h: int, w: int, channels: int,
                 depth: int) -> np.ndarray:
    """The inflated IDAT stream -> (h, w, channels) sample values, each
    pass unfiltered on its own and scattered to its pixels."""
    out = None
    pos = 0
    for x0, y0, dx, dy, pw, ph, stride in passes:
        rows = np.empty((ph, stride), np.uint8)
        err = _png_lib().f101png_unfilter(raw[pos:pos + ph * (stride + 1)],
                                          ph, stride,
                                          max(1, channels * depth // 8),
                                          rows.ctypes.data)
        if err:
            raise ValueError(f"PNG: bad filter type in row {-err - 1}")
        pos += ph * (stride + 1)
        vals = _unpack_bits(rows, depth, pw * channels).reshape(ph, pw,
                                                                channels)
        if out is None:
            out = np.empty((h, w, channels), vals.dtype)
        out[y0::dy, x0::dx] = vals
    return out


def decode_png_rgb8(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 HxWx3, with PIL's ``convert("RGB")`` semantics:
    every color type at every depth, Adam7-interlaced or not. Gray is
    replicated, alpha dropped without compositing, the palette expanded,
    tRNS ignored; 16-bit RGB, RGBA and gray+alpha keep the high byte
    (PIL's ``;16B`` raw modes), 16-bit gray is PIL's ``I;16`` clipped at
    255. Raises ValueError where PIL refuses the file: a chunk before the
    image data cut short or with a bad CRC, image data that ends before
    the image is whole (the CRCs of the data chunks, and what follows
    them, IEND included, are not read)."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG")
    ihdr, plte, idat = _png_parts(data)
    if ihdr is None:  # PIL's plugin leaves no mode: not identified
        raise NotThisFormat("PNG: no IHDR")
    if len(ihdr) != 13:
        raise ValueError("PNG: a bad IHDR")
    if plte is not None:
        plte = np.frombuffer(plte, np.uint8)
    w, h, depth, color, comp, filt, interlace = struct.unpack(">IIBBBBB", ihdr)
    if color not in _PNG_TYPES or depth not in _PNG_TYPES[color][1]:
        raise NotThisFormat(f"PNG: invalid color type {color} at depth "
                            f"{depth}")
    if comp or filt or interlace > 1 or w == 0 or h == 0:
        raise NotThisFormat("PNG: bad IHDR")
    if w * h > MAX_PIXELS:
        raise ValueError(f"PNG: {w}x{h} exceeds {MAX_PIXELS} pixels")
    channels = _PNG_TYPES[color][0]
    passes = _png_passes(w, h, channels, depth, interlace)
    need = sum(ph * (stride + 1) for *_, ph, stride in passes)
    try:
        raw = zlib.decompressobj().decompress(idat, need)
    except zlib.error as e:
        raise ValueError(f"PNG: broken image data ({e})") from None
    if len(raw) < need:
        raise ValueError("PNG: image data truncated")
    vals = _png_samples(raw, passes, h, w, channels, depth)
    if color == 3:
        if plte is None or len(plte) % 3:
            raise ValueError("PNG: palette image without a valid PLTE")
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(plte) // 3] = plte.reshape(-1, 3)[:256]
        return pal[vals[..., 0]]
    if depth == 16:
        g = (np.minimum(vals[..., :1], 255) if color == 0
             else vals[..., :1 if color == 4 else 3] >> 8).astype(np.uint8)
        return np.ascontiguousarray(np.broadcast_to(g, (h, w, 3)))
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
    lib.fastjpeg_decode_rgb8.argtypes = [p, ll, ctypes.c_void_p, ll, ip, ip,
                                         i]
    lib.fastjpeg_decode_crop_rgb8.restype = i
    lib.fastjpeg_decode_crop_rgb8.argtypes = [p, ll, i, i, i, i,
                                              ctypes.c_void_p, ll]
    lib.fastjpeg_encode_rgb8.restype = ll
    lib.fastjpeg_encode_rgb8.argtypes = [ctypes.c_void_p, i, i, i,
                                         ctypes.c_void_p, ll]
    lib.fastjpeg_decode_tiff.restype = i
    lib.fastjpeg_decode_tiff.argtypes = [p, ll, i, ctypes.c_void_p, ll, ip]
    lib.fastjpeg_decode_ojpeg.restype = i
    lib.fastjpeg_decode_ojpeg.argtypes = [p, ll, i, ctypes.c_void_p, ll, ip]


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


def decode_jpeg_rgb8(data: bytes, *, strict: bool = False) -> np.ndarray:
    """JPEG bytes -> uint8 HxWx3, as the JAX package's
    ``decode_jpeg_rgb8`` gives them: libjpeg-turbo's RGB output (gray
    replicated), a truncated stream included (what was read, the rest
    as libjpeg fills it); for CMYK, YCCK and lossless streams, which its
    binding refuses, what its PIL fallback gives. ``strict`` decodes as PIL's ``Image.open(...).convert(
    "RGB")`` does, which raises ValueError for a stream that ends before
    its EOI marker. Raises :class:`UnsupportedImage` for a stream the codec
    refuses by name, ValueError for a broken one."""
    lib = _jpeg_lib()
    dims = jpeg_dims(data)
    if dims is None:  # PIL's marker walk fails there too ("no marker")
        raise NotThisFormat(f"JPEG: header does not parse "
                            f"({lib.fastjpeg_error().decode()})")
    w, h = dims
    if w * h > MAX_PIXELS:
        raise ValueError(f"JPEG: {w}x{h} exceeds {MAX_PIXELS} pixels")
    out = np.empty((h, w, 3), np.uint8)
    w2, h2 = ctypes.c_int(), ctypes.c_int()
    rc = lib.fastjpeg_decode_rgb8(data, len(data), out.ctypes.data,
                                  out.nbytes, ctypes.byref(w2),
                                  ctypes.byref(h2), int(strict))
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
    """The [y0:y0+ch, x0:x0+cw] region the JAX package's
    ``decode_jpeg_crop_rgb8`` gives (or, for CMYK/YCCK, its loader's PIL
    fallback: full decode, then crop), paying only for the iMCU rows up to
    the region's last (every scan's) and the blocks it touches. That is
    full-decode-then-crop's pixels, except where libjpeg block-smooths a
    progressive stream whose low coefficients are not fully refined: its
    region decode starts the smoothing at the region's first iMCU column,
    and so does this. None when the region is not inside the image;
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
# GIF and BMP: containers in Python, pixels in fast_gifbmp.cpp
# ---------------------------------------------------------------------------

def _register_gifbmp(lib):
    p, ll, i = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    lib.f101gif_lzw.argtypes = [ctypes.c_char_p, ll, i, i, p, i, i]
    lib.f101gif_lzw.restype = i
    lib.f101bmp_rows.argtypes = [ctypes.c_char_p, ll, i, i, ll, i, i,
                                 ctypes.c_char_p, i, i, i, p]
    lib.f101bmp_rows.restype = i
    lib.f101bmp_rle.argtypes = [ctypes.c_char_p, ll, ll, i, i, i, p]
    lib.f101bmp_rle.restype = ll


def _gifbmp_lib() -> ctypes.CDLL:
    lib = _load("fast_gifbmp", (), _register_gifbmp)
    if lib is None:
        raise UnsupportedImage("the GIF/BMP unit (native/fast_gifbmp.cpp, no "
                               "library needed) did not build here: "
                               f"{build_error('fast_gifbmp')}")
    return lib


def _gray_ramp(p: bytes) -> bool:
    """PIL's GIF ``_is_palette_needed`` negated: entry i is (i, i, i)."""
    return all(p[i] == p[i + 1] == p[i + 2] == i // 3
               for i in range(0, len(p) - 2, 3))


# index -> RGB of an "L" image (gray) and of a "P" one (the entries
# given, then black, as PIL's ``convert("RGB")`` looks them up)
_GRAY = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)


def _palette(entries: bytes) -> np.ndarray:
    pal = np.zeros((256, 3), np.uint8)
    n = min(len(entries) // 3, 256)
    pal[:n] = np.frombuffer(entries[:n * 3], np.uint8).reshape(n, 3)
    return pal


def decode_gif_rgb8(data: bytes) -> np.ndarray:
    """GIF bytes -> uint8 HxWx3: the first frame as PIL's
    ``Image.open(...).convert("RGB")`` gives it. The canvas is the logical
    screen (grown to hold the frame), filled with the frame's transparent
    index, else index 0; the frame's local color table, else the global
    one, maps the indices (none, or a gray ramp: the index is the gray);
    transparency is dropped. Raises ValueError where PIL raises: no image,
    a code the LZW decoder refuses, or data that ends before the frame is
    whole."""
    if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 13:
        raise ValueError("not a GIF")
    sw, sh, flags = struct.unpack_from("<HHB", data, 6)
    pos, gpal = 13, None
    if flags & 0x80:
        size = 3 << ((flags & 7) + 1)
        gpal = data[pos:pos + size]
        pos += size
        if _gray_ramp(gpal):
            gpal = None

    def sub_blocks(pos):
        """The first sub-block at pos (None if empty) and the position
        after all of them."""
        first = None
        while pos < len(data):
            n = data[pos]
            pos += 1
            if n == 0:
                break
            if first is None:
                first = data[pos:pos + n]
            pos += n
        return first, pos

    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise NotThisFormat("GIF: no image in the file")
        b = data[pos]
        pos += 1
        if b == 0x21:  # extension: the graphic control one has transparency
            label = data[pos] if pos < len(data) else 0
            block, pos = sub_blocks(pos + 1)
            if label == 0xF9 and block is not None:
                if len(block) < 4:
                    raise ValueError("GIF: bad graphic control extension")
                if block[0] & 1:
                    transparency = block[3]
        elif b == 0x2C:
            break
    if pos + 9 > len(data):
        raise ValueError("GIF: truncated image descriptor")
    x0, y0, fw, fh, fflags = struct.unpack_from("<HHHHB", data, pos)
    pos += 9
    pal = gpal
    if fflags & 0x80:
        size = 3 << ((fflags & 7) + 1)
        pal = data[pos:pos + size]
        pos += size
        if _gray_ramp(pal):
            pal = None
    if pos >= len(data):
        raise ValueError("GIF: truncated before the image data")
    bits = data[pos]
    pos += 1
    w, h = max(sw, x0 + fw), max(sh, y0 + fh)
    if w * h > MAX_PIXELS:
        raise ValueError(f"GIF: {w}x{h} exceeds {MAX_PIXELS} pixels")
    if w == 0 or h == 0 or fw == 0 or fh == 0:
        raise ValueError("GIF: empty image")
    canvas = np.full((h, w), transparency or 0, np.uint8)
    frame = np.zeros((fh, fw), np.uint8)
    rc = _gifbmp_lib().f101gif_lzw(data[pos:], len(data) - pos, bits,
                                   int(bool(fflags & 0x40)),
                                   frame.ctypes.data, fw, fh)
    if rc:
        raise ValueError("GIF: broken LZW data" if rc < 0 else
                         "GIF: image data ends before the frame is whole")
    canvas[y0:y0 + fh, x0:x0 + fw] = frame
    return (_palette(pal) if pal is not None else _GRAY)[canvas]


# BI_BITFIELDS layouts PIL reads: (bits, masks) -> byte shifts of R, G, B
# (32-bit), or the 16-bit kind
_BMP_MASKS = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): (16, 8, 0),
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): (24, 16, 8),
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): (24, 8, 0),
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): (24, 16, 8),
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): (0, 8, 16),
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): (16, 8, 0),
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): (24, 8, 0),
    (32, (0x0, 0x0, 0x0, 0x0)): (16, 8, 0),
    (24, (0xFF0000, 0xFF00, 0xFF)): 24,
    (16, (0xF800, 0x7E0, 0x1F)): 16,
    (16, (0x7C00, 0x3E0, 0x1F)): 15,
}


def decode_bmp_rgb8(data: bytes) -> np.ndarray:
    """BMP bytes -> uint8 HxWx3, as PIL's BmpImagePlugin reads it and
    ``convert("RGB")`` maps it: the core, info and V2-V5 headers; 1/4/8-bit
    palette images (a palette that is all gray read as PIL's "L" or "1"
    raw mode, one byte or one bit per pixel whatever the depth), 16-bit
    5-5-5, 24-bit, 32-bit, the BI_BITFIELDS layouts PIL lists, RLE8 and
    RLE4 through PIL's own RLE decoder; bottom-up or top-down. Raises
    ValueError where PIL raises."""
    if not data.startswith(b"BM") or len(data) < 18:
        raise ValueError("not a BMP")
    offset, hsize = struct.unpack_from("<II", data, 10)
    header = data[18:14 + hsize]
    if len(header) < hsize - 4:
        raise ValueError("BMP: truncated header")
    pos = 14 + hsize
    direction = -1
    compression, colors, pad = 0, 0, 3
    if hsize == 12:
        w, h, _, bits = struct.unpack_from("<HHHH", header)
    elif hsize in (40, 52, 56, 64, 108, 124):
        pad = 4
        if header[7] == 0xFF:
            direction = 1
        w, h = struct.unpack_from("<II", header)
        if direction == 1:
            h = 2**32 - h
        bits, compression = struct.unpack_from("<HI", header, 10)
        colors = struct.unpack_from("<I", header, 28)[0]
        if compression == 3:
            if len(header) >= 48:
                masks = struct.unpack_from("<III", header, 36)
                masks += (struct.unpack_from("<I", header, 48)[0]
                          if len(header) >= 52 else 0,)
            else:
                masks = struct.unpack_from("<III", data, pos) + (0,)
                pos += 12
    else:
        raise ValueError(f"BMP: unsupported header size {hsize}")
    if w * h > MAX_PIXELS:
        raise ValueError(f"BMP: {w}x{h} exceeds {MAX_PIXELS} pixels")
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"BMP: unsupported pixel depth {bits}")
    kind, shifts, rle = (bits if bits != 16 else 15), (16, 8, 0), False
    if compression == 3:
        key = (bits, masks if bits == 32 else masks[:3])
        if key not in _BMP_MASKS:
            raise ValueError("BMP: unsupported bitfields layout")
        layout = _BMP_MASKS[key]
        if bits == 32:
            shifts = layout
        else:
            kind = layout
    elif compression in (1, 2):
        rle = True
    elif compression != 0:
        raise ValueError(f"BMP: unsupported compression {compression}")
    pal = _GRAY
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise ValueError(f"BMP: unsupported palette size {colors}")
        entries = data[pos:pos + pad * colors]
        vals = (0, 255) if colors == 2 else range(colors)
        gray = all(entries[i * pad:i * pad + 3] == bytes([v]) * 3
                   for i, v in enumerate(vals))
        if gray:  # PIL's "1" or "L": raw bits or bytes, whatever the depth
            kind = 1 if colors == 2 else 8
            if not rle and (w * kind + 7) // 8 > ((w * bits + 31) >> 3) & ~3:
                raise ValueError("BMP: rows shorter than PIL's gray raw mode")
            pal = _GRAY if colors != 2 else np.where(
                _GRAY > 0, np.uint8(255), np.uint8(0))
        else:
            b, g, r = (np.frombuffer(entries[:len(entries) // pad * pad],
                                     np.uint8).reshape(-1, pad)[:, k]
                       for k in range(3))
            pal = _palette(np.stack([r, g, b], 1).tobytes())
    lib = _gifbmp_lib()
    out = np.empty((h, w, 3), np.uint8)
    src = data[offset:]
    if rle:
        if bits > 8:
            raise ValueError("BMP: run-length coding of a non-palette image")
        idx = np.zeros(w * h + 256, np.uint8)
        n = lib.f101bmp_rle(src, len(src), offset, w, h, int(compression == 2),
                            idx.ctypes.data)
        if n < w * h:
            raise ValueError("BMP: not enough image data")
        rows = idx[:w * h].reshape(h, w)
        if direction == -1:
            rows = rows[::-1]
        return pal[rows]
    stride = ((w * bits + 31) >> 3) & ~3
    if lib.f101bmp_rows(src, len(src), w, h, stride, int(direction == 1),
                        kind, pal.tobytes(), *shifts, out.ctypes.data):
        raise ValueError("BMP: image data truncated")
    return out


# ---------------------------------------------------------------------------
# WebP: the RIFF container as libwebp's demuxer reads it, in Python; VP8,
# VP8L and ALPH in fast_webp.cpp
# ---------------------------------------------------------------------------

def _register_webp(lib):
    p, ll, i = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    lib.f101webp_vp8_yuv.argtypes = [ctypes.c_char_p, ll, i, i, p, p, p]
    lib.f101webp_vp8_yuv.restype = i
    lib.f101webp_yuv_rgb.argtypes = [p, p, p, i, i, p, ll]
    lib.f101webp_yuv_rgb.restype = None
    lib.f101webp_vp8l_argb.argtypes = [ctypes.c_char_p, ll, i, i, p]
    lib.f101webp_vp8l_argb.restype = i
    lib.f101webp_alpha.argtypes = [ctypes.c_char_p, ll, i, i, p]
    lib.f101webp_alpha.restype = i


def _webp_lib() -> ctypes.CDLL:
    lib = _load("fast_webp", (), _register_webp)
    if lib is None:
        raise UnsupportedImage("the WebP unit (native/fast_webp.cpp, no "
                               "library needed) did not build here: "
                               f"{build_error('fast_webp')}")
    return lib


_WEBP_MAX_PAYLOAD = 0xFFFFFFFF - 8 - 1
_WEBP_ALPHA, _WEBP_ANIMATION = 0x10, 0x02
_WEBP_VALID_FLAGS = 0x3E  # alpha, animation, ICC, EXIF, XMP


class _WebPFrame:
    """A frame as libwebp's demuxer records it: its image and alpha
    chunks as (offset, size with header and padding), its bitstream's
    size, its offset on the canvas."""

    def __init__(self):
        self.x = self.y = self.width = self.height = 0
        self.frame_num = 0
        self.has_alpha = False
        self.img = (0, 0)
        self.alpha = (0, 0)


def _webp_features(chunk: bytes):
    """(width, height, has_alpha) of a VP8 or VP8L chunk (header
    included) as libwebp's WebPGetFeatures reads it; None where it
    refuses the chunk."""
    size = struct.unpack_from("<I", chunk, 4)[0]
    data = chunk[8:]
    if chunk[:4] == b"VP8L":
        if (len(data) < 5 or data[0] != 0x2F or data[4] >> 5):
            return None
        bits = int.from_bytes(data[1:5], "little")
        return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, \
            bool((bits >> 28) & 1)
    if len(data) < 10 or data[3:6] != b"\x9d\x01\x2a":
        return None
    bits = data[0] | (data[1] << 8) | (data[2] << 16)
    w, h = (struct.unpack_from("<HH", data, 6)[i] & 0x3FFF for i in (0, 1))
    if (bits & 1) or ((bits >> 1) & 7) > 3 or not (bits >> 4) & 1 \
            or (bits >> 5) >= size or w == 0 or h == 0:
        return None
    return w, h, False


class _WebPDemux:
    """libwebp's WebPDemux over a whole file (libwebpdemux, which PIL's
    WebP plugin opens every file with): the RIFF header, the simple
    (VP8/VP8L) and extended (VP8X) layouts, ALPH, ANIM and ANMF, ICCP,
    EXIF, XMP and unknown chunks skipped, and the checks that make it
    refuse a file, each raising ValueError. (For a whole file, the data
    libwebp would wait for is data that is not there: an error too.)"""

    def __init__(self, data: bytes):
        self.d = data
        self.frames: list = []
        self.canvas = (0, 0)
        self.flags = 0
        self.is_ext = False
        riff_size = struct.unpack_from("<I", data, 4)[0]
        if riff_size < 8 or riff_size > _WEBP_MAX_PAYLOAD:
            raise ValueError("WebP: bad RIFF size")
        self.riff_end = riff_size + 8  # nothing past it is read
        if len(data) < self.riff_end:
            raise ValueError("WebP: file shorter than its RIFF size")
        self.pos = 12

    def need(self, n: int):
        if n > self.riff_end - self.pos:
            raise ValueError("WebP: a chunk runs past the RIFF size")

    def u(self, n: int) -> int:
        v = int.from_bytes(self.d[self.pos:self.pos + n], "little")
        self.pos += n
        return v

    def chunk_header(self) -> tuple:
        """The next chunk's fourcc and padded size, checked to fit."""
        fourcc = self.d[self.pos:self.pos + 4]
        self.pos += 4
        size = self.u(4)
        if size > _WEBP_MAX_PAYLOAD:
            raise ValueError("WebP: bad chunk size")
        padded = size + (size & 1)
        self.need(padded)
        return fourcc, padded

    def parse(self):
        if self.d[12:16] in (b"VP8 ", b"VP8L"):
            self.single_image()
            f = self.frames[0]
            ok = min(self.canvas) > 0 and f.width > 0 and f.height > 0
        else:
            self.vp8x()
            ok = self.valid_extended()
        if not ok:
            raise ValueError("WebP: the container does not hold a valid "
                             "image")

    def store_frame(self, frame_num: int, min_size: int, f: _WebPFrame):
        """A frame's ALPH and image chunks, up to the first other chunk."""
        self.need(max(8, min_size))
        alpha_chunks = image_chunks = 0
        while True:
            start = self.pos
            fourcc, padded = self.chunk_header()
            if fourcc == b"ALPH" and not alpha_chunks:
                alpha_chunks = 1
                f.alpha = (start, 8 + padded)
                f.has_alpha = True
                f.frame_num = frame_num
            elif fourcc == b"VP8L" and alpha_chunks:
                raise ValueError("WebP: ALPH before VP8L")
            elif fourcc in (b"VP8 ", b"VP8L") and not image_chunks:
                feats = _webp_features(self.d[start:start + 8 + padded])
                if feats is None:
                    raise ValueError("WebP: bad image header")
                image_chunks = 1
                f.img = (start, 8 + padded)
                f.width, f.height = feats[0], feats[1]
                f.has_alpha |= feats[2]
                f.frame_num = frame_num
            else:
                self.pos = start
                return
            self.pos += padded
            if self.pos == self.riff_end:
                return
            self.need(8)

    def single_image(self):
        if self.frames:
            raise ValueError("WebP: a second image")
        self.need(8)
        f = _WebPFrame()
        self.store_frame(1, 0, f)
        if not self.flags & _WEBP_ALPHA and f.alpha[1] > 0:
            f.alpha, f.has_alpha = (0, 0), False  # ignored without the flag
        if not self.is_ext and f.width > 0 and f.height > 0:
            self.canvas = (f.width, f.height)
            self.flags |= _WEBP_ALPHA if f.has_alpha else 0
        self.frames.append(f)

    def vp8x(self):
        self.need(8)
        self.is_ext = True
        self.pos += 4
        size = self.u(4)
        if size > _WEBP_MAX_PAYLOAD or size < 10:
            raise ValueError("WebP: bad VP8X chunk")
        size += size & 1
        self.need(size)
        self.flags = self.u(1)
        self.pos += 3
        self.canvas = (1 + self.u(3), 1 + self.u(3))
        if self.canvas[0] * self.canvas[1] >= 1 << 32:
            raise ValueError("WebP: canvas too large")
        self.pos += size - 10
        self.need(8)
        is_animation = bool(self.flags & _WEBP_ANIMATION)
        anim_chunks = 0
        while True:
            fourcc, padded = self.chunk_header()
            if fourcc == b"VP8X":
                raise ValueError("WebP: a second VP8X chunk")
            if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
                if anim_chunks or is_animation:
                    raise ValueError("WebP: an image outside ANMF in an "
                                     "animation")
                self.pos -= 8
                self.single_image()
            elif fourcc == b"ANIM" and not anim_chunks:
                if padded < 6:
                    raise ValueError("WebP: bad ANIM chunk")
                anim_chunks = 1
                self.pos += padded  # background color, loop count
            elif fourcc == b"ANIM" and padded < 6:
                raise ValueError("WebP: bad ANIM chunk")
            elif fourcc == b"ANMF":
                if not anim_chunks:
                    raise ValueError("WebP: ANMF before ANIM")
                self.animation_frame(padded)
            else:  # ICCP, EXIF, XMP, a second ANIM and unknown chunks
                self.pos += padded
            if self.pos == self.riff_end:
                return
            self.need(8)

    def animation_frame(self, frame_chunk_size: int):
        self.need(16)
        if frame_chunk_size < 16:
            raise ValueError("WebP: bad ANMF chunk")
        f = _WebPFrame()
        f.x, f.y = 2 * self.u(3), 2 * self.u(3)
        if (1 + self.u(3)) * (1 + self.u(3)) >= 1 << 32:
            raise ValueError("WebP: frame too large")
        self.pos += 4  # duration, dispose and blend bits
        start = self.pos
        self.store_frame(len(self.frames) + 1, frame_chunk_size - 16, f)
        if self.pos - start > frame_chunk_size - 16:
            raise ValueError("WebP: a frame runs past its ANMF chunk")
        if self.flags & _WEBP_ANIMATION and f.frame_num > 0:
            self.frames.append(f)

    def valid_extended(self) -> bool:
        """The frame checks of libwebp's IsValidExtendedFormat: an image
        in each (after its ALPH), inside the canvas (the canvas itself
        for a still)."""
        is_animation = bool(self.flags & _WEBP_ANIMATION)
        cw, ch = self.canvas
        if not self.frames or self.flags & ~_WEBP_VALID_FLAGS:
            return False
        for f in self.frames:
            if not is_animation and f.frame_num > 1:
                return False
            if f.img[1] == 0 or (f.alpha[1] > 0 and f.alpha[0] > f.img[0]):
                return False
            if not is_animation:
                if f.x or f.y or (f.width, f.height) != (cw, ch):
                    return False
            elif f.x + f.width > cw or f.y + f.height > ch:
                return False
        return True


def _webp_payload(data: bytes, f: _WebPFrame):
    """The frame's payload as libwebp's decoder is handed it (its ALPH
    chunk through its image chunk) -> (is_lossless, the image chunk's
    data with its padding byte, its width, height, the ALPH data or
    None), with the checks WebPDecode makes on its headers."""
    start, size = f.img
    if f.alpha[1] > 0:
        payload = data[f.alpha[0]:start + size]
    else:
        payload = data[start:start + size]
    pos, alpha = 0, None
    if payload[:4] == b"ALPH":
        while True:  # the chunks before the image (ParseOptionalChunks)
            if len(payload) - pos < 8:
                raise ValueError("WebP: truncated chunk")
            csize = struct.unpack_from("<I", payload, pos + 4)[0]
            if csize > _WEBP_MAX_PAYLOAD:
                raise ValueError("WebP: bad chunk size")
            if payload[pos:pos + 4] in (b"VP8 ", b"VP8L"):
                break
            disk = (8 + csize + 1) & ~1
            if len(payload) - pos < disk:
                raise ValueError("WebP: truncated chunk")
            if payload[pos:pos + 4] == b"ALPH":
                alpha = payload[pos + 8:pos + 8 + csize]
            pos += disk
    if len(payload) - pos < 8:
        raise ValueError("WebP: truncated image chunk")
    csize = struct.unpack_from("<I", payload, pos + 4)[0]
    body = payload[pos + 8:]
    if csize > len(body):
        raise ValueError("WebP: truncated image chunk")
    feats = _webp_features(payload[pos:])
    if feats is None:
        raise ValueError("WebP: bad image header")
    return payload[pos:pos + 4] == b"VP8L", body, feats[0], feats[1], alpha


def _webp_vp8_planes(lib, body: bytes, w: int, h: int):
    y = np.empty((h, w), np.uint8)
    u = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
    v = np.empty_like(u)
    if lib.f101webp_vp8_yuv(body, len(body), w, h, y.ctypes.data,
                            u.ctypes.data, v.ctypes.data):
        raise ValueError("WebP: broken VP8 data")
    return y, u, v


def _webp_demux(data: bytes) -> _WebPDemux:
    if data[:4] != b"RIFF" or data[8:12] != b"WEBP" or len(data) < 20:
        raise ValueError("not a WebP")
    if data[12:16] not in (b"VP8 ", b"VP8L", b"VP8X"):
        raise ValueError("WebP: the first chunk is not VP8, VP8L or VP8X")
    dmux = _WebPDemux(data)
    dmux.parse()
    w, h = dmux.canvas
    if w * h > MAX_PIXELS:
        raise ValueError(f"WebP: {w}x{h} exceeds {MAX_PIXELS} pixels")
    return dmux


def decode_webp_yuv(data: bytes) -> tuple:
    """The Y, U and V planes of a lossy WebP's (first) frame, as libwebp's
    ``WebPDecodeYUV`` gives them for a still: Y of the frame's size, U
    and V of half its size rounded up. Raises ValueError for a lossless
    file or a broken one."""
    lib = _webp_lib()
    f = _webp_demux(data).frames[0]
    lossless, body, w, h, _ = _webp_payload(data, f)
    if lossless:
        raise ValueError("WebP: lossless, no Y/U/V planes")
    return _webp_vp8_planes(lib, body, w, h)


def decode_webp_rgb8(data: bytes) -> np.ndarray:
    """WebP bytes -> uint8 HxWx3, as PIL's ``Image.open(...).convert(
    "RGB")`` gives them: libwebp's animation decoder, which PIL opens every
    WebP with, puts the first frame on a canvas of the file's size cleared
    to transparent black, decoded with the default options (fancy
    upsampling, the loop filter) as non-premultiplied RGBA, and the alpha
    is then dropped. Lossy (VP8), lossless (VP8L), VP8X with ALPH (raw or
    lossless, each filter) and animations (their first frame, at its
    offset; the pixels around it black) decode; ICCP, EXIF and XMP are
    skipped. Raises ValueError wherever libwebp or PIL refuses the file
    (the demuxer's checks, a broken bitstream or alpha, too many pixels)."""
    lib = _webp_lib()
    dmux = _webp_demux(data)
    f = dmux.frames[0]
    lossless, body, w, h, alpha = _webp_payload(data, f)
    if lossless:
        argb = np.empty((h, w), np.uint32)
        if lib.f101webp_vp8l_argb(body, len(body), w, h, argb.ctypes.data):
            raise ValueError("WebP: broken VP8L data")
        rgb = np.stack([(argb >> s).astype(np.uint8) for s in (16, 8, 0)],
                       axis=2)
    else:
        y, u, v = _webp_vp8_planes(lib, body, w, h)
        if alpha is not None:
            plane = np.empty((h, w), np.uint8)
            if lib.f101webp_alpha(alpha, len(alpha), w, h, plane.ctypes.data):
                raise ValueError("WebP: broken ALPH data")
        rgb = np.empty((h, w, 3), np.uint8)
        lib.f101webp_yuv_rgb(y.ctypes.data, u.ctypes.data, v.ctypes.data, w,
                             h, rgb.ctypes.data, 3 * w)
    cw, ch = dmux.canvas
    if (f.x, f.y, w, h) == (0, 0, cw, ch):
        return rgb
    canvas = np.zeros((ch, cw, 3), np.uint8)
    canvas[f.y:f.y + h, f.x:f.x + w] = rgb
    return canvas


# ---------------------------------------------------------------------------
# the request decoder
# ---------------------------------------------------------------------------

def decode_image(data: bytes) -> np.ndarray:
    """Image bytes -> (H, W, 3) uint8 RGB, as PIL's ``Image.open(...)
    .convert("RGB")`` gives them (how the JAX package's server decodes an
    upload): PIL's opener walk (``openers.py``: each format's test of the
    first 16 bytes in ``Image.ID`` order, a header that fails falling
    through to the next, six formats tried on any bytes), then the load
    step of the format that opened. Decoded: PNG
    (:func:`decode_png_rgb8`), JPEG (:func:`decode_jpeg_rgb8` with
    ``strict``: a stream cut short or an arithmetic-coded scan past PIL's
    64 KiB read block raises where PIL's ``load()`` does), GIF
    (:func:`decode_gif_rgb8`), BMP (:func:`decode_bmp_rgb8`) and DIB,
    WebP (:func:`decode_webp_rgb8`), TIFF (:func:`decode_tiff_rgb8`),
    Netpbm, ICO, CUR and QOI (``rasters.py``), TGA, PCX, DCX, SGI, Sun
    raster, IM, IMT, IPTC, PhotoCD, SPIDER and PSD (``legacy.py``), and
    JPEG 2000 (``jpeg2000.py``). Raises
    :class:`UnsupportedImage` naming a format PIL decodes and the port
    does not (AVIF, XBM and the others of the walk), a variant it does
    not decode (HTJ2K, JPEG 2000 Part 2; YCbCr JPEG or old-style JPEG
    TIFF in separate planes; some IM modes), arithmetic lossless (SOF11)
    JPEG, or a codec that did not build here; ValueError for bytes no
    opener takes, a broken image, or one PIL refuses (12-bit and
    hierarchical JPEG, JBIG2, HEIC and PIL's stub formats among them)."""
    return open_image(data).load()


# the TIFF, Netpbm, ICO, CUR and QOI decoders and the walk (they use the
# codecs above)
from .tiff import decode_tiff_rgb8, tiff_lib  # noqa: E402
from .rasters import (decode_cur_rgb8, decode_ico_rgb8,  # noqa: E402
                      decode_netpbm_rgb8, decode_qoi_rgb8, is_netpbm)
from .openers import open_image  # noqa: E402
