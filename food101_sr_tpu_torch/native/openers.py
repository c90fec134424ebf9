"""PIL's ``Image.open`` walk, as the JAX package's server decodes uploads
(``Image.open(io.BytesIO(data)); img.load()``, then ``convert("RGB")``).

PIL tries its openers in ``Image.ID`` order. Each has a test of the first
16 bytes (six have none: IM, IMT, IPTC, PCD, SPIDER and TGA, which try
any bytes that reach them) and an ``_open`` that parses the header. When
``_open`` raises ``SyntaxError``, ``IndexError``, ``TypeError``,
``KeyError``, ``EOFError`` or ``struct.error`` (``ImageFile.__init__``
turns the last four into ``SyntaxError``; so does an opener that leaves
no mode or a size of zero), PIL goes on to the next opener; any other
exception ends the walk, and so does the decompression-bomb check after
an ``_open`` that succeeded. Then ``load()`` decodes, and any failure
there is the JAX server's 400.

Here each entry of :data:`OPENERS` is (name, accept, open): ``open(data)``
raises :class:`NotThisFormat` where PIL's ``_open`` falls through,
ValueError where it ends the walk, and otherwise returns an
:class:`Opened` (PIL's size, and the load step). The formats the port
decodes have their own open steps (``legacy.py``, ``rasters.py`` and
the decoders in ``__init__.py`` and ``tiff.py``, which raise
:class:`NotThisFormat` where PIL's ``_open`` would); a format PIL decodes
and the port does not is refused by name (:class:`UnsupportedImage`,
415) once its test takes the bytes, and PIL's stubs (BUFR, GRIB, HDF5,
WMF, EPS without Ghostscript) are 400 there. The order is Pillow 12.1's
full ``Image.ID``, as after ``Image.init()``.
"""
from __future__ import annotations

import struct

from . import (MAX_PIXELS, PNG_SIGNATURE, NotThisFormat, UnsupportedImage,
               decode_bmp_rgb8, decode_gif_rgb8, decode_jpeg_rgb8,
               decode_png_rgb8, decode_webp_rgb8, _jpeg_lib, legacy)
from .jpeg2000 import open_jpeg2000
from .legacy import Opened, _i16, _i32, pcx_accept
from .rasters import (decode_cur_rgb8, decode_ico_rgb8, decode_netpbm_rgb8,
                      decode_qoi_rgb8)
from .tiff import decode_tiff_rgb8, tiff_lib

# the formats PIL decodes and the port does not, by their ``Image.ID``
# names: each is a 415 naming it once its test takes the bytes
REFUSED = {"AVIF": "AVIF/HEIF", "BLP": "BLP", "DDS": "DDS", "FITS": "FITS",
           "FLI": "FLI", "FTEX": "FTEX", "GBR": "GBR",
           "ICNS": "ICNS", "MCIDAS": "McIdas",
           "MSP": "MSP", "PIXAR": "PIXAR", "XBM": "XBM",
           "XPM": "XPM", "XVTHUMB": "XV thumbnail"}


def _tried(fn, data: bytes):
    """An opener that decodes in its ``_open`` (the port's decoders that
    predate the walk): their pixels, after the bomb check they make."""
    px = fn(data)
    return Opened((px.shape[1], px.shape[0]), lambda: px)


def _refusing(key: str, checks=None):
    """The open step of a format of :data:`REFUSED`: 415 naming it, after
    ``checks`` (the header checks of PIL's ``_open`` that the port
    models) where given."""
    name = REFUSED[key]

    def open_(data):
        if checks is not None:
            checks(data)
        raise UnsupportedImage(f"{name} is not supported (the port decodes "
                               f"{DECODED} only)")
    return open_


def _stub(name: str):
    def open_(data):
        raise ValueError(f"{name}: PIL identifies it but has no decoder")
    return open_


# -- the accept tests (each plugin's ``_accept`` on the first 16 bytes) ----

def _avif(p):
    return p[4:8] == b"ftyp" and p[8:12] in (b"avif", b"avis", b"mif1",
                                             b"msf1")


def _dib(p):
    return len(p) >= 4 and _i32(p) in (12, 40, 52, 56, 64, 108, 124)


def _fli(p):
    return (len(p) >= 16 and _i16(p, 4) in (0xAF11, 0xAF12)
            and _i16(p, 14) in (0, 3))


def _gbr(p):
    return (len(p) >= 8 and _i32(p, 0, ">") >= 20
            and _i32(p, 4, ">") in (1, 2))


def _ppm(p):
    return len(p) >= 2 and p[:1] == b"P" and p[1] in b"0123456fy"


def _webp(p):
    return (p[:4] == b"RIFF" and p[8:12] == b"WEBP"
            and p[12:16] in (b"VP8 ", b"VP8X", b"VP8L"))


def _prefix(*magics):
    return lambda p: p.startswith(magics)


# -- open steps of accepted-only formats the port models ------------------

def _open_mpeg(data):
    """MpegImageFile._open: a 12-bit width and height after the start code
    (a zero one falls through); PIL cannot load the stream (400)."""
    bits = int.from_bytes(data[4:7].ljust(3, b"\xff"), "big")
    if len(data) < 7:  # BitStream reads -1 past the end
        bits = -1
    if (bits >> 12) <= 0 or (bits & 0xFFF) <= 0:
        raise NotThisFormat("MPEG: no size")
    raise ValueError("MPEG: PIL identifies the stream but cannot decode it")


def _mcidas_checks(data):
    """McIdasImageFile._open's checks."""
    s = data[:256]
    if len(s) != 256:
        raise NotThisFormat("not an McIdas area file")
    w = struct.unpack("!64i", s)
    if w[10] not in (1, 2, 4) or w[9] <= 0 or w[8] <= 0:
        raise NotThisFormat("unsupported McIdas format")


def _gbr_checks(data):
    """GbrImageFile._open's checks."""
    if len(data) < 20:
        raise NotThisFormat("GBR: short header")
    size, version, w, h, depth = struct.unpack_from(">5I", data)
    if size < 20 or version not in (1, 2) or w == 0 or h == 0 or \
            depth not in (1, 4):
        raise NotThisFormat("not a GIMP brush")
    if version == 2 and (data[20:24] != b"GIMP" or len(data) < 28):
        raise NotThisFormat("not a GIMP brush, bad magic number")


def _fli_checks(data):
    """FliImageFile._open's checks."""
    s = data[:128]
    if s[20:22] != bytes(2) or s[42:80] != bytes(38) or s[88:] != bytes(40):
        raise NotThisFormat("not an FLI/FLC file")
    if _i16(s, 8) == 0 or _i16(s, 10) == 0 or len(data) < 134:
        raise NotThisFormat("FLI: no size, or a short first chunk")


def _open_jpeg(data):
    _jpeg_lib()  # a codec that did not build stays 415, named
    try:
        return _tried(lambda d: decode_jpeg_rgb8(d, strict=True), data)
    except UnsupportedImage as e:
        if "SOF11" in str(e):  # no tool writes one: PIL's answer unknown
            raise
        raise ValueError(f"{e} (PIL refuses it too)") from None


def _open_tiff(data):
    tiff_lib()  # a unit that did not build stays 415, named
    return _tried(decode_tiff_rgb8, data)


def _open_qoi(data):
    tiff_lib()
    return _tried(decode_qoi_rgb8, data)


def _open_bmp(data):
    if len(data) < 18:  # struct.error reading the offset or header size
        raise NotThisFormat("BMP: truncated header")
    return _tried(decode_bmp_rgb8, data)


DECODED = ("PNG, JPEG, GIF, BMP, DIB, WebP, TIFF, Netpbm, ICO, CUR, QOI, "
           "TGA, PCX, DCX, SGI, Sun raster, IM, IMT, IPTC, PhotoCD, "
           "SPIDER, PSD and JPEG 2000")

# name, accept (None: no test), open
OPENERS: tuple = (
    ("AVIF", _avif, _refusing("AVIF")),
    ("BLP", _prefix(b"BLP1", b"BLP2"), _refusing("BLP")),
    ("BMP", _prefix(b"BM"), _open_bmp),
    ("DIB", _dib, legacy.open_dib),
    ("BUFR", _prefix(b"BUFR", b"ZCZC"), _stub("BUFR")),
    ("CUR", _prefix(b"\x00\x00\x02\x00"),
     lambda d: _tried(decode_cur_rgb8, d)),
    ("PCX", pcx_accept, legacy.open_pcx),
    ("DCX", lambda p: len(p) >= 4 and _i32(p) == 987654321,
     legacy.open_dcx),
    ("DDS", _prefix(b"DDS "), _refusing("DDS")),
    ("EPS", lambda p: p.startswith(b"%!PS") or (
        len(p) >= 4 and _i32(p) == 0xC6D3D0C5), _stub("EPS")),
    ("FITS", _prefix(b"SIMPLE"), _refusing("FITS")),
    ("FLI", _fli, _refusing("FLI", _fli_checks)),
    ("FTEX", _prefix(b"FTEX"), _refusing("FTEX")),
    ("GBR", _gbr, _refusing("GBR", _gbr_checks)),
    ("GIF", _prefix(b"GIF87a", b"GIF89a"),
     lambda d: _tried(decode_gif_rgb8, d)),
    ("GRIB", lambda p: len(p) >= 8 and p.startswith(b"GRIB") and p[7] == 1,
     _stub("GRIB")),
    ("HDF5", _prefix(b"\x89HDF\r\n\x1a\n"), _stub("HDF5")),
    ("PNG", _prefix(PNG_SIGNATURE), lambda d: _tried(decode_png_rgb8, d)),
    ("JPEG2000", _prefix(b"\xffO\xffQ", b"\x00\x00\x00\x0cjP  \r\n\x87\n"),
     open_jpeg2000),
    ("ICNS", _prefix(b"icns"), _refusing("ICNS")),
    ("ICO", _prefix(b"\x00\x00\x01\x00"),
     lambda d: _tried(decode_ico_rgb8, d)),
    ("IM", None, legacy.open_im),
    ("IMT", None, legacy.open_imt),
    ("IPTC", None, legacy.open_iptc),
    ("JPEG", _prefix(b"\xff\xd8\xff"), _open_jpeg),
    ("MCIDAS", _prefix(b"\x00\x00\x00\x00\x00\x00\x00\x04"),
     _refusing("MCIDAS", _mcidas_checks)),
    ("MPEG", _prefix(b"\x00\x00\x01\xb3"), _open_mpeg),
    ("TIFF", _prefix(b"MM\x00*", b"II*\x00", b"MM*\x00", b"II\x00*",
                     b"MM\x00+", b"II+\x00"), _open_tiff),
    ("MSP", _prefix(b"DanM", b"LinS"), _refusing("MSP")),
    ("PCD", None, legacy.open_pcd),
    ("PIXAR", _prefix(b"\x80\xe8\x00\x00"), _refusing("PIXAR")),
    ("PPM", _ppm, lambda d: _tried(decode_netpbm_rgb8, d)),
    ("PSD", _prefix(b"8BPS"), legacy.open_psd),
    ("QOI", _prefix(b"qoif"), _open_qoi),
    ("SGI", lambda p: len(p) >= 2 and _i16(p, 0, ">") == 474,
     legacy.open_sgi),
    ("SPIDER", None, legacy.open_spider),
    ("SUN", lambda p: len(p) >= 4 and _i32(p, 0, ">") == 0x59A66A95,
     legacy.open_sun),
    ("TGA", None, legacy.open_tga),
    ("WEBP", _webp, lambda d: _tried(decode_webp_rgb8, d)),
    ("WMF", _prefix(b"\xd7\xcd\xc6\x9a\x00\x00", b"\x01\x00\x00\x00"),
     _stub("WMF")),
    ("XBM", lambda p: p.lstrip().startswith(b"#define"), _refusing("XBM")),
    ("XPM", _prefix(b"/* XPM */"), _refusing("XPM")),
    ("XVTHUMB", _prefix(b"P7 332"), _refusing("XVTHUMB")),
)

def open_image(data: bytes) -> Opened:
    """The first opener, in ``Image.ID`` order, whose test takes
    ``data[:16]`` and whose open step does not fall through, with PIL's
    bomb check after it. Raises ValueError where no opener takes the bytes
    (PIL's ``UnidentifiedImageError``) or one ends the walk,
    :class:`UnsupportedImage` naming a format the port does not decode."""
    prefix = data[:16]
    why = []  # what the openers whose test took the bytes said
    for name, accept, open_ in OPENERS:
        try:
            if accept is not None and not accept(prefix):
                continue
            got = open_(data)
        except (NotThisFormat, struct.error, IndexError) as e:
            if accept is not None:  # a header read past the data falls
                why.append(str(e))  # through too
            continue
        w, h = got.size
        if max(1, w) * max(1, h) > MAX_PIXELS:
            raise ValueError(f"{name}: {w}x{h} exceeds {MAX_PIXELS} pixels "
                             "(PIL's decompression-bomb limit)")
        return got
    raise ValueError("not an image PIL identifies" + (
        f" ({'; '.join(why)})" if why else f" (the port decodes {DECODED})"))
