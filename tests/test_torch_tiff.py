"""The port's TIFF decoder (food101_sr_tpu_torch/native/tiff.py, the
PackBits, LZW, CCITT and ThunderScan decoders of native/fast_tiff.cpp, the
ZSTD decoder of native/fast_zstd.cpp) against PIL,
which the JAX package's server decodes uploads with (Pillow 12.1: its own
raw decoder for uncompressed files, libtiff 4.7 for the rest): every
committed stream pixel-equal to PIL live and to its golden; every
(photometric, sample format, fill order, bits, extra samples) key of
PIL's pixel table in both byte orders, uncompressed and compressed, in
strips, tiles and separate planes; each compression, both predictors,
BigTIFF, the Orientation tag; JPEG strips and tiles with YCbCr
subsampling and shared tables; CCITT at odd widths; YCbCr through
libtiff's RGBA reader; ZSTD strips as libtiff reads them through libzstd,
raw-16 rows, ThunderScan codes and old-style JPEG in each layout libtiff
reads; the compressions PIL refuses refused as on the JAX
server; seeded truncations and bit flips refused exactly where PIL refuses
them; TIFF uploads answered alike by the port's and the JAX package's
servers; and a .tif through the port's predict."""
import io
import json
import lzma
import struct
import sys
import threading
import time
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401
from PIL import Image, TiffImagePlugin

from food101_sr_tpu_torch import native, predict, serve
from food101_sr_tpu_torch.native import tiff as port_tiff
from food101_sr_tpu_torch.serving import SRServer

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import serve as jax_serve  # noqa: E402
from chip_smoke import sha256  # noqa: E402
from tools.raster_writers import (jpeg_strip, jpeg_tables, lzw,  # noqa: E402
                                  ojpeg, packbits, pil_tiff, raw16,
                                  thunderscan, tiff_file, tiff_image, zstd)

JPEG_ASSETS = ROOT / "food101_sr_tpu_torch" / "assets" / "jpeg"
ALL = json.loads((JPEG_ASSETS / "goldens.json").read_text())
GOLDENS = ALL["streams"]
TIFF = sorted(n for n, g in GOLDENS.items() if g["file"].endswith(".tif"))
ASSET = ROOT / "food101_sr_tpu_torch" / "assets" / "winner_srcnn.pth"
CHECKPOINT = ROOT / "weights" / "winner_srcnn_best"


def _outcome(fn, data):
    """fn's pixels, "415", or "raises" (PIL's and the port's errors differ
    in kind; the HTTP status, 400, is what they share)."""
    try:
        return np.asarray(fn(data))
    except native.UnsupportedImage:
        return "415"
    except Exception:  # PIL raises OSError, ValueError, EOFError, ...
        return "raises"


def _pil(data):
    return _outcome(lambda d: Image.open(io.BytesIO(d)).convert("RGB"), data)


def _same_as_pil(data, pixels=True) -> bool:
    a, b = _pil(data), _outcome(native.decode_image, data)
    if isinstance(a, str) or isinstance(b, str) or not pixels:
        return (a if isinstance(a, str) else "px") == \
            (b if isinstance(b, str) else "px")
    return a.shape == b.shape and np.array_equal(a, b)


def _photo(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(xx / 5.0 + c) * 60 + np.cos(yy / 7.0 - c) * 50
                     + 128 for c in range(3)], 2)
    return np.clip(base + rng.normal(0, 10, (h, w, 3)), 0, 255).astype(
        np.uint8)


# --- the committed streams ---

@pytest.mark.parametrize("name", TIFF)
def test_committed_stream_matches_pil_and_its_golden(name):
    g = GOLDENS[name]
    data = (JPEG_ASSETS / g["file"]).read_bytes()
    px = native.decode_image(data)
    assert list(px.shape) == g["shape"] and sha256(px) == g["served_sha256"]
    assert np.array_equal(px, _pil(data))


def test_the_zstd_stream_is_refused_by_name():
    """The streams the port once refused by name decode now, among the
    committed streams above: the ZSTD one and the CIELab one (PIL's
    LittleCMS Lab -> sRGB, written out in native/cielab.py); the goldens
    list no refusal any more."""
    assert "port_refused" not in ALL
    for name in ("tiff_zstd", "tiff_cielab"):
        g = GOLDENS[name]
        data = (JPEG_ASSETS / g["file"]).read_bytes()
        px = native.decode_image(data)
        assert sha256(px) == sha256(_pil(data)) == g["served_sha256"]


# --- PIL's pixel table: every key, both byte orders ---

def _samples(key, h, w, rng):
    _, photo, fmt, _, bps, _ = key
    b = bps[0]
    if fmt == (3,):
        return rng.normal(100, 120, (h, w, len(bps))).astype(np.float32)
    if fmt == (2,):
        return rng.integers(-(1 << (b - 1)), 1 << (b - 1), (h, w, len(bps)))
    return rng.integers(0, 1 << b, (h, w, len(bps)))


KEYS = [k for k, (mode, _) in port_tiff.OPEN_INFO.items() if mode != "LAB"]


def _key_id(k):
    bo, photo, fmt, fill, bps, extra = k
    return (f"{bo.decode()}-p{photo}-f{fmt[0]}-o{fill}-"
            f"{'.'.join(map(str, bps))}-x{''.join(map(str, extra))}")


@pytest.mark.parametrize("key", KEYS, ids=_key_id)
def test_every_pixel_table_key_matches_pil(key):
    """Each key uncompressed (PIL's raw decoder: strips, tiles, one band a
    layer for PlanarConfiguration 2) and Deflate- and LZW-compressed
    (libtiff and PIL's TiffDecode: its planes copied per band byte, its
    fill-order-1 raw mode). Keys PIL names but cannot read (raw modes it
    has no unpacker for, separate planes its strip reader refuses) are
    refused where PIL refuses them. A palette image gets a random 16-bit
    ColorMap (PIL keeps each entry's high byte)."""
    bo, photo, fmt, fill, bps, extra = key
    rng = np.random.default_rng(zlib.crc32(_key_id(key).encode()))
    s = _samples(key, 13, 21, rng)
    cmap = rng.integers(0, 65536, 3 * (1 << bps[0])) if photo == 3 else None
    for comp in (1, 8, 5):
        for layout in ({"rows_per_strip": 5}, {"tile": (16, 16)},
                       {"rows_per_strip": 5, "planar": 2},
                       {"tile": (16, 16), "planar": 2}):
            data = tiff_image(s, bps, photo, order="<" if bo == b"II" else ">",
                              compression=comp, fillorder=fill,
                              sampleformat=fmt[0], extra=extra,
                              colormap=cmap, **layout)
            assert _same_as_pil(data), (comp, layout)


def test_cielab_is_refused_by_name():
    """PIL converts LAB to RGB through LittleCMS; the port's conversion
    (native/cielab.py) gives its pixels, in both byte orders and
    compressed, instead of the 415 naming CIELab it answered before."""
    lab = np.random.default_rng(3).integers(0, 256, (6, 7, 3))
    for kw in ({}, {"order": ">"}, {"compression": 8}):
        data = tiff_image(lab, 8, 8, **kw)
        assert isinstance(_pil(data), np.ndarray)
        assert np.array_equal(native.decode_image(data), _pil(data))


# --- compressions, predictors, layouts ---

@pytest.mark.parametrize("comp", [1, 32773, 5, 8, 32946, 34925],
                         ids=["none", "packbits", "lzw", "deflate",
                              "deflate32946", "lzma"])
@pytest.mark.parametrize("order", ["<", ">"], ids=["II", "MM"])
def test_compressions_strips_tiles_planes(comp, order):
    """RGB, 16-bit gray and a 4-bit palette in strips of several sizes,
    in tiles with cropped edges, in separate planes, and BigTIFF."""
    rng = np.random.default_rng(comp)
    rgb = _photo(37, 45, comp)
    g16 = rng.integers(0, 65536, (37, 45, 1))
    pal = rng.integers(0, 16, (37, 45, 1))
    cmap = rng.integers(0, 65536, 48)
    for layout in ({"rows_per_strip": 1}, {"rows_per_strip": 8},
                   {"rows_per_strip": 100}, {"tile": (16, 32)},
                   {"tile": (48, 48)}, {"rows_per_strip": 8, "planar": 2},
                   {"rows_per_strip": 8, "big": True}):
        for s, bits, photo, kw in ((rgb, 8, 2, {}), (g16, 16, 1, {}),
                                   (pal, 4, 3, {"colormap": cmap})):
            data = tiff_image(s, bits, photo, order=order, compression=comp,
                              **layout, **kw)
            assert _same_as_pil(data), (layout, bits)


@pytest.mark.parametrize("comp", [5, 8, 34925], ids=["lzw", "deflate",
                                                     "lzma"])
@pytest.mark.parametrize("order", ["<", ">"], ids=["II", "MM"])
def test_predictors(comp, order):
    """Horizontal differencing of 8-, 16- and 32-bit samples (contiguous
    and in planes; libtiff accumulates in native order) and the
    floating-point predictor (bytes split into planes, most significant
    first) on float32."""
    rng = np.random.default_rng(comp + len(order))
    cases = [(_photo(29, 33, 1), 8, 2, 1, {}),
             (_photo(29, 33, 2), 8, 2, 1, {"planar": 2}),
             (rng.integers(0, 65536, (29, 33, 3)), 16, 2, 1, {}),
             (rng.integers(0, 65536, (29, 33, 1)), 16, 1, 1,
              {"tile": (16, 16)}),
             (rng.integers(-2 ** 31, 2 ** 31, (29, 33, 1)), 32, 1, 2, {})]
    for s, bits, photo, fmt, kw in cases:
        data = tiff_image(s, bits, photo, order=order, compression=comp,
                          predictor=2, sampleformat=fmt, rows_per_strip=8,
                          **kw)
        assert _same_as_pil(data), (bits, kw)
    f = rng.normal(50, 80, (29, 33, 1)).astype(np.float32)
    for kw in ({"rows_per_strip": 8}, {"tile": (16, 32)}):
        data = tiff_image(f, 32, 1, order=order, compression=comp,
                          predictor=3, sampleformat=3, **kw)
        assert _same_as_pil(data), kw


def test_fill_order_2_and_orientation():
    """FillOrder 2: PIL's reversed raw modes uncompressed, libtiff's bit
    reversal of compressed data; Orientation 1-8 (ImageOps.exif_transpose
    after the load, on both paths)."""
    rng = np.random.default_rng(5)
    for bits, photo in ((1, 0), (4, 1), (8, 1)):
        s = rng.integers(0, 1 << bits, (19, 27, 1))
        for comp in (1, 5, 8, 32773):
            assert _same_as_pil(tiff_image(s, bits, photo, compression=comp,
                                           fillorder=2, rows_per_strip=6))
    img = _photo(14, 23, 4)
    for o in range(1, 9):
        for comp in (1, 5):
            data = tiff_image(img, 8, 2, compression=comp,
                              extra_tags={274: (3, (o,))})
            assert _same_as_pil(data), (o, comp)


def test_pil_written_files():
    """What PIL's own writer makes (libtiff for the compressed ones): each
    mode and compression it writes."""
    img = Image.fromarray(_photo(21, 30, 6))
    for mode in ("1", "L", "P", "RGB", "RGBA", "CMYK", "I;16", "I", "F",
                 "LA"):
        im = img.convert(mode) if mode not in ("I;16", "I", "F") else \
            img.convert("L").convert(mode)
        for comp in (None, "tiff_lzw", "packbits", "tiff_adobe_deflate",
                     "lzma"):
            assert _same_as_pil(pil_tiff(im, compression=comp)), (mode, comp)
    assert _same_as_pil(pil_tiff(img, compression="jpeg", quality=90))
    assert _same_as_pil(pil_tiff(img.convert("YCbCr"), compression="jpeg"))


def test_misordered_headers_and_multipage():
    """PIL's TIFF plugin also accepts 'II\\0*' (classic little-endian) and
    serves the first page of a multi-page file."""
    img = _photo(9, 12, 7)
    data = tiff_image(img, 8, 2)
    assert _same_as_pil(b"II\x00*" + data[4:])
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "TIFF", save_all=True, append_images=[
        Image.fromarray(img[::-1])])
    assert np.array_equal(native.decode_image(buf.getvalue()), img)


# --- JPEG ---

@pytest.mark.parametrize("sub,factors", [(0, (1, 1)), (1, (2, 1)),
                                         (2, (2, 2))],
                         ids=["444", "422", "420"])
def test_jpeg_strips_and_tiles(sub, factors):
    """libtiff's JPEG codec in RGB mode (JPEGCOLORMODE_RGB: libjpeg's
    YCbCr conversion and fancy upsampling) on strips with a short last
    one and on tiles with cropped edges; one set of tables shared through
    JPEGTables; a frame whose sampling disagrees with YCbCrSubSampling
    refused as libtiff refuses it."""
    img = _photo(37, 45, sub)
    for layout in ({"rows_per_strip": 16}, {"tile": (32, 32)}):
        data = tiff_image(img, 8, 6, compression=7,
                          chunk_codec=jpeg_strip(sub),
                          extra_tags={530: (3, factors)}, **layout)
        assert _same_as_pil(data), layout
    strips = [jpeg_strip(sub)(img[y:y + 16]) for y in range(0, 37, 16)]
    tables, short = jpeg_tables(strips)
    tags = {256: (4, (45,)), 257: (4, (37,)), 258: (3, (8, 8, 8)),
            259: (3, (7,)), 262: (3, (6,)), 277: (3, (3,)),
            278: (4, (16,)), 284: (3, (1,)), 347: (7, tables),
            530: (3, factors)}
    assert _same_as_pil(tiff_file(tags, short))
    wrong = (1, 2) if factors != (1, 2) else (2, 2)
    data = tiff_file({**tags, 530: (3, wrong)}, short)
    assert _pil(data) == "raises" and _outcome(native.decode_image,
                                               data) == "raises"


# --- CCITT ---

def _bilevel(h, w, seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.random((h, w)) > 0.5
    img = np.zeros((h, w), bool)  # text-like: strokes and blocks
    for _ in range(max(1, h * w // 400)):
        y, x = rng.integers(0, h), rng.integers(0, w)
        img[y:y + rng.integers(1, 4), x:x + rng.integers(2, 40)] = True
    return img


@pytest.mark.parametrize("comp", ["group3", "group3_2d", "group4",
                                  "tiff_ccitt"])
def test_ccitt_at_odd_widths(comp):
    """PIL's libtiff writer: T.4 1-D and 2-D, T.6 and Modified Huffman,
    random and text-like bilevel images at odd widths (one past 2560, for
    the extended make-up codes), one strip and several; then the same
    strips with FillOrder 2 (the bits of each byte reversed)."""
    info = {292: 1} if comp == "group3_2d" else {}
    pil_comp = comp.replace("_2d", "")
    for h, w, kind in ((17, 13, "random"), (40, 61, "random"),
                       (33, 97, "text"), (6, 2700, "text"),
                       (5, 1900, "random")):
        im = Image.fromarray(_bilevel(h, w, h * w, kind).astype(np.uint8)
                             * 255).convert("1")
        for rows in (h, 4):
            old = TiffImagePlugin.STRIP_SIZE
            TiffImagePlugin.STRIP_SIZE = rows * ((w + 7) // 8)
            try:
                data = pil_tiff(im, compression=pil_comp, tiffinfo=info)
            finally:
                TiffImagePlugin.STRIP_SIZE = old
            assert _same_as_pil(data), (h, w, kind, rows)
            t = Image.open(io.BytesIO(data)).tag_v2
            offs, cnts = t[273], t[279]
            rev = bytearray(data)
            for o, c in zip(offs, cnts):
                rev[o:o + c] = port_tiff._REV[np.frombuffer(
                    data[o:o + c], np.uint8)].tobytes()
            # FillOrder is inline: patch its value in the directory
            rev = bytes(rev)
            entry = b"\x0a\x01\x03\x00\x01\x00\x00\x00\x01\x00"
            if entry in rev:
                rev = rev.replace(entry, entry[:-2] + b"\x02\x00", 1)
                assert _same_as_pil(rev), (h, w, kind, rows, "fill 2")


def test_bilevel_photometric_and_tiles():
    """A BlackIsZero CCITT image (libtiff's bits taken as PIL's '1'), and
    PackBits bilevel tiles."""
    img = _bilevel(30, 50, 1, "text")
    im = Image.fromarray(img.astype(np.uint8) * 255).convert("1")
    data = pil_tiff(im, compression="group4")
    patched = data.replace(b"\x06\x01\x03\x00\x01\x00\x00\x00\x01\x00",
                           b"\x06\x01\x03\x00\x01\x00\x00\x00\x00\x00", 1)
    assert _same_as_pil(data) and _same_as_pil(patched)
    s = img[..., None].astype(np.uint8)
    assert _same_as_pil(tiff_image(s, 1, 0, compression=32773,
                                   tile=(16, 16)))


# --- YCbCr through libtiff's RGBA reader ---

@pytest.mark.parametrize("hs,vs", [(1, 1), (2, 1), (2, 2), (4, 1), (4, 2),
                                   (4, 4), (1, 2), (1, 4)])
def test_ycbcr_rgba_reader(hs, vs):
    """A YCbCr TIFF not JPEG-coded: libtiff's packed blocks (hs x vs Y, then
    Cb and Cr) and TIFFYCbCrtoRGB, at sizes that cut blocks; subsamplings
    its reader has no routine for refused where PIL refuses them; 1x1 in
    separate planes."""
    rng = np.random.default_rng(hs * 10 + vs)
    for h, w, rows in ((13, 19, 4), (16, 16, 16)):
        chunks = []
        for y in range(0, h, rows):
            n = min(rows, h - y)
            blocks = -(-w // hs) * -(-n // vs) * (hs * vs + 2)
            chunks.append(lzw(rng.integers(0, 256, blocks,
                                           np.uint8).tobytes()))
        data = tiff_file({256: (4, (w,)), 257: (4, (h,)),
                          258: (3, (8, 8, 8)), 259: (3, (5,)),
                          262: (3, (6,)), 277: (3, (3,)),
                          278: (4, (rows,)), 284: (3, (1,)),
                          530: (3, (hs, vs))}, chunks)
        assert _same_as_pil(data), (h, w)
    ycc = rng.integers(0, 256, (13, 19, 3))
    for comp in (5, 8):
        data = tiff_image(ycc, 8, 6, compression=comp, planar=2,
                          rows_per_strip=5,
                          extra_tags={530: (3, (hs, vs))})
        assert _same_as_pil(data)


# --- refusals ---

@pytest.mark.parametrize("comp,name,status", [
    (6, "old-style JPEG", "raises"), (32771, "raw-16", "raises"),
    (32809, "ThunderScan", "raises"), (50000, "ZSTD", "raises"),
    (34676, "SGILog", "raises"), (34677, "SGILog24", "raises"),
    (50001, "WebP", "raises"), (32766, None, "raises")])
def test_compressions_the_port_refuses(comp, name, status):
    """Uncompressed 8-bit RGB strips under another compression's tag: the
    port decodes ZSTD, old-style JPEG, ThunderScan and raw-16 as PIL's
    libtiff does, so these bytes fail on both servers (400), none is a 415.
    PIL's libtiff is built without WebP and refuses SGILog under every
    photometric PIL opens, so those are 400 on both servers, as is a
    compression PIL does not know."""
    data = tiff_image(_photo(8, 8, 1), 8, 2,
                      extra_tags={259: (3, (comp,))})
    got = _outcome(native.decode_image, data)
    assert got == status, name
    assert _pil(data) == "raises"


# --- truncations and bit flips ---

def _ccitt(compression, info=None):
    im = Image.fromarray(_bilevel(40, 61, 3, "random").astype(np.uint8)
                         * 255).convert("1")
    old = TiffImagePlugin.STRIP_SIZE
    TiffImagePlugin.STRIP_SIZE = 64
    try:
        return pil_tiff(im, compression=compression, tiffinfo=info or {})
    finally:
        TiffImagePlugin.STRIP_SIZE = old


def _gray4(img):
    return np.asarray(Image.fromarray(img).convert("L")) >> 4


@pytest.mark.parametrize("kind", ["raw", "raw_tiles", "lzw", "packbits",
                                  "deflate_tiles", "lzma", "jpeg", "g3",
                                  "g3_2d", "g4", "mh", "zstd", "zstd_pred2",
                                  "raw16", "thunderscan", "ojpeg_jif",
                                  "ojpeg_header", "ojpeg_tables"])
def test_truncations_and_bit_flips_refused_where_pil_refuses(kind):
    """Seeded cuts and bit flips (the strips and the directory): the port
    raises ValueError exactly where PIL raises, never crashes, and decodes
    the rest to PIL's pixels. Pixels are compared where the flips left the
    directory alone: a directory that disagrees with the strips (a width
    past a JPEG strip's) leaves bytes of PIL's buffer unwritten, which
    hold what its allocator gave it. CCITT is held to PIL's outcome only:
    after a strip with corrupt codes libtiff 4.7 decodes the following
    strips of the file otherwise than it decodes them alone, which the
    port (each strip on its own) does not reproduce."""
    img = _photo(29, 35, 8)
    data = {
        "raw": lambda: tiff_image(img, 8, 2, rows_per_strip=8),
        "raw_tiles": lambda: tiff_image(img, 8, 2, tile=(16, 16)),
        "lzw": lambda: tiff_image(img, 8, 2, compression=5, predictor=2,
                                  rows_per_strip=8),
        "packbits": lambda: tiff_image(img // 64 * 64, 8, 2,
                                       compression=32773, rows_per_strip=8),
        "deflate_tiles": lambda: tiff_image(img, 8, 2, compression=8,
                                            tile=(16, 16)),
        "lzma": lambda: tiff_image(img, 8, 2, compression=34925,
                                   rows_per_strip=8),
        "jpeg": lambda: tiff_image(img, 8, 6, compression=7,
                                   chunk_codec=jpeg_strip(2),
                                   rows_per_strip=16,
                                   extra_tags={530: (3, (2, 2))}),
        "g3": lambda: _ccitt("group3"),
        "g3_2d": lambda: _ccitt("group3", {292: 1}),
        "g4": lambda: _ccitt("group4"),
        "mh": lambda: _ccitt("tiff_ccitt"),
        "zstd": lambda: tiff_image(img, 8, 2, compression=50000,
                                   rows_per_strip=8),
        "zstd_pred2": lambda: tiff_image(img, 8, 2, compression=50000,
                                         predictor=2, rows_per_strip=8),
        "raw16": lambda: _raw16_file(Image.fromarray(img).convert("1"), 8),
        "thunderscan": lambda: _thunder_file(_gray4(img), 8),
        "ojpeg_jif": lambda: ojpeg(img, "jif", 2),
        "ojpeg_header": lambda: ojpeg(img, "jif_header", 2,
                                      rows_per_strip=16),
        "ojpeg_tables": lambda: ojpeg(img, "tables", 1,
                                      rows_per_strip=8)}[kind]()
    ccitt = kind in ("g3", "g3_2d", "g4", "mh")
    directory = int.from_bytes(data[4:8], "little")  # after the strips
    rng = np.random.default_rng(len(kind))
    refused = 0
    for k in range(100):
        b = bytearray(data)
        if k % 4 == 0:
            b = b[:int(rng.integers(1, len(b)))]
        elif k % 4 == 1:
            b[int(rng.integers(0, min(len(b), 200)))] ^= \
                1 << int(rng.integers(0, 8))
        else:
            for _ in range(1 + k % 3):
                b[int(rng.integers(8, len(b)))] ^= 1 << int(rng.integers(0, 8))
        intact = all(b[i] == data[i] for i in range(directory, len(b)))
        assert _same_as_pil(bytes(b), intact and not ccitt), k
        got = _outcome(native.decode_image, bytes(b))
        assert not (isinstance(got, str) and got == "415"), k
        refused += isinstance(got, str)
    # Deflate's checksum fails every flip of its data; raw strips decode
    # most flips
    assert refused > 0 and (kind not in ("raw", "raw_tiles") or refused < 100)


@pytest.mark.parametrize("comp", ["group3", "group4", "tiff_ccitt"])
def test_ccitt_strips_cut_short_as_libtiff_ends_them(comp):
    """A strip whose byte count is cut at every length: libtiff 4.7 fails
    a Modified Huffman strip that ends early, decodes what a T.4 1-D strip
    holds, and a T.6 strip once a row is whole; the port refuses exactly
    the same cuts. T.4 (1-D and 2-D) is held pixel for pixel, its later
    strips included, by test_t4_strips_cut_short_decode_as_libtiff; T.6
    pixels are not held: a T.6 strip that ends early leaves rows of PIL's
    buffer unwritten, which hold what its allocator gave it."""
    im = Image.fromarray(_bilevel(24, 45, 4, "random").astype(np.uint8)
                         * 255).convert("1")
    old = TiffImagePlugin.STRIP_SIZE
    TiffImagePlugin.STRIP_SIZE = 8 * 6
    try:
        data = pil_tiff(im, compression=comp)
    finally:
        TiffImagePlugin.STRIP_SIZE = old
    counts = Image.open(io.BytesIO(data)).tag_v2[279]
    packed = struct.pack(f"<{len(counts)}L", *counts)
    at = data.index(packed)
    for n in range(1, counts[0] + 1):
        cut = struct.pack(f"<{len(counts)}L", n, *counts[1:])
        assert _same_as_pil(data[:at] + cut + data[at + len(packed):],
                            pixels=False), n


def _strip_counts_cut(data, strip, n):
    """``data`` with the byte count of ``strip`` set to ``n``."""
    counts = Image.open(io.BytesIO(data)).tag_v2[279]
    packed = struct.pack(f"<{len(counts)}L", *counts)
    at = data.index(packed)
    cut = list(counts)
    cut[strip] = n
    return data[:at] + struct.pack(f"<{len(cut)}L", *cut) + \
        data[at + len(packed):], counts[strip]


@pytest.mark.parametrize("twod", [False, True], ids=["1d", "2d"])
@pytest.mark.parametrize("h, w, seed, kind, rows", [
    (9, 77, 9, "text", 9), (10, 40, 310, "random", 10),
    (24, 45, 24, "random", 6)])
def test_t4_strips_cut_short_decode_as_libtiff(twod, h, w, seed, kind, rows):
    """A T.4 strip cut at every length, the first and (in a file of
    several) the second, decodes to PIL's pixels or fails where PIL fails.
    libtiff 4.7 fails T.4 data that ends early, but where it ends looking
    for an EOL's 1 it decodes the strip again from its start as data
    without EOLs, from that row on and for the later strips of the file;
    a 2-D row may read the run array past the previous row's runs, which
    keeps what earlier rows wrote there."""
    im = Image.fromarray(_bilevel(h, w, seed, kind).astype(np.uint8)
                         * 255).convert("1")
    old = TiffImagePlugin.STRIP_SIZE
    TiffImagePlugin.STRIP_SIZE = rows * ((w + 7) // 8)
    try:
        data = pil_tiff(im, compression="group3",
                        tiffinfo={292: 1} if twod else {})
    finally:
        TiffImagePlugin.STRIP_SIZE = old
    for strip in (0, 1) if rows < h else (0,):
        full = _strip_counts_cut(data, strip, 1)[1]
        for n in range(1, full + 1):
            assert _same_as_pil(_strip_counts_cut(data, strip, n)[0]), \
                (strip, n)


@pytest.mark.parametrize("comp, info", [
    ("group3", {}), ("group3", {292: 1}), ("tiff_ccitt", {})],
    ids=["g3", "g3_2d", "mh"])
def test_ccitt_bit_flips_decode_to_pils_pixels(comp, info):
    """Seeded bit flips in the strips of a CCITT file of several strips:
    the port fails where PIL fails and decodes the rest to PIL's pixels,
    the strips after a corrupt one included (the T.4 mode without EOLs
    and the run arrays carry over). T.6 is not held: a T.6 strip that ends
    early leaves rows of PIL's buffer unwritten (its allocator's bytes)."""
    for h, w, kind, rows in ((40, 61, "random", 8), (33, 97, "text", 11)):
        im = Image.fromarray(_bilevel(h, w, h * w, kind).astype(np.uint8)
                             * 255).convert("1")
        old = TiffImagePlugin.STRIP_SIZE
        TiffImagePlugin.STRIP_SIZE = rows * ((w + 7) // 8)
        try:
            data = pil_tiff(im, compression=comp, tiffinfo=info)
        finally:
            TiffImagePlugin.STRIP_SIZE = old
        t = Image.open(io.BytesIO(data)).tag_v2
        lo, hi = min(t[273]), max(o + c for o, c in zip(t[273], t[279]))
        rng = np.random.default_rng(h)
        for k in range(40):
            b = bytearray(data)
            for _ in range(1 + k % 3):
                b[int(rng.integers(lo, hi))] ^= 1 << int(rng.integers(0, 8))
            assert _same_as_pil(bytes(b)), (h, k)


def _entry(data, tag):
    """The byte position of ``tag``'s entry in the first directory of a
    little-endian TIFF."""
    off = struct.unpack_from("<I", data, 4)[0]
    for i in range(struct.unpack_from("<H", data, off)[0]):
        if struct.unpack_from("<H", data, off + 2 + 12 * i)[0] == tag:
            return off + 2 + 12 * i
    raise KeyError(tag)


def _patched(data, tag, *, count=None, value=None, new_tag=None):
    b = bytearray(data)
    at = _entry(data, tag)
    if count is not None:
        struct.pack_into("<I", b, at + 4, count)
    if value is not None:
        struct.pack_into("<H", b, at + 8, value)
    if new_tag is not None:
        struct.pack_into("<H", b, at, new_tag)
    return bytes(b)


def _corrupt_directory(case):
    """One seeded TIFF whose directory PIL and libtiff read differently."""
    img = _photo(16, 20, 11)
    huge = 0x40000001  # a value past the end of the file
    if case == "huge count, planes":
        # PIL's parse stops at the Photometric entry: its mode is L, read
        # from the first of libtiff's three planes
        return _patched(tiff_image(img, 8, 2, compression=8, planar=2,
                                   rows_per_strip=5), 262, count=huge)
    if case == "huge count, YCbCr":
        # PIL's parse stops at StripOffsets: it unpacks libtiff's RGBA
        # rows as L
        return _patched(tiff_image(img, 8, 6, compression=8,
                                   rows_per_strip=5), 273, count=huge)
    if case == "huge count, sample format":
        # PIL never reads SampleFormat 7; libtiff refuses the directory
        return _patched(tiff_image(img, 8, 2, compression=5,
                                   rows_per_strip=8, extra_tags={
                                       305: (1, (1, 2, 3, 4, 5)),
                                       339: (3, (7,) * 3)}), 305, count=huge)
    if case == "height past the strips":
        # libtiff pads StripOffsets with zeros: the RGBA reader's second
        # call cannot read its strip before it has a buffer
        return _patched(tiff_image(img, 8, 6, compression=5,
                                   rows_per_strip=16), 257, value=24)
    if case == "predictor":
        return _patched(tiff_image(img, 8, 2, compression=5, predictor=2,
                                   rows_per_strip=8), 317, value=0x1002)
    if case == "palette without its ColorMap":
        # BitsPerSample renamed: 1 bit, and a ColorMap of 48 entries
        pal = tiff_image(img[..., :1] // 16, 4, 3, compression=32773,
                         colormap=np.arange(48) * 1000, rows_per_strip=8)
        return _patched(pal, 258, new_tag=1282)
    raise KeyError(case)


@pytest.mark.parametrize("case", [
    "huge count, planes", "huge count, YCbCr", "huge count, sample format",
    "height past the strips", "predictor", "palette without its ColorMap"])
def test_corrupt_directories_as_pil_reads_them(case):
    """Directories that PIL's parse and libtiff's read take differently:
    a count whose value lies past the end of the file stops PIL's parse
    (the tags after it are missing for PIL, not for libtiff); an image
    taller than its strips; a predictor libtiff has no routine for; a
    palette image below 8 bits whose ColorMap libtiff ignores. The port
    answers as the JAX server's PIL does, its pixels included."""
    data = _corrupt_directory(case)
    assert _same_as_pil(data), case


def test_lzma_checks_after_a_full_strip_do_not_fail_it():
    """liblzma reports a broken block check or index once the strip is
    full, which libtiff does not count as a failure: such a file decodes
    on both servers; a break inside the data fails on both."""
    img = _photo(20, 24, 9)
    data = tiff_image(img, 8, 2, compression=34925)
    offs = Image.open(io.BytesIO(data)).tag_v2[273][0]
    cnt = Image.open(io.BytesIO(data)).tag_v2[279][0]
    for pos in (offs + cnt - 1, offs + cnt - 13, offs + cnt - 30,
                offs + cnt // 2, offs + 20):
        bad = bytearray(data)
        bad[pos] ^= 0x10
        assert _same_as_pil(bytes(bad)), pos - offs


def test_duplicate_tags_as_each_reader_takes_them():
    """PIL keeps the last of duplicate tags, libtiff the first: a second
    Compression or RowsPerStrip entry decodes (or fails) as PIL's
    libtiff decode does."""
    img = _photo(16, 20, 10)
    base = tiff_image(img, 8, 2, compression=5, rows_per_strip=8)
    off = struct.unpack_from("<I", base, 4)[0]
    n = struct.unpack_from("<H", base, off)[0]
    entries = [base[off + 2 + 12 * i:off + 14 + 12 * i] for i in range(n)]
    tags = [struct.unpack_from("<H", e)[0] for e in entries]
    for donor, dup in ((258, 259), (262, 278), (284, 259)):
        i = tags.index(donor)
        patched = bytearray(base)
        struct.pack_into("<H", patched, off + 2 + 12 * i, dup)
        assert _same_as_pil(bytes(patched)), (donor, dup)


# --- ZSTD, raw-16, ThunderScan, old-style JPEG ---

def _zstd_file(chunks, h=16, w=20, rows=16, **tags):
    return tiff_file({256: (4, (w,)), 257: (4, (h,)), 258: (3, (8, 8, 8)),
                      259: (3, (50000,)), 262: (3, (2,)), 277: (3, (3,)),
                      278: (4, (rows,)), 284: (3, (1,)), **tags}, chunks)


def _window(frame: bytes, descriptor: int) -> bytes:
    """A frame without a content size given another Window_Descriptor."""
    assert frame[4] & 0xE0 == 0  # not single-segment, no content size
    return frame[:5] + bytes([descriptor]) + frame[6:]


@pytest.mark.parametrize("case", ["levels", "frames", "checksum", "window",
                                  "blocks", "predictors"])
def test_zstd_strips_as_libtiff_reads_them(case):
    """libtiff's ZSTDDecode over libzstd's streaming decoder, against PIL:
    every level; one frame a strip (a strip the first frame leaves short
    fails: a second frame, or one after a skippable frame, is never read;
    bytes after a full strip are never read); the checksum checked where
    the data holds it; the 2^27-byte window limit, which the single-pass
    shortcut for a frame that fits the strip does not apply; raw, RLE and
    several compressed blocks; predictors 2 and 3 in both byte orders."""
    img = _photo(16, 20, 12)
    raw = img.tobytes()
    files = []
    if case == "levels":
        for level in (-5, 1, 3, 9, 19, 22):
            for size in (True, False):
                files.append(_zstd_file([zstd(raw, level,
                                              write_content_size=size)]))
    elif case == "frames":
        half = len(raw) // 2
        skip = struct.pack("<II", 0x184D2A50, 3) + b"abc"
        for chunk in (zstd(raw[:half]) + zstd(raw[half:]),
                      zstd(raw) + zstd(raw[::-1]), skip + zstd(raw),
                      zstd(raw) + skip, zstd(raw) + b"garbage",
                      zstd(raw)[:3], skip[:6], b"\x28\xb5\x2f"):
            files.append(_zstd_file([chunk]))
    elif case == "checksum":
        for size in (True, False):
            good = zstd(raw, write_checksum=True, write_content_size=size)
            bad = good[:-1] + bytes([good[-1] ^ 1])
            files += [_zstd_file([c]) for c in (good, bad, good[:-2])]
    elif case == "window":
        frame = zstd(raw, write_content_size=False)
        for descriptor in (0x88, 0x89, 0x90, 0xF8):
            files.append(_zstd_file([_window(frame, descriptor)]))
        big = zstd(raw, write_content_size=True)
        files.append(_zstd_file([big]))
    elif case == "blocks":
        rng = np.random.default_rng(5)
        flat = np.full((16, 20, 3), 77, np.uint8)
        noise = rng.integers(0, 256, (16, 20, 3), np.uint8)
        files += [_zstd_file([zstd(flat.tobytes())]),
                  _zstd_file([zstd(noise.tobytes())])]
        wide = _photo(150, 120, 13)  # 54,000 bytes: several blocks
        files.append(_zstd_file([zstd(wide.tobytes(), 19)], h=150, w=120,
                                rows=150))
    else:
        rng = np.random.default_rng(6)
        for order in ("<", ">"):
            files.append(tiff_image(img, 8, 2, compression=50000,
                                    predictor=2, rows_per_strip=5,
                                    order=order))
            files.append(tiff_image(rng.integers(0, 65536, (16, 20, 1)), 16,
                                    1, compression=50000, predictor=2,
                                    tile=(16, 16), order=order))
            files.append(tiff_image(rng.normal(0, 50, (16, 20, 1)).astype(
                np.float32), 32, 1, compression=50000, predictor=3,
                sampleformat=3, rows_per_strip=8, order=order))
    for k, data in enumerate(files):
        assert _same_as_pil(data), (case, k)


@pytest.mark.parametrize("descriptor", [0x40, 0x88])
def test_a_zstd_block_past_its_maximum_fails_at_once(descriptor):
    """A frame without a content size whose one compressed block asks for
    ~8.5 GB: 65,000 sequences of RLE codes, match-length code 52 with all 16
    extra bits set (131,074 bytes each). libzstd's streaming decoder holds
    a block to its maximum (128 KiB here) and fails; so does the port, as
    soon as a sequence passes it, without writing the rest."""
    nseq = 65000
    seqs = (b"\x00"  # raw literals, none
            + bytes([0xFF]) + struct.pack("<H", nseq - 0x7F00)
            + b"\x54" + bytes([0, 0, 52])  # RLE codes: ll 0, of 0, ml 52
            + b"\xff" * (2 * nseq) + b"\x01")
    frame = (b"\x28\xb5\x2f\xfd\x00" + bytes([descriptor])
             + struct.pack("<I", 8 << 3)[:3] + bytes(range(8))  # raw block
             + struct.pack("<I", len(seqs) << 3 | 2 << 1 | 1)[:3] + seqs)
    data = _zstd_file([frame])
    t0 = time.perf_counter()
    assert _outcome(native.decode_image, data) == "raises"
    assert time.perf_counter() - t0 < 5.0
    assert _same_as_pil(data)


def _long_matches(mls, tail, literals=b"", content_size=True):
    """A frame of 8 raw bytes, one compressed block of match-length code 52
    sequences (lengths ``mls``, then ``literals``), and ``tail`` zeros in
    a raw block; as a 1-pixel-wide gray strip that it fills."""
    v = 0
    for ml in mls:  # read back to front: the first sequence's bits on top
        v = v << 16 | (ml - 65539)
    bits = (v | 1 << 16 * len(mls)).to_bytes(2 * len(mls) + 1, "little")
    seqs = (bytes([len(literals) << 3]) + literals + bytes([len(mls)])
            + b"\x54" + bytes([0, 0, 52]) + bits)
    n = 8 + sum(mls) + len(literals) + tail
    head = struct.pack("<I", n) if content_size else b""
    frame = (b"\x28\xb5\x2f\xfd" + (b"\xa0" if content_size else b"\x00\x58")
             + head + struct.pack("<I", 8 << 3)[:3] + bytes(range(8))
             + struct.pack("<I", len(seqs) << 3 | 4 | (tail == 0))[:3] + seqs
             + (struct.pack("<I", tail << 3 | 1)[:3] + bytes(tail)
                if tail else b""))
    return tiff_file({256: (4, (1,)), 257: (4, (n,)), 258: (3, (8,)),
                      259: (3, (50000,)), 262: (3, (1,)), 277: (3, (1,)),
                      278: (4, (n,))}, [frame])


@pytest.mark.parametrize("mls,tail,literals", [
    ((65552, 65552), 100, b""), ((65552, 65553), 100, b""),
    ((65552, 65553), 31, b""), ((65552, 65553), 32, b""),
    ((65539, 65539), 0, b""), ((65539,) * 3, 0, b""),
    ((65547, 65548), 41, bytes(range(10))),
    ((65547, 65548), 42, bytes(range(10)))],
    ids=["at_limit", "past_limit", "past_no_park", "past_parked",
         "two_fit", "three", "lits_no_park", "lits_parked"])
def test_a_zstd_block_ends_where_libzstd_bounds_it(mls, tail, literals):
    """How far one compressed block may write, as libzstd 1.5.7 bounds it
    (a 128 KiB block maximum here). A frame that fits the strip is decoded
    in one pass, with the literals parked in the strip block_max + 32
    bytes on where the strip has more than block_max + 64 + their size
    left: past them the block fails, short of it the block may pass
    block_max. Without a content size the frame streams, and a block past
    block_max fails."""
    for content_size in (True, False):
        assert _same_as_pil(_long_matches(mls, tail, literals,
                                          content_size)), content_size


def _raw16_file(bw, rows, fill=1, odd=False):
    h, w = bw.size[1], bw.size[0]
    chunks = [raw16(bw.crop((0, y, w, min(y + rows, h))))
              for y in range(0, h, rows)]
    if fill == 2:
        chunks = [port_tiff._REV[np.frombuffer(c, np.uint8)].tobytes()
                  for c in chunks]
    tags = {256: (4, (w,)), 257: (4, (h,)), 258: (3, (1,)),
            259: (3, (32771,)), 262: (3, (1,)), 266: (3, (fill,)),
            277: (3, (1,)), 278: (4, (rows,))}
    if not odd:
        return tiff_file(tags, chunks)
    # each strip one byte on: at an odd offset in the file
    data = tiff_file(tags, [b"\0" + c for c in chunks])
    t = Image.open(io.BytesIO(data)).tag_v2
    offs = struct.pack(f"<{len(chunks)}L", *t[273])
    return data.replace(offs, struct.pack(f"<{len(chunks)}L",
                                          *(o + 1 for o in t[273])), 1)


@pytest.mark.parametrize("rows", [1, 4, 40])
def test_raw16_rows_as_libtiff_aligns_them(rows):
    """Compression 32771 (Fax3DecodeRLE, FAXMODE_WORDALIGN): Modified
    Huffman rows on 16-bit boundaries. libtiff's reader reads ahead while
    it looks up a row's last code, then drops the bits held to a multiple
    of 16 and steps to an even address, so rows that end near a boundary
    are read from elsewhere: PIL's pixels either way, in both fill orders,
    for strips at even and odd offsets, at several widths."""
    for h, w, kind in ((40, 48, "random"), (33, 97, "text"),
                       (12, 1900, "random")):
        bw = Image.fromarray(_bilevel(h, w, h + w, kind).astype(np.uint8)
                             * 255).convert("1")
        for fill in (1, 2):
            for odd in (False, True):
                data = _raw16_file(bw, rows, fill, odd)
                assert _same_as_pil(data), (h, w, fill, odd)
        if rows == 1:  # one row a strip: nothing read ahead, the image
            got = native.decode_image(_raw16_file(bw, 1))
            assert np.array_equal(got[..., 0] > 0, np.asarray(bw))


def _thunder_file(g4, rows, bits=4, tile=None):
    h, w = g4.shape
    tags = {256: (4, (w,)), 257: (4, (h,)), 258: (3, (bits,)),
            259: (3, (32809,)), 262: (3, (1,)), 277: (3, (1,))}
    if tile:
        tags.update({322: (4, (tile,)), 323: (4, (tile,))})
        return tiff_file(tags, [thunderscan(g4[:tile, :tile])] * (
            -(-h // tile) * -(-w // tile)), tiled=True)
    tags[278] = (4, (rows,))
    return tiff_file(tags, [thunderscan(g4[y:y + rows])
                            for y in range(0, h, rows)])


def test_thunderscan_codes_as_libtiff_decodes_them():
    """ThunderScan (tif_thunder.c ThunderDecodeRow): runs (odd and even,
    ending the row), 2- and 3-bit deltas with their "no delta" entries,
    raw pixels, rows of too many or too few pixels (the strip fails),
    BitsPerSample other than 4 and tiles (refused by libtiff), against
    PIL; the writer's codes decode to its image."""
    rng = np.random.default_rng(7)
    for h, w in ((13, 21), (16, 16), (7, 50), (5, 1)):
        g = np.clip(np.cumsum(rng.integers(-3, 4, (h, w)), 1) + 8, 0,
                    15).astype(np.uint8)
        g[:, w // 3:w // 2] = g[:, w // 3:w // 3 + 1]
        for rows in (h, 3):
            data = _thunder_file(g, rows)
            assert _same_as_pil(data), (h, w, rows)
            assert np.array_equal(native.decode_image(data)[..., 0],
                                  g * 17)
    tags = {256: (4, (9,)), 257: (4, (1,)), 258: (3, (4,)),
            259: (3, (32809,)), 262: (3, (1,)), 277: (3, (1,)),
            278: (4, (1,))}
    for codes in (b"\xc5\x08", b"\xc5\x09", b"\xc5\x07", b"\xc5\x01\x07",
                  b"\xc5\x00\x08", b"\xcf\x5f\x5f\xc1\x00\x02",
                  b"\xc3\xb8\x9f\xc0\x24", b"\x09", b"\xc1\x3f"):
        assert _same_as_pil(tiff_file(tags, [codes])), codes
    g = rng.integers(0, 16, (16, 16)).astype(np.uint8)
    for data in (_thunder_file(g, 8, bits=8), _thunder_file(g, 8, tile=16)):
        assert _pil(data) == "raises" and _outcome(
            native.decode_image, data) == "raises"


@pytest.mark.parametrize("sub", [0, 1, 2], ids=["444", "422", "420"])
def test_old_style_jpeg_layouts(sub):
    """libtiff's tif_ojpeg.c as PIL's RGBA reader drives it: the JPEG
    header from JPEGInterchangeFormat (the whole stream, or its header
    with a strip a restart interval), from the first strip, or rebuilt
    from JPEGQTables, JPEGDCTables and JPEGACTables; libjpeg's raw YCbCr
    lines, libtiff's chroma replication and TIFFYCbCrToRGB; images whose
    widths do not fill their MCUs. At 4:2:0 the pixels are not the JPEG's
    own decode (they differ from it by up to 64 levels)."""
    vs = 2 if sub == 2 else 1
    for h, w in ((40, 48), (13, 21), (33, 50)):
        img = _photo(h, w, h * w + sub)
        for layout in ("jif", "jif_header", "tables", "stream"):
            for rps in (None, 8 * vs, 16):
                if layout != "jif" and rps is None and h > 16:
                    continue
                assert _same_as_pil(ojpeg(img, layout, sub, rps)), (
                    h, w, layout, rps)


def test_old_style_jpeg_directories():
    """What TIFFReadDirectory and OJPEGSubsamplingCorrect make of an
    old-style JPEG's directory, against PIL: Photometric RGB or missing
    (read as YCbCr), BitsPerSample, SamplesPerPixel or YCbCrSubSampling
    missing, a subsampling tag the JPEG's frame overrides, one gray sample
    (libjpeg's scanlines), strips not a multiple of the MCU height (libtiff
    refuses them), separate planes with one strip (read as contiguous),
    JPEGInterchangeFormat past the end of the file."""
    img = _photo(32, 40, 21)
    cases = [ojpeg(img, "jif_header", 2, 16, photometric=2),
             ojpeg(img, "jif_header", 2, 16, drop_tags=(262,)),
             ojpeg(img, "jif_header", 1, 8, drop_tags=(258,)),
             ojpeg(img, "jif_header", 2, 16, drop_tags=(277,)),
             ojpeg(img, "jif", 0, drop_tags=(530,)),
             ojpeg(img, "tables", 2, 16, drop_tags=(530,)),
             ojpeg(img[..., 0], "tables", 0, 8),
             ojpeg(img[..., 0], "jif", 0)]
    sub = ojpeg(img, "jif", 1)
    cases.append(sub.replace(struct.pack("<HHLHH", 530, 3, 2, 2, 1),
                             struct.pack("<HHLHH", 530, 3, 2, 2, 2), 1))
    rows = ojpeg(img, "jif_header", 2, 16)
    cases.append(rows.replace(struct.pack("<HHLL", 278, 4, 1, 16),
                              struct.pack("<HHLL", 278, 4, 1, 12), 1))
    one = ojpeg(img, "jif", 0)
    cases.append(one.replace(struct.pack("<HHLL", 284, 3, 1, 1),
                             struct.pack("<HHLL", 284, 3, 1, 2), 1))
    at = one.index(struct.pack("<HHL", 513, 4, 1)) + 8
    cases.append(one[:at] + struct.pack("<L", len(one) + 9) + one[at + 4:])
    for k, data in enumerate(cases):
        assert _same_as_pil(data), k


def test_xz_filter_chain_as_liblzma_reads_it():
    """Repair A: the xz block header libtiff's own LZMA writer makes holds
    a delta filter before LZMA2 (PIL's lzma TIFFs). Where Python's decoder
    refuses the block's check or index after a full strip, the port decodes
    the block without them through that chain, as liblzma stops once the
    strip is full. A chain with a branch converter, reserved flags and
    non-zero header padding answer as PIL does."""
    img = np.clip(np.cumsum(_photo(20, 24, 9), 1) // 8, 0, 255).astype(
        np.uint8)
    data = pil_tiff(Image.fromarray(img), compression="lzma")
    t = Image.open(io.BytesIO(data)).tag_v2
    off, cnt = t[273][0], t[279][0]
    assert data[off + 13] & 3 == 1 and data[off + 14] == 3  # delta, LZMA2
    for pos in (cnt - 1, cnt - 5, cnt - 13, cnt - 30):
        bad = bytearray(data)
        bad[off + pos] ^= 0x10
        assert _same_as_pil(bytes(bad)), pos - cnt
    raw = img.tobytes()

    def header(blob, fn):
        size = (blob[12] + 1) * 4
        h = fn(bytearray(blob[12:12 + size - 4]))
        return blob[:12] + bytes(h) + struct.pack("<I", zlib.crc32(
            bytes(h))) + blob[12 + size:]
    for filters in ([{"id": lzma.FILTER_X86}, {"id": lzma.FILTER_LZMA2}],
                    [{"id": lzma.FILTER_DELTA, "dist": 4},
                     {"id": lzma.FILTER_LZMA2}]):
        blob = lzma.compress(raw, lzma.FORMAT_XZ, filters=filters)
        for variant in (blob, header(blob, lambda h: h[:1] + bytes(
                [h[1] | 4]) + h[2:]), header(blob, lambda h: h[:-1] + b"\1")):
            assert _same_as_pil(tiff_image(img, 8, 2, extra_tags={
                259: (3, (34925,))}, chunk_codec=lambda b, v=variant: v))


def test_jpeg_tables_as_libjpeg_reads_them():
    """Repair B: JPEGTables goes through libjpeg's jpeg_read_header before
    any strip, which refuses a marker it does not know, a frame or scan
    header, a second SOI, table numbers past 3 and segments whose lengths
    disagree ("Bogus JPEGTables field": the file fails); COM, APPn, DRI,
    RSTn and garbage between markers pass, and a missing EOI is libjpeg's
    fake one. Each as the JAX server's PIL answers."""
    img = np.clip(np.cumsum(_photo(16, 20, 4), 1) // 6, 0, 255).astype(
        np.uint8)
    strips = [jpeg_strip(2)(img[y:y + 8]) for y in range(0, 16, 8)]
    tables, short = jpeg_tables(strips)
    tags = {256: (4, (20,)), 257: (4, (16,)), 258: (3, (8, 8, 8)),
            259: (3, (7,)), 262: (3, (6,)), 277: (3, (3,)),
            278: (4, (8,)), 284: (3, (1,)), 530: (3, (2, 2))}
    i = tables.index(b"\xff\xc4")
    variants = [
        tables, tables[:i + 1] + b"\x84" + tables[i + 2:],
        tables[:i + 4] + b"\x20" + tables[i + 5:],
        tables[:i + 4] + b"\x14" + tables[i + 5:],
        tables[:6] + b"\x05" + tables[7:], tables[:4] + b"\x44" + tables[5:],
        tables[:-2], tables[2:], tables[:2] + b"\xff\xfe\x00\x05abc" +
        tables[2:], tables[:i] + b"\x12\x34" + tables[i:],
        tables[:-2] + b"\xff\xc0\x00\x0b\x08\x00\x10\x00\x14\x01\x01\x11"
        b"\x00\xff\xd9", tables[:2] + b"\xff\xdd\x00\x04\x00\x01" +
        tables[2:], tables[:2] + b"\xff\xdd\x00\x05\x00\x01\x00" +
        tables[2:], tables[:2] + b"\xff\xd3" + tables[2:],
        tables[:2] + b"\xff\xd8" + tables[2:], b"\xff\xd8", b"\xff"]
    refused = 0
    for k, t in enumerate(variants):
        data = tiff_file({**tags, 347: (7, t)}, short)
        assert _same_as_pil(data), k
        refused += isinstance(_pil(data), str)
    assert 0 < refused < len(variants)


def _renamed(data, tag, new_tag):
    """``data`` (little-endian) with the first entry of ``tag`` renamed."""
    b = bytearray(data)
    struct.pack_into("<H", b, _entry(data, tag), new_tag)
    return bytes(b)


def test_a_duplicate_compression_read_as_none_by_libtiff():
    """Repair C: a BitsPerSample of 1 renamed Compression before the real
    Compression entry. PIL keeps the last (CCITT or LZW: its libtiff
    decoder), libtiff the first (1, none): DumpModeDecode then reads each
    strip's bytes as pixels, and fails a strip whose byte count (for more
    than two strips of unequal counts, libtiff's estimate from the image
    height) is short of it. The port answers as PIL does, its pixels
    included."""
    bw = Image.fromarray(_bilevel(40, 48, 3, "random").astype(np.uint8)
                         * 255).convert("1")
    old = TiffImagePlugin.STRIP_SIZE
    TiffImagePlugin.STRIP_SIZE = 12 * 6
    try:
        g3 = pil_tiff(bw, compression="group3")
    finally:
        TiffImagePlugin.STRIP_SIZE = old
    noise = np.random.default_rng(8).integers(0, 2, (24, 64, 1))
    for base in (g3, tiff_image(noise, 1, 0, compression=5,
                                rows_per_strip=24),
                 tiff_image(noise, 1, 0, compression=5, rows_per_strip=8)):
        data = _renamed(base, 258, 259)
        assert _same_as_pil(data)
    assert _pil(_renamed(g3, 258, 259)) == "raises"


def test_byte_counts_libtiff_estimates():
    """TIFFReadDirectory's estimates: one strip whose byte count is 0 (its
    size from the file), and an image whose StripByteCounts PIL's parse
    never reaches; RowsPerStrip past the image (PIL's strip buffer holds
    that many rows)."""
    img = _photo(16, 20, 14)
    one = _zstd_file([zstd(img.tobytes())])
    at = one.index(struct.pack("<HHL", 279, 4, 1))
    cases = [one[:at + 4] + b"\0\0\0\0" + one[at + 8:],
             one.replace(struct.pack("<HHLL", 278, 4, 1, 16),
                         struct.pack("<HHLL", 278, 4, 1, 4136), 1)]
    data = tiff_image(img, 8, 2, compression=8, rows_per_strip=16)
    at = data.index(struct.pack("<HHL", 279, 4, 1))
    cases.append(data[:at + 4] + b"\0\0\0\0" + data[at + 8:])
    photo_at = _entry(cases[1], 262)
    b = bytearray(cases[1])
    struct.pack_into("<L", b, photo_at + 4, 8193)  # PIL's parse stops here
    cases.append(bytes(b))
    for k, data in enumerate(cases):
        assert _same_as_pil(data), k


def test_packbits_and_lzw_encoders_round_trip():
    """The writers the tests build layouts with: PackBits and LZW (with a
    table reset past 4093 entries) decode to their input through the
    port's libtiff-equivalent decoders and PIL's."""
    rng = np.random.default_rng(2)
    raw = np.repeat(rng.integers(0, 256, 20000, np.uint8),
                    rng.integers(1, 5, 20000)).tobytes()[:40000]
    s = np.frombuffer(raw, np.uint8).reshape(100, 400, 1)
    for comp in (5, 32773):
        data = tiff_image(s, 8, 1, compression=comp)
        assert np.array_equal(native.decode_image(data)[..., 0], s[..., 0])
        assert _same_as_pil(data)
    assert packbits(b"") == b"" and len(lzw(raw)) < len(raw)


# --- the entry points ---

@pytest.fixture(scope="module")
def srcnn_servers():
    """(JAX server port, port server port, port server): the SRCNN winner
    (JAX from its Orbax checkpoint, the port from its asset) in float32
    behind each HTTP front end."""
    jsrv = jax_serve.SRServer("auto", str(CHECKPOINT), dtype=jnp.float32)
    psrv = SRServer("auto", checkpoint=str(ASSET), dtype=torch.float32,
                    device="cpu")
    jhttpd = jax_serve.SRHTTPServer(("127.0.0.1", 0),
                                    jax_serve.make_handler(jsrv))
    phttpd = serve.SRHTTPServer(("127.0.0.1", 0), serve.make_handler(psrv))
    for h in (jhttpd, phttpd):
        threading.Thread(target=h.serve_forever, daemon=True).start()
    yield jhttpd.server_address[1], phttpd.server_address[1], psrv
    for h in (jhttpd, phttpd):
        h.shutdown()
        h.server_close()
    psrv.close()


def _post(port, body):
    import urllib.error
    import urllib.request
    req = urllib.request.Request(f"http://127.0.0.1:{port}/sr", data=body,
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.mark.parametrize("name", ["tiff_lzw_pred2", "tiff_jpeg_ycbcr420",
                                  "tiff_g4"])
def test_tiff_upload_answered_as_the_jax_server(srcnn_servers, name):
    """Both servers answer 200; the port's body is the PNG of its engine's
    upscale of PIL's pixels, byte for byte, and the two bodies decode
    within 1 level of each other (the float32 SRCNN forward rounds a few
    values differently in XLA and PyTorch); a cut TIFF is a 400 on both; a
    ZSTD one 200 from both, within 1 level; a CIELab one 200 from both,
    the port's body the PNG of its upscale of PIL's pixels."""
    jport, pport, psrv = srcnn_servers
    data = (JPEG_ASSETS / GOLDENS[name]["file"]).read_bytes()
    (jcode, jbody), (pcode, pbody) = _post(jport, data), _post(pport, data)
    assert jcode == pcode == 200
    assert pbody == native.encode_png_rgb8(psrv.upscale(_pil(data)),
                                           psrv.png_level)
    jpx = native.decode_image(jbody).astype(np.int16)
    ppx = native.decode_image(pbody).astype(np.int16)
    assert jpx.shape == ppx.shape and np.abs(jpx - ppx).max() <= 1
    cut = data[:len(data) // 3]
    assert _post(jport, cut)[0] == _post(pport, cut)[0] == 400
    zstd_tiff = (JPEG_ASSETS / GOLDENS["tiff_zstd"]["file"]).read_bytes()
    (jcode, jbody), (pcode, pbody) = _post(jport, zstd_tiff), \
        _post(pport, zstd_tiff)
    assert jcode == pcode == 200
    assert np.abs(native.decode_image(jbody).astype(np.int16)
                  - native.decode_image(pbody)).max() <= 1
    lab = (JPEG_ASSETS / GOLDENS["tiff_cielab"]["file"]).read_bytes()
    assert _post(jport, lab)[0] == 200
    code, body = _post(pport, lab)
    assert code == 200 and body == native.encode_png_rgb8(
        psrv.upscale(_pil(lab)), psrv.png_level)


@pytest.mark.parametrize("family", ["tiff_zstd", "tiff_raw16",
                                    "tiff_thunderscan", "tiff_ojpeg"])
def test_new_compression_uploads_answered_as_the_jax_server(srcnn_servers,
                                                            family):
    """Each committed ZSTD, raw-16, ThunderScan and old-style JPEG TIFF
    (posted at once): 200 from both servers, the two bodies within 1 level
    of each other (the decode is held to PIL's above, and the body to the
    engine's upscale by test_tiff_upload_answered_as_the_jax_server)."""
    from concurrent.futures import ThreadPoolExecutor
    jport, pport, _ = srcnn_servers
    names = [n for n in TIFF if n.startswith(family)]
    bodies = [(JPEG_ASSETS / GOLDENS[n]["file"]).read_bytes() for n in names]
    with ThreadPoolExecutor(2 * len(bodies)) as pool:
        jobs = [(pool.submit(_post, jport, b), pool.submit(_post, pport, b))
                for b in bodies]
        answers = [(j.result(), p.result()) for j, p in jobs]
    for name, ((jcode, jbody), (pcode, pbody)) in zip(names, answers):
        assert jcode == pcode == 200, name
        jpx = native.decode_image(jbody).astype(np.int16)
        assert np.abs(jpx - native.decode_image(pbody)).max() <= 1, name


def test_a_zstd_unit_that_does_not_build_is_415_naming_it(srcnn_servers,
                                                          monkeypatch):
    """No fallback: where g++ cannot build fast_zstd.cpp, a ZSTD TIFF is a
    415 naming the ZSTD unit and the build failure; the other TIFF codecs
    (fast_tiff.cpp) still decode."""
    monkeypatch.setitem(native._libs, "fast_zstd", None)
    monkeypatch.setitem(native._errors, "fast_zstd", "g++: not found")
    data = (JPEG_ASSETS / GOLDENS["tiff_zstd"]["file"]).read_bytes()
    with pytest.raises(native.UnsupportedImage, match="ZSTD unit"):
        native.decode_image(data)
    code, body = _post(srcnn_servers[1], data)
    assert code == 415 and b"ZSTD" in body and b"g++" in body
    lzw_tiff = (JPEG_ASSETS / GOLDENS["tiff_lzw_pred2"]["file"]).read_bytes()
    assert _post(srcnn_servers[1], lzw_tiff)[0] == 200


def test_a_tiff_unit_that_does_not_build_is_415_naming_it(srcnn_servers,
                                                         monkeypatch):
    """No fallback: on a host where g++ cannot build fast_tiff.cpp, a TIFF
    upload is a 415 naming the build failure, and PNG still serves."""
    monkeypatch.setitem(native._libs, "fast_tiff", None)
    monkeypatch.setitem(native._errors, "fast_tiff", "g++: not found")
    data = (JPEG_ASSETS / GOLDENS["tiff_deflate_tiled"]["file"]).read_bytes()
    with pytest.raises(native.UnsupportedImage, match="did not build"):
        native.decode_image(data)
    code, body = _post(srcnn_servers[1], data)
    assert code == 415 and b"did not build" in body and b"g++" in body
    png = native.encode_png_rgb8(_photo(8, 8, 1))
    assert _post(srcnn_servers[1], png)[0] == 200


def test_predict_upscales_a_tif(tmp_path, capsys):
    """A .tif named on the command line is read (a directory walk, like
    the JAX CLI's, takes only its extensions, which do not include
    .tif)."""
    src, out = tmp_path / "in", tmp_path / "out"
    src.mkdir()
    data = (JPEG_ASSETS / GOLDENS["tiff_planar"]["file"]).read_bytes()
    (src / "scan.tif").write_bytes(data)
    predict.main([str(src / "scan.tif"), "--out_dir", str(out),
                  "--architecture", "SRCNN", "--tile", "16", "--max_batch",
                  "4", "--dtype", "float32", "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["n_images"] == 1 and summary["failed"] == 0
    ref = SRServer("SRCNN", dtype=torch.float32, device="cpu", tile=16,
                   max_batch=4)
    try:
        got = native.decode_image((out / "scan_x4.png").read_bytes())
        assert np.array_equal(got, ref.upscale(_pil(data)))
    finally:
        ref.close()
    assert predict.collect_inputs([str(src)])[0] == []
