"""The port's request decoder as PIL's opener walk (food101_sr_tpu_torch/
native/openers.py) and the formats it reaches past the common ones
(native/legacy.py, the loops in native/fast_legacy.cpp), against PIL, which
the JAX package's server decodes uploads with: every committed TGA, DIB,
PCX, DCX, SGI, Sun, IM, IMT, IPTC and SPIDER stream pixel-equal to PIL live
and to its golden, a seeded PhotoCD in each orientation; the openers'
collisions (the uncompressed TGA PIL writes starts with CUR's signature);
each format's layouts, colour maps and header edge cases; seeded cuts and
bit flips of every stream answered as PIL answers them; IPTC images
embedding IPTC images, and nested past PIL's recursion limit; the order
of the walk; and one upload of each format answered alike by the port's
and the JAX package's servers."""
import io
import json
import struct
import sys
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401
from PIL import Image

from food101_sr_tpu_torch import native, serve
from food101_sr_tpu_torch.native import legacy, openers
from food101_sr_tpu_torch.serving import SRServer

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import serve as jax_serve  # noqa: E402
from chip_smoke import pcd_stream, sha256, tga_photo  # noqa: E402
from tools import format_differential  # noqa: E402
from tools.raster_writers import (dcx, iptc, legacy_streams, pcd,  # noqa: E402
                                  pcx, pil_save, sgi, spider, sun, tga)

JPEG_ASSETS = ROOT / "food101_sr_tpu_torch" / "assets" / "jpeg"
ALL_GOLDENS = json.loads((JPEG_ASSETS / "goldens.json").read_text())
GOLDENS = ALL_GOLDENS["streams"]
KINDS = ("tga", "dib", "pcx", "dcx", "sgi", "ras", "im", "imt", "iptc",
         "spider")
STREAMS = sorted(n for n, g in GOLDENS.items()
                 if g["file"].rsplit(".", 1)[1] in KINDS)
ASSET = ROOT / "food101_sr_tpu_torch" / "assets" / "winner_srcnn.pth"
CHECKPOINT = ROOT / "weights" / "winner_srcnn_best"


def _pil(data):
    """PIL's pixels, or "raises" for any exception (the JAX server answers
    400 to each)."""
    return format_differential.pil_outcome(data)


def _same_as_pil(data) -> bool:
    """The port gives PIL's pixels, or raises ValueError (its server's
    400) where PIL raises: never a 415 (every case here is a format the
    port decodes), nor another exception (its server would not answer)."""
    a, b = _pil(data), format_differential.port_outcome(data)
    if isinstance(a, str) or isinstance(b, str):
        return (a if isinstance(a, str) else "px") == \
            (b if isinstance(b, str) else "px")
    return a.shape == b.shape and np.array_equal(a, b)


def _rng_img(h, w, c, seed, top=256):
    return np.random.default_rng(seed).integers(0, top, (h, w, c)).astype(
        np.uint8)


# --- the committed streams ---

def test_committed_streams_cover_each_format():
    kinds = {GOLDENS[n]["file"].rsplit(".", 1)[1] for n in STREAMS}
    assert kinds == set(KINDS)


def test_committed_streams_are_the_writers_bytes():
    """``tools/raster_writers.legacy_streams`` makes the committed files
    (the sweeps of ``tools/format_differential.py`` start from them)."""
    made = legacy_streams()
    assert {GOLDENS[n]["file"].split("/")[1] for n in STREAMS} == set(made)
    for name in STREAMS:
        f = GOLDENS[name]["file"]
        assert (JPEG_ASSETS / f).read_bytes() == made[f.split("/")[1]], f


@pytest.mark.parametrize("name", STREAMS)
def test_committed_stream_matches_pil_and_its_golden(name):
    g = GOLDENS[name]
    data = (JPEG_ASSETS / g["file"]).read_bytes()
    assert len(data) <= 8192
    px = native.decode_image(data)
    assert list(px.shape) == g["shape"] and sha256(px) == g["served_sha256"]
    assert np.array_equal(px, _pil(data))


@pytest.mark.parametrize("orientation", range(4))
def test_photocd_matches_pil(orientation):
    """The 768 x 512 base image through PIL's YCC tables, turned 90 or 270
    degrees by the orientation byte."""
    rng = np.random.default_rng(orientation)
    data = pcd(rng.integers(0, 256, (512, 768)), rng.integers(
        0, 256, (256, 384)), rng.integers(0, 256, (256, 384)), orientation)
    px = native.decode_image(data)
    assert px.shape == ((768, 512, 3) if orientation % 2 else (512, 768, 3))
    assert np.array_equal(px, _pil(data))
    assert _same_as_pil(data[:-1]) and _same_as_pil(data[:2048 + 1538])


def test_generated_photocd_matches_its_golden():
    g = ALL_GOLDENS["generated"]["pcd"]
    px = native.decode_image(pcd_stream())
    assert list(px.shape) == g["shape"] and sha256(px) == g["served_sha256"]


def test_uncompressed_tga_with_cur_signature_decodes():
    """The true-colour TGA PIL writes starts 00 00 02 00, CUR's signature:
    CUR's opener finds no cursor and falls through, IM, IMT, IPTC, PCD and
    SPIDER refuse it, and TGA opens it (the port answered 400 through its
    CUR decoder before the walk)."""
    for name in ("tga_rgb", "tga_rgba"):
        data = (JPEG_ASSETS / GOLDENS[name]["file"]).read_bytes()
        assert data[:4] == b"\x00\x00\x02\x00"
        with pytest.raises(native.NotThisFormat):
            native.decode_cur_rgb8(data)
        assert np.array_equal(native.decode_image(data), _pil(data))
    data, img = tga_photo(60, 80, 3)
    assert np.array_equal(native.decode_image(data), img)


# --- the walk ---

@pytest.mark.parametrize("case", range(7))
def test_opener_collisions(case):
    """TGAs whose first bytes other openers take: CUR's and ICO's
    signatures (CUR and ICO fall through), a PCX signature (PCX stops the
    walk: 400), an IPTC field whose length byte PIL refuses (400), MPEG's
    start code and a line IMT reads; each answered as PIL answers it."""
    label, data = format_differential.walk_cases(1, 0)[case]
    assert _same_as_pil(data), label


def test_dib_is_opened_by_its_header_size():
    data = (JPEG_ASSETS / GOLDENS["dib_rgb"]["file"]).read_bytes()
    assert data[:4] == b"\x28\x00\x00\x00"
    assert np.array_equal(native.decode_image(data), _pil(data))
    assert _same_as_pil(data[:3]) and _same_as_pil(data[:40])


@pytest.mark.parametrize("seed", range(3))
def test_random_headers_walk_as_pil_walks(seed):
    for label, data in format_differential.walk_cases(seed, 40)[7:]:
        assert _same_as_pil(data), label


def test_walk_order_does_not_change_these_answers():
    """PIL in a fresh process walks BMP, DIB, GIF, JPEG, PPM and PNG first
    (``Image.open``'s first pass), as the JAX server does; the port follows
    the full ``Image.ID`` order of a process that called ``Image.init()``.
    On the committed streams of these formats and the walk's cases the two
    orders give PIL's same answers."""
    cases = [(n, (JPEG_ASSETS / GOLDENS[n]["file"]).read_bytes())
             for n in STREAMS] + format_differential.walk_cases(1, 20)
    got = format_differential.order_sweep(cases)
    assert got["answers_differ"] == 0, got
    assert got["fresh_order"][:6] == ["BMP", "DIB", "GIF", "JPEG", "PPM",
                                      "PNG"]
    assert [o[0] for o in openers.OPENERS] == got["init_order"]


def test_accepted_formats_not_decoded_are_refused_by_name():
    for data, name in ((b"SIMPLE  =                    T" + bytes(64), "FITS"),
                       (b"/* XPM */\n" + bytes(64), "XPM"),
                       (b"#define im_width 8\n" + bytes(64), "XBM")):
        with pytest.raises(native.UnsupportedImage, match=name):
            native.decode_image(data)


# --- cuts and flips ---

@pytest.mark.parametrize("name", STREAMS)
def test_seeded_cuts_and_flips_match_pil(name):
    data = (JPEG_ASSETS / GOLDENS[name]["file"]).read_bytes()
    rng = np.random.default_rng(sum(map(ord, name)))
    for k in sorted(set(rng.integers(0, len(data), 12).tolist()) | {0, 17,
                                                                     18}):
        assert _same_as_pil(data[:k]), (name, k)
    for i in range(16):
        b = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            pos = int(rng.integers(0, 64 if i % 2 == 0 else len(b)))
            b[min(pos, len(b) - 1)] ^= 1 << int(rng.integers(0, 8))
        assert _same_as_pil(bytes(b)), (name, i)


# --- TGA ---

@pytest.mark.parametrize("imagetype,depth", [
    (2, 24), (2, 32), (2, 16), (3, 8), (3, 16), (3, 1), (1, 8), (10, 24),
    (10, 32), (10, 16), (11, 8), (11, 16), (11, 1), (9, 8), (2, 8),
    (3, 24), (1, 16)])
@pytest.mark.parametrize("flags", [0x00, 0x10, 0x20, 0x30])
def test_tga_types_depths_and_orientations(imagetype, depth, flags):
    """Each (type, depth) PIL's table maps (and some it does not, left
    without a tile: 400), in each orientation, raw and RLE."""
    h, w = 5, 9
    k = max(1, depth // 8)
    px = _rng_img(h, w if depth > 1 else 2, k, imagetype * depth + flags)
    if depth > 1 and imagetype in (10, 11, 9):
        px[:, 2:6] = px[:, 2:3]  # runs
    cmap = b""
    if imagetype in (1, 9):
        cmap = _rng_img(1, 64, 3, depth).tobytes()
    data = tga(px if k > 1 else px[..., 0], imagetype, depth, flags=flags,
               rle=imagetype >= 9, cmap=cmap, cmap_depth=24 if cmap else 0)
    if depth == 1:
        data = data[:12] + struct.pack("<H", w) + data[14:]
    assert _same_as_pil(data)


@pytest.mark.parametrize("mapdepth,start,entries", [
    (24, 0, 16), (24, 5, 16), (24, 0, 256), (24, 10, 250), (24, 10, 247),
    (16, 3, 8), (32, 0, 4), (15, 0, 4), (24, 0, 0), (24, 300, 0)])
def test_tga_colour_maps(mapdepth, start, entries):
    """Maps of 16 and 24 bits after ``start`` zero entries; PIL refuses a
    32-bit map and more than 256 entries at load, and falls through on a
    15-bit one; a map on a grey image is its palette, on RGB an error."""
    idx = _rng_img(4, 6, 1, entries, 256)[..., 0]
    cmap = _rng_img(1, entries, max(2, mapdepth // 8), start)[0].tobytes()
    for imagetype in (1, 3, 9, 2):
        px = idx if imagetype != 2 else _rng_img(4, 6, 3, 1)
        data = tga(px, imagetype, 8 if imagetype != 2 else 24, cmap=cmap,
                   cmap_start=start, cmap_depth=mapdepth, rle=imagetype == 9)
        assert _same_as_pil(data), imagetype


def test_tga_rle_packets_across_rows_and_truncations():
    """Literals flow on into the next rows, runs may not cross a row
    (PIL's overrun); an ID field before the data; data cut short."""
    px = _rng_img(4, 5, 3, 7)
    for cross in (False, True):
        for flat in (False, True):
            img = px.copy()
            if flat:
                img[:] = img[0, 0]
            data = tga(img, 10, 24, rle=True, runs_cross=cross,
                       ident=b"id" * 7)
            assert _same_as_pil(data), (cross, flat)
            assert _same_as_pil(data[:-1]), (cross, flat)


# --- PCX and DCX ---

@pytest.mark.parametrize("planes,bits", [(1, 1), (2, 1), (4, 1), (1, 8),
                                         (3, 8)])
def test_pcx_planes_bits_and_strides(planes, bits):
    """PIL's stride (the header's when it is the row's bytes, else rounded
    up to even), its plane spacing, the VGA palette or the grey ramp."""
    rng = np.random.default_rng(planes * 10 + bits)
    for w in (1, 2, 3, 5, 8, 9, 16, 17, 40, 47):
        row = (w * bits + 7) // 8
        for extra in (None, 0, 1, 2):
            if bits == 1:
                idx = rng.integers(0, 1 << planes, (3, w))
                pl = [(idx >> k) & 1 for k in range(planes)]
            else:
                pl = [rng.integers(0, 256, (3, w)) for _ in range(planes)]
            vga = None
            if planes == 1 and bits == 8:
                vga = (bytes(np.arange(256, dtype=np.uint8).repeat(3))
                       if w % 2 else rng.integers(0, 256, 768).astype(
                           np.uint8).tobytes())
            data = pcx(pl, bits, stride=None if extra is None
                       else row + extra, palette16=bytes(range(48)), vga=vga)
            assert _same_as_pil(data), (w, extra)


def test_pcx_headers_pil_refuses():
    good = pcx([_rng_img(3, 4, 1, 1)[..., 0]] * 3, 8)
    assert _same_as_pil(good)
    for at, value in ((1, 4), (3, 4), (65, 2), (4, 9), (8, 0)):
        b = bytearray(good)
        b[at] = value
        assert _same_as_pil(bytes(b)), at
    short = pcx([_rng_img(2, 3, 1, 1)[..., 0]], 8, vga=None)
    assert len(short) < 769 and _same_as_pil(short)  # no VGA palette read


def test_dcx_first_frame_and_its_table():
    a, b = pil_save(_rng_img(6, 5, 3, 1), "PCX"), pil_save(
        _rng_img(4, 7, 3, 2), "PCX")
    for data in (dcx([a, b]), dcx([b]), dcx([])[:8], dcx([a])[:10]):
        assert _same_as_pil(data)


# --- SGI ---

@pytest.mark.parametrize("bpc", [1, 2])
@pytest.mark.parametrize("z", [1, 3, 4])
@pytest.mark.parametrize("rle", [False, True])
def test_sgi_layouts(bpc, z, rle):
    img = _rng_img(5, 7, z, bpc * 10 + z, 256 if bpc == 1 else 256)
    if bpc == 2:
        img = img.astype(np.uint16) * 257 + 1
    img[1:3, 2:6] = img[1, 2]
    data = sgi(img if z > 1 else img[..., 0], bpc, rle=rle)
    assert _same_as_pil(data)
    if z == 1:
        assert _same_as_pil(sgi(img[..., 0], bpc, rle=rle, dimension=1))
        assert _same_as_pil(sgi(img[..., 0], bpc, rle=rle, dimension=3))
    assert _same_as_pil(data[:-3])


def test_sgi_rle_tables_as_pil_reads_them():
    """A start before the body is PIL's overrun; a length past the file is
    not checked, one past 2^31 leaves the row as the buffer holds it, and a
    packet at a row's last byte stops the whole decode without an error."""
    base = sgi(_rng_img(4, 6, 1, 3)[..., 0], 1, rle=True)
    h = 4
    for row, start, length in ((1, 0, None), (2, 511, None), (1, None, 1000),
                               (3, None, 0xFFFFFFFF), (0, None, 0),
                               (2, None, 1)):
        b = bytearray(base)
        if start is not None:
            struct.pack_into(">I", b, 512 + 4 * row, start)
        if length is not None:
            struct.pack_into(">I", b, 512 + 4 * (h + row), length)
        assert _same_as_pil(bytes(b)), (row, start, length)


# --- Sun raster ---

@pytest.mark.parametrize("depth", [1, 4, 8, 24, 32])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 5, 6])
def test_sun_depths_and_types(depth, ftype):
    w, h = 7, 5
    rng = np.random.default_rng(depth * 10 + ftype)
    stride = ((w * depth + 15) // 16) * 2
    row = (w * depth + 7) // 8
    rows = rng.integers(0, 256, (h, row if ftype == 2 else stride))
    rows[:, :2] = 0x80
    pal = rng.integers(0, 256, (16, 3)) if depth in (4, 8) else None
    for p in (None, pal):
        data = sun(rows, depth, w, ftype=ftype, palette=p)
        assert _same_as_pil(data), p is None
        assert _same_as_pil(data[:-1])


def test_sun_colour_maps_pil_refuses():
    rows = _rng_img(3, 4, 1, 1)[..., 0]
    big = sun(rows, 8, 4, palette=np.zeros((342, 3)))
    wrong = bytearray(sun(rows, 8, 4, palette=np.zeros((4, 3))))
    wrong[27] = 2  # a raw map type
    on_rgb = sun(_rng_img(3, 4, 3, 2).reshape(3, 12), 24, 4,
                 palette=np.zeros((4, 3)))
    for data in (big, bytes(wrong), on_rgb):
        assert _same_as_pil(data)


# --- IM, IMT, IPTC, SPIDER ---

IM_TYPES = ["0 1 image", "L 1 image", "Greyscale image", "Grayscale image",
            "RGB image", "RLB image", "B1 image", "B2 image", "B4 image",
            "X 24 image", "L 32 S image", "L 32 F image", "RGB3 image",
            "RYB3 image", "LA image", "PA image", "RGBA image", "RGBX image",
            "CMYK image", "L 8 image", "L 8S image", "L 16 image",
            "L 16S image", "L 32 image", "L 32F image", "L 16L image",
            "L 16B image", "L 32S image", "L*16 image", "Strange image",
            "RGB"]


@pytest.mark.parametrize("itype", IM_TYPES)
def test_im_image_types(itype):
    body = _rng_img(1, 4096, 1, len(itype))[0, :, 0].tobytes()
    head = f"Image type: {itype}\r\nImage size (x*y): 6*5\n".encode()
    for lut in (None, bytes(range(256)) * 3, _rng_img(1, 768, 1, 3)[
            0, :, 0].tobytes()):
        h = head + (b"Lut: 1\n" if lut else b"")
        data = h + b"\x00" * 9 + b"\x1a" + (lut or b"") + body
        assert _same_as_pil(data), lut is None


def test_im_refuses_by_name_what_it_does_not_decode():
    for itype in ("YCC image", "L*12 image"):
        data = f"Image type: {itype}\nImage size (x*y): 3*2\n\x1a".encode() \
            + bytes(64)
        assert not isinstance(_pil(data), str)
        with pytest.raises(native.UnsupportedImage, match="IM"):
            native.decode_image(data)


@pytest.mark.parametrize("head", [
    b"Image size (x*y): 4*3\n", b"Image size (x*y): 4\n",
    b"Image size (x*y): 4*3*2\n", b"Image size (x*y): 4.0*3\n",
    b"Image size (x*y): 4*x\n", b"Scale (x,y): 1,2\nName: a\n",
    b"File size (no of images): \n", b"Comment: c\nComment: d\n",
    b"Image type: \n", b"9Image type: L\n", b"Image type L\n",
    b"Date: " + b"x" * 120 + b"\n", b"Image type: RGB image\nImage "
    b"type: Strange image\nImage size (x*y): 2*2\n"])
def test_im_headers_as_pil_reads_them(head):
    for end in (b"\x1a", b"\x00\x00\x1a", b"\r\x1a", b""):
        assert _same_as_pil(head + end + bytes(range(48)) * 4), end
    assert _same_as_pil(head + b"\x00" + bytes(range(27, 256)) * 4)  # no ^Z


def test_imt_layouts():
    g = _rng_img(5, 6, 1, 2)[..., 0]
    for head in (b"width 6\nheight 5\npixel n8\n",
                 b"* a comment\nwidth 6\nheight 5\npixel n8\n",
                 b"width 6\nheight 5\n", b"width 6\npixel n8\n",
                 b"width x\nheight 5\npixel n8\n", b" \nwidth 6\n",
                 b"width 6\nheight 5\npixel n8\nmore 1\n" + b"y" * 120):
        for tail in (b"\x0c" + g.tobytes(), b"\x0c" + g.tobytes()[:-1], b""):
            assert _same_as_pil(head + tail), (head, tail[:1])


def test_iptc_layouts():
    g = _rng_img(4, 5, 1, 4)[..., 0]
    jpg = pil_save(g, "JPEG", "L", quality=90)
    rgbjpg = pil_save(_rng_img(4, 5, 3, 4), "JPEG", quality=90)
    cases = [iptc(g.tobytes(), 5, 4), iptc(g.tobytes(), 5, 4, chunk=7),
             iptc(jpg, 5, 4, compression=5),
             iptc(rgbjpg, 5, 4, compression=5),
             iptc(g.tobytes(), 5, 4, layers=3, component=1, band=1),
             iptc(g.tobytes(), 5, 4, layers=4, component=1, band=4),
             iptc(g.tobytes(), 5, 4, layers=4, component=1),
             iptc(g.tobytes(), 5, 4, layers=3, component=1, band=0),
             iptc(g.tobytes(), 5, 4, layers=3, component=1, band=9),
             iptc(jpg, 5, 4, layers=3, component=1, band=2, compression=5),
             iptc(rgbjpg, 5, 4, layers=3, component=1, band=2,
                  compression=5),
             iptc(g.tobytes(), 5, 4, layers=2, component=1),
             iptc(g.tobytes(), 5, 4, compression=3),
             iptc(g.tobytes(), 5, 4)[:-4], iptc(g.tobytes(), 5, 4) + bytes(9),
             b"\x1c\x02\x00\x86\x00", b"\x1c\x02\x00\x82\x00\x05abcde"]
    for i, data in enumerate(cases):
        assert _same_as_pil(data), i


@pytest.mark.parametrize("seed", range(1, 4))
def test_iptc_embedding_iptc_as_pil_opens_it(seed):
    """IPTC images in band-less IPTC images (up to 4 deep), or as one band
    of one, around grey and colour JPEGs, a PNG and a TGA: PIL's pixels,
    or its 400 (a colour image or a one-band IPTC merged as a band, a
    size that is not the embedded image's)."""
    for label, data in format_differential.nest_cases(seed):
        assert _same_as_pil(data), label


# the size of the committed streams, which the servers have served
_NEST_CORE = pil_save(_rng_img(40, 48, 1, 0)[..., 0], "JPEG", "L")


def _nested_iptc(levels: int) -> bytes:
    data = _NEST_CORE
    for _ in range(levels):
        data = iptc(data, 48, 40, compression=5)
    return data


def test_iptc_nesting_is_a_value_error_past_its_limit():
    """Nested past PIL's recursion limit the port stops in a loop, with
    ValueError (its server's 400), not a RecursionError (PIL's own limit
    depends on its caller's stack: the servers' test below holds the
    port's to the JAX server's)."""
    data = _nested_iptc(legacy.IPTC_LEVELS)
    assert np.array_equal(native.decode_image(data), _pil(_NEST_CORE))
    with pytest.raises(ValueError, match="levels of IPTC") as e:
        native.decode_image(_nested_iptc(legacy.IPTC_LEVELS + 1))
    assert not isinstance(e.value, native.UnsupportedImage)


def test_spider_orders_values_and_stacks():
    f = np.random.default_rng(5).normal(100, 150, (6, 9)).astype(np.float32)
    f[0, :3] = (np.nan, np.inf, -np.inf)
    for little in (False, True):
        data = spider(f, little)
        assert _same_as_pil(data)
        e = "<f" if little else ">f"
        for at, value in ((24, 1.0), (27, 2.0), (24, float("nan")),
                          (27, float("inf")), (5, 3.0), (12, 0.0),
                          (22, -8.0), (13, 0.5)):
            b = bytearray(data)
            struct.pack_into(e, b, 4 * (at - 1), value)
            if at == 22:
                struct.pack_into(e, b, 4 * 12, -1.0)
            assert _same_as_pil(bytes(b)), (little, at, value)


# --- the servers ---

@pytest.fixture(scope="module")
def srcnn_servers():
    """(JAX server port, port server port, port server): the SRCNN winner
    in float32 behind each HTTP front end."""
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


@pytest.mark.parametrize("name", ["tga_rgb", "dib_palette", "pcx_4plane",
                                  "dcx", "sgi_rle_rgb", "sun_rle_palette",
                                  "im_palette", "imt", "iptc_jpeg_band",
                                  "spider_le"])
def test_upload_answered_as_the_jax_server(srcnn_servers, name):
    """Both servers answer 200 and their bodies decode within 1 level of
    each other; for one upload in three the port's body is also the PNG of
    its engine's upscale of PIL's pixels, byte for byte (an SRCNN upscale
    takes most of a second on one thread); a cut stream is answered
    alike."""
    jport, pport, psrv = srcnn_servers
    data = (JPEG_ASSETS / GOLDENS[name]["file"]).read_bytes()
    (jcode, jbody), (pcode, pbody) = _post(jport, data), _post(pport, data)
    assert jcode == pcode == 200
    if name in ("tga_rgb", "sgi_rle_rgb", "iptc_jpeg_band"):
        assert pbody == native.encode_png_rgb8(psrv.upscale(_pil(data)),
                                               psrv.png_level)
    jpx = native.decode_image(jbody).astype(np.int16)
    ppx = native.decode_image(pbody).astype(np.int16)
    assert jpx.shape == ppx.shape and np.abs(jpx - ppx).max() <= 1
    cut = data[:len(data) // 2]
    assert _post(jport, cut)[0] == _post(pport, cut)[0]


def test_nested_iptc_answered_as_the_jax_server(srcnn_servers):
    """IPTC images nested ``IPTC_LEVELS`` deep around a JPEG are a 200
    from the JAX server (the port decodes them: the test above), one level
    more a 400 from both servers (the JAX server's PIL hits CPython's
    recursion limit there; before the port stopped its own walk, its
    server dropped the connection)."""
    jport, pport, _ = srcnn_servers
    assert _post(jport, _nested_iptc(legacy.IPTC_LEVELS))[0] == 200
    data = _nested_iptc(legacy.IPTC_LEVELS + 1)
    assert _post(jport, data)[0] == _post(pport, data)[0] == 400
