"""The port's request and dataset decoders (food101_sr_tpu_torch/native/)
on the streams the JAX package decodes: arithmetic-coded, CMYK/YCCK,
block-smoothed progressive, truncated and lossless JPEG (a stream cut
before its EOI and arithmetic coding past PIL's 64 KiB read block as
PIL's chunked feed decides them); 16-bit and Adam7-interlaced PNG; GIF;
BMP (WebP: tests/test_torch_webp.py). Each is held, at 0 levels, against the
JAX package's function for the same path: ``decode_jpeg_rgb8`` and
``decode_jpeg_crop_rgb8`` (its libjpeg binding, or the PIL fallback it
takes), and PIL's ``Image.open(...).convert("RGB")`` for what its server
and loader decode. libjpeg (through a small encoder built here with gcc)
and hand-assembled streams make the variants PIL does not write."""
import io
import json
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from food101_sr_tpu import native as jax_native
from food101_sr_tpu.data import Food101Source as JaxFood101
from food101_sr_tpu.data import SRDataLoader as JaxLoader
from food101_sr_tpu_torch import native
from food101_sr_tpu_torch.data import Food101Source, SRDataLoader

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import sha256  # noqa: E402
from tools.export_port_assets import _png, libjpeg_encoder, lossless_jpeg  # noqa: E402

JPEG_ASSETS = ROOT / "food101_sr_tpu_torch" / "assets" / "jpeg"
GOLDENS = json.loads((JPEG_ASSETS / "goldens.json").read_text())
# sampling factors of Y, Cb, Cr: 4:4:4, 4:2:0, 4:2:2, 4:4:0
LAYOUTS = [(1, 1, 1, 1, 1, 1), (2, 2, 1, 1, 1, 1), (2, 1, 1, 1, 1, 1),
           (1, 2, 1, 1, 1, 1)]


def _photo(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 100 * np.sin(xx[..., None] / 5.0 + np.arange(3)) \
        * np.cos(yy[..., None] / 7.0)
    return np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(
        np.uint8)


def _outcome(fn, *args):
    """fn's pixels, or the string "raises" (the kind of error differs
    between PIL and the port: the HTTP status is what they share)."""
    try:
        out = fn(*args)
    except (ValueError, OSError, SyntaxError):
        return "raises"
    return "raises" if out is None else np.asarray(out)


def _pil(data):
    return _outcome(lambda d: Image.open(io.BytesIO(d)).convert("RGB"), data)


def _same(a, b) -> bool:
    if isinstance(a, str) or isinstance(b, str):
        return isinstance(a, str) and isinstance(b, str)
    return a.shape == b.shape and np.array_equal(a, b)


@pytest.fixture(scope="module")
def enc():
    """libjpeg's encoder with the layouts, scripts and arithmetic coding
    PIL does not write."""
    try:
        return libjpeg_encoder()
    except Exception as e:  # noqa: BLE001 - no gcc or libjpeg headers here
        pytest.skip(f"libjpeg's encoder does not build here: {e}")


def _check_jpeg(data, crops=()):
    """decode_jpeg_rgb8 as the JAX package's, decode_image as PIL (the
    JAX server), and each region as the JAX package's region decode or,
    where that returns None, its loader's PIL fallback."""
    full = _outcome(jax_native.decode_jpeg_rgb8, data)
    assert _same(_outcome(native.decode_jpeg_rgb8, data), full)
    assert _same(_outcome(native.decode_image, data), _pil(data))
    for x0, y0, cw, ch in crops:
        want = _outcome(jax_native.decode_jpeg_crop_rgb8, data, x0, y0, cw,
                        ch)
        if isinstance(want, str) and not isinstance(full, str):
            want = full[y0:y0 + ch, x0:x0 + cw]
        got = _outcome(native.decode_jpeg_crop_rgb8, data, x0, y0, cw, ch)
        assert _same(got, want), (x0, y0, cw, ch)


def _regions(rng, h, w, n=3):
    out = []
    for _ in range(n):
        cw, ch = int(rng.integers(1, w + 1)), int(rng.integers(1, h + 1))
        out.append((int(rng.integers(0, w - cw + 1)),
                    int(rng.integers(0, h - ch + 1)), cw, ch))
    return out


# --- the committed streams (tools/export_port_assets.py --what jpeg) ---

@pytest.mark.parametrize("name", sorted(GOLDENS["streams"]))
def test_committed_stream_decodes_as_the_jax_package(name):
    g = GOLDENS["streams"][name]
    data = (JPEG_ASSETS / g["file"]).read_bytes()
    served = native.decode_image if "served_refused" not in g else None
    if served is None:
        with pytest.raises(ValueError) as e:
            native.decode_image(data)
        assert not isinstance(e.value, native.UnsupportedImage)
    else:
        px = native.decode_image(data)
        assert sha256(px) == g["served_sha256"]
        assert np.array_equal(px, _pil(data))
    if g["file"].endswith(".jpg") and g.get("binding_refused"):
        assert _outcome(jax_native.decode_jpeg_rgb8, data) == "raises"
        with pytest.raises(native.UnsupportedImage):
            native.decode_jpeg_rgb8(data)
    elif g["file"].endswith(".jpg"):
        px = native.decode_jpeg_rgb8(data)
        assert list(px.shape) == g["shape"] and sha256(px) == g["sha256"]
        assert np.array_equal(px, jax_native.decode_jpeg_rgb8(data))


@pytest.mark.parametrize("name", sorted({c["stream"] for c in
                                         GOLDENS["crops"]}))
def test_committed_stream_regions_match_the_jax_package(name):
    data = (JPEG_ASSETS / GOLDENS["streams"][name]["file"]).read_bytes()
    regions = [(c["x0"], c["y0"], c["cw"], c["ch"]) for c in GOLDENS["crops"]
               if c["stream"] == name]
    for c in (c for c in GOLDENS["crops"] if c["stream"] == name):
        got = native.decode_jpeg_crop_rgb8(data, c["x0"], c["y0"], c["cw"],
                                           c["ch"])
        assert sha256(got) == c["sha256"], c
    _check_jpeg(data, regions)


# --- JPEG families made here ---

@pytest.mark.parametrize("kind", ["baseline", "progressive", "arithmetic"])
def test_truncated_streams_decode_as_libjpeg_and_serve_400(enc, kind):
    """16 seeded cuts of each: libjpeg decodes what was read (the MCU the
    data runs out in from zero bits, with libjpeg-turbo's SIMD IDCT on its
    garbage, the rest gray or, for arithmetic coding, decoded from zero
    data), region decodes likewise; PIL, and so the server's decode,
    refuses the stream."""
    img = _photo(61, 75, 4)
    data = {"baseline": lambda: enc(img, 85),
            "progressive": lambda: enc(img, 85, prog=1, restart_rows=1),
            "arithmetic": lambda: enc(img, 85, prog=1, arith=1)}[kind]()
    rng = np.random.default_rng(len(kind))
    sos = data.index(b"\xff\xda")
    for cut in sorted(rng.integers(sos + 8, len(data) - 2, 16).tolist()):
        t = data[:cut]
        _check_jpeg(t, _regions(rng, 61, 75, 2))
        with pytest.raises(ValueError) as e:
            native.decode_image(t)
        assert not isinstance(e.value, native.UnsupportedImage)


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("restart", [0, 1])
def test_arithmetic_coding_matches_libjpeg(enc, progressive, restart):
    rng = np.random.default_rng(10 * progressive + restart)
    for (h, w), hv in zip([(1, 1), (9, 14), (33, 17), (40, 57)], LAYOUTS):
        data = enc(_photo(h, w, h + w), 80, hv=hv, prog=int(progressive),
                   arith=1, restart_rows=restart)
        assert data[data.index(b"\xff\xc9" if not progressive
                               else b"\xff\xca") + 1] in (0xC9, 0xCA)
        _check_jpeg(data, _regions(rng, h, w))


@pytest.mark.parametrize("script", ["unrefined", "dc_only"])
def test_block_smoothing_matches_libjpeg_and_pil(enc, script):
    """Progressive scripts that leave the first coefficients unrefined:
    libjpeg-turbo 2.1's smoothing for the JAX package's binding (its
    region decode starting the registers at the region's first iMCU
    column), 3.1's for PIL, at edges of every kind."""
    rng = np.random.default_rng(len(script))
    prog = 2 if script == "unrefined" else 3
    for i in range(10):
        h, w = int(rng.integers(1, 70)), int(rng.integers(1, 70))
        data = enc(_photo(h, w, i), 80, hv=LAYOUTS[i % 4], prog=prog,
                   arith=int(i % 3 == 0))
        _check_jpeg(data, _regions(rng, h, w))


@pytest.mark.parametrize("space", ["CMYK", "YCCK"])
def test_four_component_jpeg_matches_pil(enc, space):
    """The JAX package's libjpeg binding refuses CMYK and YCCK and falls
    back to PIL (inverted CMYK, Convert.c's cmyk2rgb); its loader crops
    PIL's full decode. A truncated one is refused, as PIL refuses it."""
    rng = np.random.default_rng(7)
    for h, w, prog in ((8, 8, 0), (23, 31, 1), (40, 17, 2)):
        cmyk = 255 - np.asarray(Image.fromarray(_photo(h, w, h)).convert(
            "CMYK"))
        data = enc(cmyk, 85, ycck=int(space == "YCCK"), prog=prog)
        _check_jpeg(data, _regions(rng, h, w))
        _check_jpeg(data[:len(data) * 3 // 4], _regions(rng, h, w, 1))


@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_jpeg_matches_pil(predictor):
    """SOF3, which only PIL's libjpeg-turbo 3 decodes (the JAX package's
    binding falls back to it): every predictor, a point transform,
    restarts, gray and RGB."""
    rng = np.random.default_rng(predictor)
    for n, pt, rst in ((1, 0, 0), (3, 1, 2), (3, 0, 1)):
        img = rng.integers(0, 256, (int(rng.integers(1, 12)),
                                    int(rng.integers(1, 12)), n), np.uint8)
        data = lossless_jpeg(img, predictor, pt, rst)
        _check_jpeg(data, _regions(rng, *img.shape[:2], 1))
        assert np.array_equal(native.decode_image(data)[..., :n],
                              (img >> pt << pt) if n == 3 else
                              np.repeat(img >> pt << pt, 1, 2))


# --- PNG, GIF and BMP against PIL ---

_PNG_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
              4: (2, (8, 16)), 6: (4, (8, 16))}


@pytest.mark.parametrize("color", sorted(_PNG_TYPES))
def test_png_every_depth_interlaced_or_not_matches_pil(color):
    rng = np.random.default_rng(color)
    ch, depths = _PNG_TYPES[color]
    for depth in depths:
        for interlace in (False, True):
            for h, w in ((1, 1), (5, 3), (9, 17)):
                vals = rng.integers(0, 1 << depth, (h, w, ch))
                if depth == 16 and color == 0:
                    vals %= 600  # I;16 clips at 255: both sides of it
                plte = rng.integers(0, 256, 3 << depth, np.uint8).tobytes() \
                    if color == 3 else b""
                data = _png(vals, depth, color, interlace, plte)
                assert np.array_equal(native.decode_image(data), _pil(data)), \
                    (depth, interlace, h, w)


def _lzw(idx, min_code):
    """A GIF LZW stream in sub-blocks (clear first, a clear when full)."""
    clear, end = 1 << min_code, (1 << min_code) + 1
    out, acc, nb = bytearray(), 0, 0

    def emit(code, size):
        nonlocal acc, nb
        acc |= code << nb
        nb += size
        while nb >= 8:
            out.append(acc & 255)
            acc >>= 8
            nb -= 8
    size, table, nxt, cur = min_code + 1, {}, end + 1, None
    emit(clear, size)
    for p in map(int, idx):
        if cur is None:
            cur = (p,)
            continue
        if cur + (p,) in table:
            cur += (p,)
            continue
        emit(table[cur] if len(cur) > 1 else cur[0], size)
        if nxt < 4096:
            table[cur + (p,)] = nxt
            if nxt == 1 << size and size < 12:
                size += 1
            nxt += 1
        else:
            emit(clear, size)
            size, table, nxt = min_code + 1, {}, end + 1
        cur = (p,)
    emit(table[cur] if len(cur) > 1 else cur[0], size)
    emit(end, size)
    if nb:
        out.append(acc & 255)
    return b"".join(bytes([len(out[i:i + 255])]) + out[i:i + 255]
                    for i in range(0, len(out), 255)) + b"\x00"


def _gif(frame, sw, sh, x0, y0, gpal=None, lpal=None, trans=None,
         interlace=False):
    fh, fw = frame.shape
    flags = 0x80 | (len(gpal) // 3).bit_length() - 2 if gpal else 0
    d = b"GIF89a" + struct.pack("<HHBBB", sw, sh, flags, 0, 0) + (gpal or b"")
    if trans is not None:
        d += b"\x21\xf9\x04" + bytes([1, 0, 0, trans]) + b"\x00"
    d += b"\x21\xfe\x05hello\x00"
    lflags = (0x80 | (len(lpal) // 3).bit_length() - 2) if lpal else 0
    d += b"\x2c" + struct.pack("<HHHHB", x0, y0, fw, fh,
                               lflags | (0x40 if interlace else 0))
    rows = [y for s, st in ((0, 8), (4, 8), (2, 4), (1, 2))
            for y in range(s, fh, st)] if interlace else list(range(fh))
    mc = max(2, int(frame.max()).bit_length())
    return d + (lpal or b"") + bytes([mc]) + _lzw(frame[rows].ravel(), mc) \
        + b"\x3b"


@pytest.mark.parametrize("palette", ["global", "local", "short", "none",
                                     "gray ramp", "transparent"])
def test_gif_first_frame_matches_pil(palette):
    """Logical screen larger than the frame, interlaced or not; indices
    past a short palette are black, no palette or a gray ramp is gray; a
    stream cut short is refused, as PIL refuses it."""
    rng = np.random.default_rng(len(palette))
    for i in range(6):
        fh, fw = int(rng.integers(1, 30)), int(rng.integers(1, 30))
        nb = int(rng.integers(2 if palette == "short" else 1, 9))
        frame = rng.integers(0, 1 << nb, (fh, fw)).astype(np.uint8)
        if i % 2:
            frame = frame // 4 * 4  # runs: long strings, a full table
        pal = rng.integers(0, 256, 3 << nb, np.uint8).tobytes()
        kw = dict(sw=fw + int(rng.integers(0, 4)),
                  sh=fh + int(rng.integers(0, 4)), x0=int(rng.integers(0, 4)),
                  y0=int(rng.integers(0, 4)), interlace=bool(i % 2))
        kw.update({"global": dict(gpal=pal),
                   "local": dict(lpal=pal, gpal=bytes(range(12))),
                   "short": dict(gpal=pal[:len(pal) // 2]),
                   "none": {},
                   "gray ramp": dict(gpal=bytes(x for v in range(1 << nb)
                                                for x in (v,) * 3)),
                   "transparent": dict(gpal=pal, trans=int(
                       rng.integers(0, 1 << nb)))}[palette])
        data = _gif(frame, **kw)
        for d in (data, data[:len(data) * 2 // 3]):
            assert _same(_outcome(native.decode_image, d), _pil(d))
    buf = io.BytesIO()
    Image.fromarray(_photo(21, 19, 3)).convert("P").save(buf, format="GIF")
    assert np.array_equal(native.decode_image(buf.getvalue()),
                          _pil(buf.getvalue()))


def _bmp(img, bits, hsize=40, comp=0, top_down=False, colors=None, pal=None,
         masks=(0, 0, 0, 0), body=None):
    """A BMP of ``img`` (indices, 16/32-bit words or RGB) with header size
    ``hsize``; ``body`` replaces the raw rows (RLE)."""
    h, w = img.shape[:2]
    stride = ((w * bits + 31) >> 3) & ~3
    rows = []
    for row in (img if top_down else img[::-1]):
        if bits <= 8:
            per = 8 // bits
            v = np.concatenate([row, np.zeros(-w % per, row.dtype)]).reshape(
                -1, per)
            b = (v << np.arange(8 - bits, -1, -bits)).sum(1).astype(
                np.uint8).tobytes()
        elif bits == 24:
            b = row[:, ::-1].astype(np.uint8).tobytes()
        else:
            b = row.astype("<u2" if bits == 16 else "<u4").tobytes()
        rows.append(b + bytes(stride - len(b)))
    pix = body if body is not None else b"".join(rows)
    palb = b""
    if pal is not None:
        palb = b"".join(bytes([b, g, r]) + (b"" if hsize == 12 else b"\0")
                        for r, g, b in pal.tolist())
    if hsize == 12:
        hdr = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        hdr = struct.pack("<IiiHHIIiiII", hsize, w, -h if top_down else h, 1,
                          bits, comp, len(pix), 2835, 2835, colors or 0, 0)
        if hsize == 40 and comp == 3:
            hdr += struct.pack("<III", *masks[:3])
        elif hsize > 40:
            hdr += (struct.pack("<IIII", *masks) + bytes(84))[:hsize - 40]
    off = 14 + len(hdr) + len(palb)
    return b"BM" + struct.pack("<IHHI", off + len(pix), 0, 0, off) + hdr \
        + palb + pix


def _rle(rows, rle4):
    """Runs, absolute runs and end-of-line codes, then end of bitmap."""
    out = bytearray()
    for r in rows:
        x, w = 0, len(r)
        while x < w:
            n = min(w - x, 7)
            if x % 3 == 2 and n >= 3:
                seg = list(r[x:x + n]) + [0] * (n % 2 if rle4 else 0)
                body = bytes((seg[i] << 4) | seg[i + 1]
                             for i in range(0, len(seg), 2)) if rle4 \
                    else bytes(seg)
                out += bytes([0, n]) + body + b"\0" * (len(body) % 2)
            else:
                n = 1 + (x % 4)
                n = min(n, w - x)
                v = int(r[x])
                out += bytes([n, (v << 4) | v if rle4 else v])
            x += n
        out += b"\0\0"
    return bytes(out) + b"\0\1"


@pytest.mark.parametrize("variant", ["1-bit", "4-bit", "8-bit", "gray",
                                     "16-bit", "24-bit", "32-bit",
                                     "bitfields", "RLE8", "RLE4", "top-down",
                                     "truncated"])
def test_bmp_matches_pil(variant):
    """Every header size PIL reads (12, 40, 56, 108, 124), palettes (gray
    ones read as PIL's "L" or "1"), 5-5-5, 5-6-5 and byte-aligned 32-bit
    masks, PIL's RLE decoder, both row orders; a file cut short."""
    rng = np.random.default_rng(len(variant))
    for i, hsize in enumerate((12, 40, 56, 108, 124)):
        h, w = int(rng.integers(1, 20)), int(rng.integers(1, 20))
        td = variant == "top-down" and hsize != 12
        if variant in ("1-bit", "4-bit", "8-bit", "gray", "RLE8", "RLE4"):
            bits = {"1-bit": 1, "4-bit": 4, "RLE4": 4}.get(variant, 8)
            colors = None if i % 2 else int(rng.integers(2, (1 << bits) + 1))
            n = colors or 1 << bits
            pal = rng.integers(0, 256, (n, 3))
            if variant == "gray":
                pal = np.repeat(np.arange(n)[:, None], 3, 1)
            idx = rng.integers(0, n, (h, w))
            rle = variant.startswith("RLE")
            data = _bmp(idx, bits, 40 if rle else hsize,
                        (2 if bits == 4 else 1) if rle else 0, colors=colors,
                        pal=pal, body=_rle(idx[::-1], bits == 4) if rle
                        else None)
        elif variant in ("16-bit", "32-bit"):
            data = _bmp(rng.integers(0, 1 << (16 if variant == "16-bit"
                                              else 32), (h, w)),
                        16 if variant == "16-bit" else 32, hsize)
        elif variant == "bitfields":
            masks = [(0xF800, 0x7E0, 0x1F, 0), (0x7C00, 0x3E0, 0x1F, 0),
                     (0xFF0000, 0xFF00, 0xFF, 0), (0xFF, 0xFF00, 0xFF0000,
                                                   0xFF000000),
                     (0xFF000000, 0xFF0000, 0xFF00, 0)][i]
            bits = 16 if i < 2 else 32
            data = _bmp(rng.integers(0, 1 << bits, (h, w)), bits,
                        (40, 56, 108, 124, 40)[i], comp=3, masks=masks)
        else:
            data = _bmp(rng.integers(0, 256, (h, w, 3)), 24, hsize,
                        top_down=td)
            if variant == "truncated":
                data = data[:-int(rng.integers(1, 12))]
        assert _same(_outcome(native.decode_image, data), _pil(data)), hsize
    for mode in ("1", "L", "P", "RGB", "RGBA"):
        buf = io.BytesIO()
        Image.fromarray(_photo(13, 17, 1)).convert(mode).save(buf,
                                                              format="BMP")
        assert np.array_equal(native.decode_image(buf.getvalue()),
                              _pil(buf.getvalue()))


# --- the loader ---

def test_loader_over_arithmetic_and_cmyk_files_equals_jax():
    """The committed mini tree holds an arithmetic-coded train image (the
    JAX package's libjpeg region path) and a CMYK one (its PIL fallback):
    two batches, train and eval, equal the JAX package's loader's."""
    tree = JPEG_ASSETS / "food-101" / "images"
    heads = [p.read_bytes()[:4096] for p in sorted(tree.rglob("*.jpg"))]
    assert any(b"\xff\xc9" in h for h in heads)
    assert any(b"Adobe" in h for h in heads)
    for train in (True, False):
        kw = dict(crop_size=200, batch_size=8, train=train, seed=0,
                  num_workers=2)
        ours = SRDataLoader(Food101Source(str(JPEG_ASSETS), "train"),
                            device="cpu", **kw)
        theirs = JaxLoader(JaxFood101(str(JPEG_ASSETS), "train"), **kw)
        ours.set_epoch(0)
        theirs.set_epoch(0)
        for (a, b), _ in zip(zip(ours, theirs), range(2)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_refusals_the_jax_package_makes_too():
    """12-bit, hierarchical and arithmetic-coded lossless streams: the JAX
    package's libjpeg refuses them and so does PIL; the port's dataset
    decoder names them (UnsupportedImage), its request decoder refuses the
    first two as PIL does (ValueError: the JAX server answers 400) and
    names SOF11, which no tool here writes, so PIL's answer to a real one
    is unknown."""
    buf = io.BytesIO()
    Image.fromarray(_photo(16, 16, 0)).save(buf, format="JPEG")
    base = buf.getvalue()
    i = base.index(b"\xff\xc0")
    for patch, name in (((i + 4, 12), "12-bit"), ((i + 1, 0xC5),
                                                  "hierarchical"),
                        ((i + 1, 0xCB), "SOF11")):
        data = base[:patch[0]] + bytes([patch[1]]) + base[patch[0] + 1:]
        assert _pil(data) == "raises"
        if name == "SOF11":
            with pytest.raises(native.UnsupportedImage, match=name):
                native.decode_image(data)
        else:
            with pytest.raises(ValueError, match=name) as e:
                native.decode_image(data)
            assert not isinstance(e.value, native.UnsupportedImage)
        with pytest.raises(native.UnsupportedImage, match=name):
            native.decode_jpeg_rgb8(data)


@pytest.mark.parametrize("kind", ["baseline", "restarts", "gray", "q95",
                                  "progressive"])
def test_cut_before_eoi_decodes_where_pil_does(enc, kind):
    """Streams cut just before their EOI marker: PIL decodes a sequential
    single-scan one when libjpeg-turbo's reader (its read-ahead, fast and
    slow paths over PIL's 64 KiB blocks) never asked for a byte past the
    end; a multi-scan one never. The port decodes exactly those, to PIL's
    pixels, and refuses the others with ValueError (400)."""
    rng = np.random.default_rng(31 + len(kind))
    decoded = 0
    for k in range(24):
        h, w = (int(v) for v in rng.integers(8, 90, 2))
        img = _photo(h, w, 100 * len(kind) + k)
        data = {"baseline": lambda: enc(img, 85),
                "restarts": lambda: enc(img, 70, restart_rows=1),
                "gray": lambda: _pil_gray(img),
                "q95": lambda: enc(img, 95),
                "progressive": lambda: enc(img, 85, prog=1)}[kind]()
        assert data.endswith(b"\xff\xd9")
        cut = data[:-2]
        want, got = _pil(cut), _outcome(native.decode_image, cut)
        assert _same(want, got), k
        decoded += not isinstance(want, str)
        _refused_as_400(cut, want)
        # the binding decodes every one of them, as the JAX package's does
        assert np.array_equal(native.decode_jpeg_rgb8(cut),
                              jax_native.decode_jpeg_rgb8(cut))
    assert (decoded == 0) == (kind == "progressive")


def _refused_as_400(data, pil_outcome):
    """Where PIL refuses, the port's request decoder raises ValueError, not
    UnsupportedImage: the server answers 400, as the JAX server does."""
    if isinstance(pil_outcome, str):
        with pytest.raises(ValueError) as e:
            native.decode_image(data)
        assert not isinstance(e.value, native.UnsupportedImage)


def _pil_gray(img):
    buf = io.BytesIO()
    Image.fromarray(img[..., 0]).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def test_large_streams_cut_short_decode_where_pil_does(enc):
    """Streams past PIL's first 64 KiB block (its feed suspends the reader
    there, and the fast path reads 6 bytes at a time while 512 per block
    are fed), cut before their EOI or a few bytes earlier."""
    rng = np.random.default_rng(41)
    decoded = past = 0
    for k in range(48):
        h, w = (int(v) for v in rng.integers(200, 420, 2))
        img = _photo(h, w, 500 + k)
        data = enc(img, 97) if k % 2 else enc(img, 90, restart_rows=2)
        past += len(data) > 65536
        cut = data[:-2] if k % 4 < 2 else data[:-int(rng.integers(3, 12))]
        want = _pil(cut)
        assert _same(want, _outcome(native.decode_image, cut)), k
        decoded += not isinstance(want, str)
    assert 0 < decoded < 48 and past > 16


def test_arithmetic_uploads_past_pil_read_block(enc):
    """PIL feeds libjpeg 64 KiB at a time and its arithmetic decoder cannot
    suspend: an upload whose scan needs a byte past the block it was fed
    fails there (the JAX server answers 400). Seeded streams on both sides
    of the boundary, sequential, progressive and with restarts: the port's
    request decoder refuses exactly those, the binding decodes them all."""
    rng = np.random.default_rng(43)
    outcomes = set()
    for k in range(15):
        side = int(rng.integers(230, 330))
        img = _photo(side, side + 20, 600 + k)
        data = [lambda: enc(img, 95, arith=1),
                lambda: enc(img, 92, arith=1, prog=1),
                lambda: enc(img, 95, arith=1, restart_rows=1)][k % 3]()
        want = _pil(data)
        assert _same(want, _outcome(native.decode_image, data)), k
        _refused_as_400(data, want)
        outcomes.add((len(data) > 65536, isinstance(want, str)))
        assert np.array_equal(native.decode_jpeg_rgb8(data),
                              jax_native.decode_jpeg_rgb8(data))
    assert {(False, False), (True, True)} <= outcomes
