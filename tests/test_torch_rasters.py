"""The port's Netpbm, ICO, CUR and QOI decoders (food101_sr_tpu_torch/
native/rasters.py, QOI's ops in native/fast_tiff.cpp) against PIL, which
the JAX package's server decodes uploads with: every committed stream
pixel-equal to PIL live and to its golden; P1-P6 at every kind of maxval,
plain rasters with comments, PFM in both byte orders and PIL's own
P0CMYK/PyP/PyRGBA/PyCMYK; the ICO entry PIL chooses (PNG and BMP payloads,
their AND masks and alpha bytes) and CUR's; QOI's ops at seeded images;
header edge cases, truncations and bit flips refused exactly where PIL
refuses them; one upload of each format answered alike by the port's and
the JAX package's servers; and a .ppm through the port's predict."""
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

from food101_sr_tpu_torch import native, predict, serve
from food101_sr_tpu_torch.serving import SRServer

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import serve as jax_serve  # noqa: E402
from chip_smoke import sha256  # noqa: E402
from tools.raster_writers import dib, ico, netpbm, pfm, qoi  # noqa: E402

JPEG_ASSETS = ROOT / "food101_sr_tpu_torch" / "assets" / "jpeg"
GOLDENS = json.loads((JPEG_ASSETS / "goldens.json").read_text())["streams"]
RASTERS = sorted(n for n, g in GOLDENS.items() if g["file"].rsplit(".", 1)[1]
                 in ("ppm", "pgm", "pbm", "pfm", "ico", "cur", "qoi"))
ASSET = ROOT / "food101_sr_tpu_torch" / "assets" / "winner_srcnn.pth"
CHECKPOINT = ROOT / "weights" / "winner_srcnn_best"


def _outcome(fn, data):
    try:
        return np.asarray(fn(data))
    except native.UnsupportedImage:
        return "415"
    except Exception:  # PIL raises OSError, ValueError, IndexError, ...
        return "raises"


def _pil(data):
    return _outcome(lambda d: Image.open(io.BytesIO(d)).convert("RGB"), data)


def _same_as_pil(data) -> bool:
    a, b = _pil(data), _outcome(native.decode_image, data)
    if isinstance(a, str) or isinstance(b, str):
        return (a if isinstance(a, str) else "px") == \
            (b if isinstance(b, str) else "px")
    return a.shape == b.shape and np.array_equal(a, b)


def _rng_img(h, w, c, seed, top=256):
    return np.random.default_rng(seed).integers(0, top, (h, w, c))


# --- the committed streams ---

def test_committed_streams_cover_each_format():
    kinds = {GOLDENS[n]["file"].rsplit(".", 1)[1] for n in RASTERS}
    assert kinds == {"ppm", "pgm", "pbm", "pfm", "ico", "cur", "qoi"}


@pytest.mark.parametrize("name", RASTERS)
def test_committed_stream_matches_pil_and_its_golden(name):
    g = GOLDENS[name]
    data = (JPEG_ASSETS / g["file"]).read_bytes()
    px = native.decode_image(data)
    assert list(px.shape) == g["shape"] and sha256(px) == g["served_sha256"]
    assert np.array_equal(px, _pil(data))


# --- Netpbm ---

@pytest.mark.parametrize("maxval", [1, 7, 100, 254, 255, 256, 1000, 65534,
                                    65535])
def test_netpbm_maxvals(maxval):
    """Gray and RGB, plain and binary: maxval 255 read raw, 65535 gray as
    PIL's I;16B, others scaled with Python's rounding (gray above 255 to
    PIL's mode I, clipped to 255 by convert)."""
    g = _rng_img(7, 11, 1, maxval, maxval + 1)[..., 0]
    c = _rng_img(7, 11, 3, maxval + 1, maxval + 1)
    for magic, s in ((b"P2", g), (b"P5", g), (b"P3", c), (b"P6", c)):
        assert _same_as_pil(netpbm(magic, s, maxval)), magic
        assert _same_as_pil(netpbm(magic, s, maxval, comment=True)), magic


def test_netpbm_bitmaps_pfm_and_pil_extensions():
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, (9, 13))
    for magic in (b"P1", b"P4"):
        assert _same_as_pil(netpbm(magic, bits))
    f = rng.normal(100, 150, (9, 13)).astype(np.float32)
    f[0, :3] = (np.nan, np.inf, -np.inf)
    assert _same_as_pil(pfm(f, True)) and _same_as_pil(pfm(f, False))
    px = _rng_img(5, 6, 4, 2).astype(np.uint8)
    for head in (b"P0CMYK 6 5 255\n", b"PyCMYK 6 5 255\n",
                 b"PyRGBA 6 5 255\n"):
        assert _same_as_pil(head + px.tobytes()), head
    assert _same_as_pil(b"PyP 6 5 255\n" + px[..., 0].tobytes())
    assert _same_as_pil(b"P0CMYK 6 5 100\n" + (px // 3).tobytes())


@pytest.mark.parametrize("data", [
    b"P5 1#x\n1 2#c\n55 255\n" + bytes(121),   # a comment inside a token
    b"P5\t3\x0b2\x0c255\r" + bytes(6),
    b"P3 2 1 255 1 2 3 4 5 6",                 # no final newline
    b"P3 2 1 255 1 2 3\n#a\n4 5 6 7 8 9 junk",  # values past the image
    b"P2 2 2 100\n# in the raster\n1 2\n3 100\n",
    b"P2 2 1 10\n5#c\n6\n",                   # a comment joins 5 and 6
    b"P1\n2 2\n0110\n", b"P1 2 2 0 1 1 0 2", b"P1 2 2 01",
    b"P2 2 2 255\n1 2 3 x\n", b"P2 2 2 255\n1 2 3 256\n",
    b"P2 2 2 255\n1 2 3 -4\n", b"P2 1 1 255\n12345678901\n",
    b"P6 2 2 0\n" + bytes(12), b"P6 2 2 65536\n" + bytes(12),
    b"P6 0 2 255\n", b"P6 -1 2 255\n", b"P6 12345678901 2 255\n",
    b"P6 2 2 255", b"P6 2 2 255\n" + bytes(11), b"P5 2 2 1000\n" + bytes(7),
    b"Pf 2 2 0.0\n" + bytes(16), b"Pf 2 2 nan\n" + bytes(16),
    b"Pf 2 2 -1e3\n" + bytes(15), b"P7\nWIDTH 2\n", b"P8 2 2 255\n",
    b"Px 1 1 255\n\x00\x00\x00", b"Py\n", b"P4 9 2\n\xff\x80\x00\x7f",
    b"P4 9 2\n\xff\x80\x00"], ids=lambda d: repr(d[:14]))
def test_netpbm_headers_and_rasters_as_pil_reads_them(data):
    assert _same_as_pil(data)


# --- ICO and CUR ---

def _png(img):
    buf = io.BytesIO()
    Image.fromarray(img.astype(np.uint8)).save(buf, "PNG")
    return buf.getvalue()


def test_ico_entry_choice_and_payloads():
    """PIL opens the largest entry, then the shallowest of the largest; a
    PNG payload, or a DIB (8-bit palette, 24- and 32-bit) with its AND
    mask; an entry whose directory size disagrees with its PNG's."""
    rng = np.random.default_rng(2)
    a = _rng_img(16, 16, 3, 3).astype(np.uint8)
    b = _rng_img(32, 32, 3, 4).astype(np.uint8)
    rgba = _rng_img(32, 32, 4, 5).astype(np.uint8)
    pal = rng.integers(0, 256, (256, 3))
    mask = rng.integers(0, 2, (32, 32)).astype(np.uint8)
    cases = [
        [(16, 16, 0, 24, dib(a, 24)), (32, 32, 0, 24, dib(b, 24))],
        [(32, 32, 0, 24, dib(b, 24)), (32, 32, 0, 8, dib(b[..., 0], 8, pal))],
        [(32, 32, 0, 32, dib(rgba, 32)), (32, 32, 16, 0, dib(b, 24))],
        [(32, 32, 0, 32, _png(rgba)), (16, 16, 0, 32, _png(a))],
        [(32, 32, 0, 8, dib(b[..., 1], 8, pal, mask))],
        [(16, 16, 0, 32, _png(b))],          # PNG larger than its entry
        [(0, 0, 0, 32, _png(_rng_img(256, 256, 3, 6)))],  # 0 means 256
    ]
    for entries in cases:
        assert _same_as_pil(ico(entries)), [e[:4] for e in entries]
    buf = io.BytesIO()
    Image.fromarray(rgba).save(buf, "ICO", sizes=[(16, 16), (32, 32)])
    assert _same_as_pil(buf.getvalue())


def test_cur_entry_choice():
    """CUR: the first entry, replaced by a later one larger in both
    directory bytes (0 stays 0); a BMP always, 32-bit BGRA where the
    bitmap sits at offset 22."""
    a = _rng_img(16, 16, 3, 7).astype(np.uint8)
    b = _rng_img(32, 24, 3, 8).astype(np.uint8)
    rgba = _rng_img(16, 16, 4, 9).astype(np.uint8)
    for entries in ([(16, 16, 0, 24, dib(a, 24)), (24, 32, 0, 24, dib(b, 24))],
                    [(24, 32, 0, 24, dib(b, 24)), (16, 16, 0, 24, dib(a, 24))],
                    [(16, 16, 0, 32, dib(rgba, 32))],
                    [(16, 16, 0, 32, _png(rgba))]):
        assert _same_as_pil(ico(entries, cursor=True))


def test_ico_cur_truncated_and_malformed():
    """A cut AND mask, a cut bitmap, a directory past the file, an entry
    count of 0 or more than the file holds, a header size PIL does not
    know."""
    a = _rng_img(16, 16, 3, 10).astype(np.uint8)
    for cursor in (False, True):
        data = ico([(16, 16, 0, 24, dib(a, 24))], cursor)
        for cut in (5, 20, 60, len(data) - 70, len(data) - 1):
            assert _same_as_pil(data[:cut]), (cursor, cut)
        assert _same_as_pil(data[:4] + b"\x00\x00" + data[6:])
        assert _same_as_pil(data[:4] + b"\x05\x00" + data[6:])
        assert _same_as_pil(data[:22] + b"\x10" + data[23:])


# --- QOI ---

@pytest.mark.parametrize("seed", range(4))
def test_qoi_ops(seed):
    """Noise (RGB and RGBA ops), flat runs longer than 62, gradients (DIFF
    and LUMA), repeated colours (INDEX), alpha changes; a channels byte
    other than 3 or 4 (PIL: RGBA)."""
    rng = np.random.default_rng(seed)
    h, w = 23, 37
    img = np.zeros((h, w, 4), np.uint8)
    img[..., 3] = 255
    img[:5] = rng.integers(0, 256, (5, w, 4))
    img[5:9] = np.arange(w)[None, :, None] * (seed + 1)
    img[9:14] = rng.integers(0, 4, (5, w, 4)) * 60
    img[14:18, :, 3] = rng.integers(250, 256, (4, w))
    for data in (qoi(img[..., :3]), qoi(img)):
        assert _same_as_pil(data)
        assert _same_as_pil(data[:12] + b"\x07" + data[13:])
    # an INDEX op for a slot never written: PIL's (0, 0, 0, 0)
    assert _same_as_pil(b"qoif" + struct.pack(">II", 2, 1) + b"\x04\x00"
                        + b"\x05\xfe\x01\x02\x03" + bytes(7) + b"\x01")


# --- truncations and bit flips ---

@pytest.mark.parametrize("kind", ["p6", "p5_16", "p5_1000", "p3", "p1",
                                  "pfm", "ico_png", "ico_bmp", "cur", "qoi"])
def test_truncations_and_bit_flips_refused_where_pil_refuses(kind):
    """Seeded cuts and bit flips: the port raises ValueError exactly where
    PIL raises (QOI's op stream cut short, a header PIL cannot parse, a
    PNG payload's CRC), never crashes, and decodes the rest to PIL's
    pixels."""
    img = _rng_img(12, 17, 3, 11)
    data = {"p6": lambda: netpbm(b"P6", img, 255),
            "p5_16": lambda: netpbm(b"P5", img[..., 0] * 200, 65535),
            "p5_1000": lambda: netpbm(b"P5", img[..., 0] * 3, 1000),
            "p3": lambda: netpbm(b"P3", img, 255, comment=True),
            "p1": lambda: netpbm(b"P1", img[..., 0] > 100),
            "pfm": lambda: pfm(img[..., 0].astype(np.float32) - 20, True),
            "ico_png": lambda: ico([(17, 12, 0, 32, _png(img))]),
            "ico_bmp": lambda: ico([(16, 12, 0, 24,
                                     dib(img[:, :16].astype(np.uint8), 24))]),
            "cur": lambda: ico([(16, 12, 0, 24,
                                 dib(img[:, :16].astype(np.uint8), 24))],
                               cursor=True),
            "qoi": lambda: qoi(img.astype(np.uint8))}[kind]()
    rng = np.random.default_rng(len(kind))
    for k in range(60):
        b = bytearray(data)
        if k % 3 == 0:
            b = b[:int(rng.integers(1, len(b)))]
        else:
            for _ in range(1 + k % 2):
                b[int(rng.integers(2, len(b)))] ^= 1 << int(rng.integers(0, 8))
        assert _same_as_pil(bytes(b)), k
        got = _outcome(native.decode_image, bytes(b))
        assert not (isinstance(got, str) and got == "415"), k


# --- the entry points ---

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


@pytest.mark.parametrize("name", ["ppm_binary", "pgm16", "ico_png",
                                  "cur_bmp", "qoi_rgba"])
def test_upload_answered_as_the_jax_server(srcnn_servers, name):
    """Both servers answer 200; the port's body is the PNG of its engine's
    upscale of PIL's pixels, byte for byte, and the two bodies decode
    within 1 level of each other; a cut stream is a 400 on both."""
    jport, pport, psrv = srcnn_servers
    data = (JPEG_ASSETS / GOLDENS[name]["file"]).read_bytes()
    (jcode, jbody), (pcode, pbody) = _post(jport, data), _post(pport, data)
    assert jcode == pcode == 200
    assert pbody == native.encode_png_rgb8(psrv.upscale(_pil(data)),
                                           psrv.png_level)
    jpx = native.decode_image(jbody).astype(np.int16)
    ppx = native.decode_image(pbody).astype(np.int16)
    assert jpx.shape == ppx.shape and np.abs(jpx - ppx).max() <= 1
    cut = data[:len(data) // 2]
    assert _post(jport, cut)[0] == _post(pport, cut)[0] == 400


def test_predict_upscales_a_ppm(tmp_path, capsys):
    src, out = tmp_path / "in", tmp_path / "out"
    src.mkdir()
    data = (JPEG_ASSETS / GOLDENS["ppm_binary"]["file"]).read_bytes()
    (src / "plate.ppm").write_bytes(data)
    predict.main([str(src / "*.ppm"), "--out_dir", str(out),
                  "--architecture", "SRCNN", "--tile", "16", "--max_batch",
                  "4", "--dtype", "float32", "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["n_images"] == 1 and summary["failed"] == 0
    ref = SRServer("SRCNN", dtype=torch.float32, device="cpu", tile=16,
                   max_batch=4)
    try:
        got = native.decode_image((out / "plate_x4.png").read_bytes())
        assert np.array_equal(got, ref.upscale(_pil(data)))
    finally:
        ref.close()


def test_png_chunks_after_the_image_data_are_not_read():
    """The repair behind the ICO's PNG payloads, for every PNG upload: PIL
    checks the CRCs of the chunks before the image data only, and reads
    nothing after it, so a PNG with a bad IDAT or IEND CRC, a cut IEND or
    none decodes on the JAX server; the port answered 400 before."""
    img = _rng_img(8, 9, 3, 12).astype(np.uint8)
    data = _png(img)
    i = data.index(b"IDAT")
    n = struct.unpack(">I", data[i - 4:i])[0]
    crc = i + 4 + n  # the IDAT's CRC
    cases = [data[:crc + 4], data[:crc], data[:-2],
             data[:-1] + bytes([data[-1] ^ 1]),
             data[:crc] + bytes([data[crc] ^ 1]) + data[crc + 1:]]
    for case in cases:
        assert np.array_equal(native.decode_image(case), img)
        assert _same_as_pil(case)
    bad = bytearray(data)
    bad[20] ^= 1  # IHDR's CRC is checked
    assert _same_as_pil(bytes(bad)) and _pil(bytes(bad)) == "raises"
