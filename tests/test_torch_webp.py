"""The port's WebP decoder (food101_sr_tpu_torch/native/fast_webp.cpp and
the container in native/__init__.py) against PIL, which the JAX package's
server decodes uploads with (libwebp 1.6 behind it): every committed
stream (tools/export_port_assets.py --what jpeg) pixel-equal to PIL live
and to its golden, each lossy one's Y/U/V planes equal to libwebp's
WebPDecodeYUV (the wheel's library through ctypes); encoder settings PIL
does not expose, made here by libwebp's encoder; the alpha filters and
codings; container layouts libwebp's demuxer accepts or refuses; seeded
truncations and bit flips refused exactly where PIL refuses them; a WebP
upload answered alike by the port's and the JAX package's servers; and
a .webp through the port's predict."""
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
from tools.export_port_assets import (libwebp, webp_anmf, webp_chunks,  # noqa: E402
                                      webp_file, webp_lossless_alpha,
                                      webp_raw_alpha, webp_vp8x)

JPEG_ASSETS = ROOT / "food101_sr_tpu_torch" / "assets" / "jpeg"
GOLDENS = json.loads((JPEG_ASSETS / "goldens.json").read_text())["streams"]
WEBP = sorted(n for n, g in GOLDENS.items() if g["file"].endswith(".webp"))
ASSET = ROOT / "food101_sr_tpu_torch" / "assets" / "winner_srcnn.pth"
CHECKPOINT = ROOT / "weights" / "winner_srcnn_best"


@pytest.fixture(scope="module")
def lib():
    try:
        return libwebp()
    except OSError as e:
        pytest.skip(f"PIL's wheel has no libwebp here: {e}")


def _photo(h, w, seed, noise=12):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(xx / 7.0 + c) * 60 + np.cos(yy / 9.0 - c) * 50
                     + 128 for c in range(3)], 2)
    return np.clip(base + rng.normal(0, noise, (h, w, 3)), 0, 255).astype(
        np.uint8)


def _outcome(fn, data):
    """fn's pixels, or "raises" (the kind of error differs between PIL and
    the port: the HTTP status, 400, is what they share)."""
    try:
        return np.asarray(fn(data))
    except native.UnsupportedImage:
        return "415"
    except (ValueError, OSError, EOFError, SyntaxError):
        return "raises"


def _pil(data):
    return _outcome(lambda d: Image.open(io.BytesIO(d)).convert("RGB"), data)


def _same_as_pil(data) -> bool:
    a, b = _pil(data), _outcome(native.decode_image, data)
    if isinstance(a, str) or isinstance(b, str):
        return a == b
    return a.shape == b.shape and np.array_equal(a, b)


def _check(data, lib=None):
    """decode_image equals PIL; a lossy still's planes equal libwebp's."""
    assert _same_as_pil(data)
    if lib is not None:
        for got, want in zip(native.decode_webp_yuv(data),
                             lib.decode_yuv(data)):
            np.testing.assert_array_equal(got, want)


# --- the committed streams ---

@pytest.mark.parametrize("name", WEBP)
def test_committed_stream_matches_pil_and_its_golden(name, lib):
    g = GOLDENS[name]
    data = (JPEG_ASSETS / g["file"]).read_bytes()
    px = native.decode_image(data)
    assert list(px.shape) == g["shape"] and sha256(px) == g["served_sha256"]
    assert np.array_equal(px, _pil(data))
    if "yuv_sha256" in g:
        planes = native.decode_webp_yuv(data)
        for got, want in zip(planes, lib.decode_yuv(data)):
            np.testing.assert_array_equal(got, want)
        assert sha256(np.concatenate([p.ravel() for p in planes])) == \
            g["yuv_sha256"]


def test_committed_streams_cover_each_kind():
    """One stream per decoder feature, so the card holds each to its
    golden: VP8 with each filter, segment and partition setting, VP8L,
    ALPH raw and coded with each filter, VP8X, animation."""
    data = {n: (JPEG_ASSETS / GOLDENS[n]["file"]).read_bytes() for n in WEBP}
    tags = {n: [t for t, _ in webp_chunks(d)] for n, d in data.items()}
    alph = [p[0] for d in data.values() for t, p in webp_chunks(d)
            if t == b"ALPH"]  # the ALPH header byte of each still
    assert {p & 3 for p in alph} == {0, 1}  # raw and VP8L-coded
    assert {(p >> 2) & 3 for p in alph if p & 3} == {0, 1, 2, 3}
    assert {(p >> 2) & 3 for p in alph if not p & 3} == {0, 1, 2, 3}
    assert any(p >> 4 for p in alph)  # the pre-processing bit
    assert any(b"ANMF" in t for t in tags.values())
    assert any(t[:1] == [b"VP8L"] for t in tags.values())
    assert any(b"ICCP" in t and b"EXIF" in t for t in tags.values())
    vp8 = [dict(webp_chunks(d))[b"VP8 "] for n, d in data.items()
           if b"VP8 " in tags[n]]
    assert max(len(p) for p in vp8) > 4000  # the 512x384


# --- lossy: settings PIL's save does not expose (libwebp's encoder) ---

@pytest.mark.parametrize("cfg", [
    {"filter_type": 0}, {"filter_type": 0, "filter_strength": 100,
                         "filter_sharpness": 3},
    {"filter_strength": 0}, {"filter_sharpness": 7}, {"segments": 1},
    {"segments": 4, "sns_strength": 100}, {"partitions": 2},
    {"partitions": 3}, {"quality": 0}, {"quality": 100}, {"method": 0},
    {"method": 6}, {"autofilter": 1}, {"preprocessing": 2}],
    ids=lambda c: ",".join(f"{k}={v}" for k, v in c.items()))
def test_lossy_settings_planes_and_pixels_equal_libwebp(lib, cfg):
    """Each at an even and at an odd size (the upsampler's last row and
    column, the right macroblock's above-right samples)."""
    for i, (h, w) in enumerate(((96, 80), (37, 53))):
        _check(lib.encode(_photo(h, w, i, 20), **cfg), lib)


@pytest.mark.parametrize("h,w", [(1, 1), (1, 17), (17, 1), (2, 3), (15, 16),
                                 (16, 17), (33, 31)])
def test_lossy_edge_sizes(lib, h, w):
    _check(lib.encode(_photo(h, w, h * w, 30)), lib)


# --- lossless ---

@pytest.mark.parametrize("colors,w", [(2, 29), (3, 30), (4, 33), (11, 37),
                                      (16, 35), (200, 35)])
def test_lossless_palette_bundling_matches_pil(lib, colors, w):
    """Color indexing with 8, 4, 2 or 1 pixels a byte, at widths that are
    not a multiple of the bundle."""
    rng = np.random.default_rng(colors)
    idx = rng.integers(0, colors, (23, w))
    pal = rng.integers(0, 256, (colors, 3), np.uint8)
    img = pal[idx]
    for cfg in ({"lossless": 1}, {"lossless": 1, "method": 6, "quality": 100},
                {"lossless": 1, "method": 0, "quality": 0}):
        _check(lib.encode(img, **cfg))


@pytest.mark.parametrize("cfg", [
    {"lossless": 1, "method": 6, "quality": 100},
    {"lossless": 1, "near_lossless": 40}, {"lossless": 1, "method": 3,
                                           "quality": 30},
    {"lossless": 1, "exact": 1, "use_delta_palette": 1}])
def test_lossless_transforms_and_cache_match_pil(lib, cfg):
    """Photo-like content takes the predictor (every mode), cross-color
    and subtract-green transforms, the color cache and meta codes."""
    _check(lib.encode(_photo(61, 47, 3, 25), **cfg))
    rgba = np.concatenate([_photo(30, 41, 4), np.random.default_rng(4)
                           .integers(0, 256, (30, 41, 1), np.uint8)], 2)
    _check(lib.encode(rgba, **cfg))


# --- alpha: ALPH raw or VP8L-coded, each filter ---

@pytest.mark.parametrize("coding", ["raw", "vp8l"])
@pytest.mark.parametrize("filt", range(4), ids=["none", "horizontal",
                                                "vertical", "gradient"])
def test_alpha_codings_and_filters_match_pil(lib, coding, filt):
    """Alpha never reaches RGB, but libwebp fails the whole decode on a
    broken plane: a cut or flipped ALPH is refused where PIL refuses it."""
    rng = np.random.default_rng(filt)
    alpha = np.clip(np.add.outer(np.arange(40) * 5, np.arange(36) * 3)
                    + rng.integers(0, 30, (40, 36)), 0, 255).astype(np.uint8)
    base = webp_chunks(lib.encode(np.concatenate(
        [_photo(40, 36, 5), alpha[..., None]], 2), alpha_compression=0))
    payload = (webp_raw_alpha(alpha, filt) if coding == "raw"
               else webp_lossless_alpha(alpha, filt, lib.encode))
    data = webp_file([(t, payload if t == b"ALPH" else p) for t, p in base])
    _check(data, lib)
    for cut in (2, len(payload) // 2, len(payload) - 1):
        _check(webp_file([(t, payload[:cut] if t == b"ALPH" else p)
                          for t, p in base]))
    for i in range(1, len(payload), max(1, len(payload) // 12)):
        bad = payload[:i] + bytes([payload[i] ^ 0x5A]) + payload[i + 1:]
        _check(webp_file([(t, bad if t == b"ALPH" else p) for t, p in base]))
    for head in (payload[0] | 0x40, payload[0] | 0x20, payload[0] | 2):
        _check(webp_file([(t, bytes([head]) + payload[1:] if t == b"ALPH"
                           else p) for t, p in base]))


# --- the container ---

def test_container_layouts_as_libwebp_demuxes_them(lib):
    """Layouts held against PIL, not reasoned out: bytes after the RIFF
    size, an odd chunk with and without its padding byte, chunks before
    and after the image, a VP8X whose canvas disagrees, ALPH after VP8,
    flags ALPH is ignored without, an animation with its first frame on
    an offset (the rest of the canvas black), frames past the canvas, no
    frames, a first chunk that is not VP8, VP8L or VP8X."""
    img = _photo(24, 30, 6)
    alpha = np.random.default_rng(6).integers(0, 256, (24, 30), np.uint8)
    lossy = dict(webp_chunks(lib.encode(img)))[b"VP8 "]
    ll = dict(webp_chunks(lib.encode(img, lossless=1)))[b"VP8L"]
    alph = webp_raw_alpha(alpha, 2)
    odd = ll if len(ll) & 1 else ll + b"\0"
    vp8x = webp_vp8x(30, 24, 0x10)
    cases = {
        "trailing bytes": webp_file([(b"VP8 ", lossy)]) + b"\1\2\3",
        "odd chunk padded": webp_file([(b"VP8L", odd)]),
        "odd chunk unpadded": (lambda f: f[:4] + struct.pack(
            "<I", len(f) - 9) + f[8:-1])(webp_file([(b"VP8L", odd)])),
        "riff size short": (lambda f: f[:4] + struct.pack(
            "<I", len(f) - 12) + f[8:])(webp_file([(b"VP8 ", lossy)])),
        "riff size long": (lambda f: f[:4] + struct.pack(
            "<I", len(f)) + f[8:])(webp_file([(b"VP8 ", lossy)])),
        "chunk after simple": webp_file([(b"VP8 ", lossy), (b"ZZZZ", b"ab")]),
        "vp8x still": webp_file([vp8x, (b"ALPH", alph), (b"VP8 ", lossy)]),
        "vp8x xmp after": webp_file([webp_vp8x(30, 24, 0x14),
                                     (b"VP8 ", lossy), (b"XMP ", b"<x/>")]),
        "vp8x no alpha flag": webp_file([webp_vp8x(30, 24, 0),
                                         (b"ALPH", b"\x09junk"),
                                         (b"VP8 ", lossy)]),
        "vp8x canvas differs": webp_file([webp_vp8x(31, 24, 0),
                                          (b"VP8 ", lossy)]),
        "vp8x bad flag": webp_file([webp_vp8x(30, 24, 0x01),
                                    (b"VP8 ", lossy)]),
        "alph after vp8": webp_file([vp8x, (b"VP8 ", lossy),
                                     (b"ALPH", alph)]),
        "alph before vp8l": webp_file([vp8x, (b"ALPH", alph),
                                       (b"VP8L", ll)]),
        "two images": webp_file([vp8x, (b"VP8 ", lossy), (b"VP8 ", lossy)]),
        "vp8x alone": webp_file([vp8x]),
        "not vp8 first": webp_file([(b"ICCP", bytes(8)), (b"VP8 ", lossy)]),
    }
    small = lib.encode(_photo(10, 12, 7))
    anim = [webp_vp8x(40, 30, 0x12), (b"ANIM", bytes(6))]
    cases["animation offset"] = webp_file(anim + [
        webp_anmf(6, 8, small), webp_anmf(0, 0, lib.encode(
            _photo(30, 40, 8), lossless=1))])
    cases["animation past canvas"] = webp_file(anim + [
        webp_anmf(34, 8, small)])
    cases["animation no frames"] = webp_file(anim)
    cases["animation no anim chunk"] = webp_file(
        [webp_vp8x(40, 30, 0x12), webp_anmf(0, 0, small)])
    cases["animation flag off"] = webp_file(
        [webp_vp8x(40, 30, 0x10), (b"ANIM", bytes(6)),
         webp_anmf(0, 0, small)])
    outcomes = {}
    for name, data in cases.items():
        assert _same_as_pil(data), name
        outcomes[name] = isinstance(_pil(data), str)
    assert not outcomes["animation offset"] and outcomes["not vp8 first"]
    px = native.decode_image(cases["animation offset"])
    assert px.shape == (30, 40, 3) and not px[:8].any() and px[8:18, 6:18].any()


@pytest.mark.parametrize("kind", ["lossy", "lossless", "rgba", "animation"])
def test_truncations_and_bit_flips_refused_where_pil_refuses(lib, kind):
    """Seeded cuts and bit flips (headers, the bitstream, several at once):
    the port decodes what PIL decodes, to PIL's pixels, and refuses the
    rest with ValueError (400), never UnsupportedImage."""
    img = _photo(28, 36, 9, 20)
    alpha = np.random.default_rng(9).integers(0, 256, (28, 36, 1), np.uint8)
    data = {"lossy": lambda: lib.encode(img, partitions=2, segments=4),
            "lossless": lambda: lib.encode(img, lossless=1),
            "rgba": lambda: lib.encode(np.concatenate([img, alpha], 2)),
            "animation": lambda: webp_file(
                [webp_vp8x(36, 28, 0x12), (b"ANIM", bytes(6)),
                 webp_anmf(4, 2, lib.encode(img[:20, :24])),
                 webp_anmf(0, 0, lib.encode(img, lossless=1))])}[kind]()
    rng = np.random.default_rng(len(kind))
    refused = 0
    for k in range(120):
        b = bytearray(data)
        if k % 4 == 0:
            b = b[:int(rng.integers(1, len(b)))]
        elif k % 4 == 1:
            b[int(rng.integers(0, 48))] ^= 1 << int(rng.integers(0, 8))
        else:
            for _ in range(1 + k % 3):
                b[int(rng.integers(12, len(b)))] ^= 1 << int(rng.integers(0, 8))
        assert _same_as_pil(bytes(b)), k
        refused += isinstance(_outcome(native.decode_image, bytes(b)), str)
    assert 0 < refused < 120


def test_the_first_chunk_decides_as_pil_identifies():
    """PIL opens RIFF/WEBP only with VP8, VP8L or VP8X first; anything
    else, and a WebP too short for its headers, is a 400."""
    for data in (b"RIFF\x00\x00\x00\x00WEBPVP8 ", b"RIFF\x04\x00\x00\x00WEBP",
                 b"RIFF\x10\x00\x00\x00WEBPALPH" + bytes(8),
                 b"RIFF\x10\x00\x00\x00WEBPVP8Z" + bytes(8)):
        assert _pil(data) == "raises"
        assert _outcome(native.decode_image, data) == "raises"


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


@pytest.mark.parametrize("name", ["webp_q50", "webp_rgba_lossless",
                                  "webp_animation"])
def test_webp_upload_answered_as_the_jax_server(srcnn_servers, name):
    """Lossy, lossless RGBA and an animation: both servers answer 200; the
    port's body is the PNG of its engine's upscale of PIL's pixels, byte
    for byte, and the two bodies decode within 1 level of each other (the
    float32 SRCNN forward rounds a few values differently in XLA and
    PyTorch) and are byte-equal where no value does; a WebP PIL refuses is
    a 400 on both."""
    jport, pport, psrv = srcnn_servers
    data = (JPEG_ASSETS / GOLDENS[name]["file"]).read_bytes()
    (jcode, jbody), (pcode, pbody) = _post(jport, data), _post(pport, data)
    assert jcode == pcode == 200
    assert pbody == native.encode_png_rgb8(psrv.upscale(_pil(data)),
                                           psrv.png_level)
    jpx = native.decode_image(jbody).astype(np.int16)
    ppx = native.decode_image(pbody).astype(np.int16)
    assert jpx.shape == ppx.shape and np.abs(jpx - ppx).max() <= 1
    if np.array_equal(jpx, ppx):
        assert pbody == jbody
    cut = data[:len(data) // 2]
    assert _post(jport, cut)[0] == _post(pport, cut)[0] == 400


def test_a_webp_unit_that_does_not_build_is_415_naming_it(srcnn_servers,
                                                         monkeypatch):
    """No fallback: on a host where g++ cannot build fast_webp.cpp, a
    WebP upload is a 415 naming the build failure, and PNG still serves."""
    monkeypatch.setitem(native._libs, "fast_webp", None)
    monkeypatch.setitem(native._errors, "fast_webp", "g++: not found")
    data = (JPEG_ASSETS / GOLDENS["webp_q50"]["file"]).read_bytes()
    with pytest.raises(native.UnsupportedImage, match="did not build"):
        native.decode_image(data)
    code, body = _post(srcnn_servers[1], data)
    assert code == 415 and b"did not build" in body and b"g++" in body
    png = native.encode_png_rgb8(_photo(8, 8, 1))
    assert _post(srcnn_servers[1], png)[0] == 200


def test_predict_upscales_a_webp(tmp_path, capsys):
    src, out = tmp_path / "in", tmp_path / "out"
    src.mkdir()
    data = (JPEG_ASSETS / GOLDENS["webp_icc_exif"]["file"]).read_bytes()
    (src / "plate.webp").write_bytes(data)
    predict.main([str(src), "--out_dir", str(out), "--architecture",
                  "SRCNN", "--tile", "16", "--max_batch", "4", "--dtype",
                  "float32", "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["n_images"] == 1 and summary["failed"] == 0
    ref = SRServer("SRCNN", dtype=torch.float32, device="cpu", tile=16,
                   max_batch=4)
    try:
        got = native.decode_image((out / "plate_x4.png").read_bytes())
        assert np.array_equal(got, ref.upscale(_pil(data)))
    finally:
        ref.close()
