"""PSD uploads and LAB images in the port's request decoder
(food101_sr_tpu_torch/native/legacy.py ``open_psd``, PackBits in
native/fast_legacy.cpp, native/cielab.py), against PIL, which the JAX
package's server decodes uploads with: every committed PSD pixel-equal to
PIL live and to its golden; each colour mode raw and PackBits; PackBits
runs across rows and channels as PackDecode.c cuts them; the header walk
PIL's ``_open`` makes (resources, the layer section, the fall-through
where a header is not a PSD PIL reads); seeded cuts and flips; LittleCMS's
Lab -> sRGB on seeded pixels and the CIELab TIFF; and PSD uploads and
probes answered alike by both servers."""
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
from food101_sr_tpu_torch.native import cielab, openers
from food101_sr_tpu_torch.serving import SRServer

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import serve as jax_serve  # noqa: E402
from chip_smoke import psd_photo, sha256  # noqa: E402
from tools import format_differential  # noqa: E402
from tools.raster_writers import packbits, psd, psd_streams, tiff_image  # noqa: E402

JPEG_ASSETS = ROOT / "food101_sr_tpu_torch" / "assets" / "jpeg"
GOLDENS = json.loads((JPEG_ASSETS / "goldens.json").read_text())["streams"]
STREAMS = sorted(n for n, g in GOLDENS.items() if g["file"].endswith(".psd"))
ASSET = ROOT / "food101_sr_tpu_torch" / "assets" / "winner_srcnn.pth"
CHECKPOINT = ROOT / "weights" / "winner_srcnn_best"
# the headers of the 400 probes: PIL's PSD ``_open`` falls through on each
PROBES = {"zeros 64": b"8BPS" + bytes(64), "zeros 30": b"8BPS" + bytes(30),
          "version 1, no mode": b"8BPS\x00\x01" + bytes(6) + b"\x00\x03"
                                + bytes(64)}


def _same_as_pil(data) -> bool:
    return format_differential.difference(data) is None


def _img(h, w, c, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c)).astype(
        np.uint8)


def test_committed_streams_are_the_writers_bytes():
    made = psd_streams()
    assert {GOLDENS[n]["file"].split("/")[1] for n in STREAMS} == set(made)
    for name in STREAMS:
        f = GOLDENS[name]["file"]
        assert (JPEG_ASSETS / f).read_bytes() == made[f.split("/")[1]], f


@pytest.mark.parametrize("name", STREAMS)
def test_committed_stream_matches_pil_and_its_golden(name):
    g = GOLDENS[name]
    data = (JPEG_ASSETS / g["file"]).read_bytes()
    if g.get("served_refused"):  # 16-bit and PSB: PIL's _open falls through
        with pytest.raises(ValueError) as e:
            native.decode_image(data)
        assert not isinstance(e.value, native.UnsupportedImage)
        assert format_differential.pil_outcome(data) == "raises"
        return
    px = native.decode_image(data)
    assert list(px.shape) == g["shape"] and sha256(px) == g["served_sha256"]
    assert np.array_equal(px, format_differential.pil_outcome(data))


@pytest.mark.parametrize("mode,channels", [
    (0, 1), (1, 1), (2, 1), (3, 3), (3, 4), (3, 5), (4, 4), (4, 5), (7, 2),
    (8, 1), (9, 3), (9, 4)])
@pytest.mark.parametrize("compression", [0, 1])
def test_modes_and_compressions(mode, channels, compression):
    """Every (mode, depth) pair of PIL's table, extra channels read or not
    (RGB with 4 channels is RGBA), raw and PackBits, an odd width."""
    h, w = 9, 13
    img = _img(h, w, channels, mode * 10 + channels)
    if mode == 0:
        planes = [np.packbits(img[..., 0] > 127, axis=1)]
        data = psd(planes, 0, bits=1, size=(w, h), compression=compression)
    else:
        planes = [img[..., i] for i in range(channels)]
        color = _img(1, 768, 1, 1).tobytes() if mode == 2 else b""
        data = psd(planes, mode, compression=compression, color_data=color)
    # PIL reads the row-count table of the channels its mode uses: with
    # more channels the PackBits tiles start inside the table (PIL fails)
    extra = channels > {0: 1, 1: 1, 2: 1, 3: 4, 4: 4, 7: 1, 8: 1, 9: 3}[mode]
    assert isinstance(format_differential.pil_outcome(data), np.ndarray) \
        or (extra and compression == 1)
    assert _same_as_pil(data)


@pytest.mark.parametrize("case", ["run past the row", "literal past the row",
                                  "no-op packets", "rows short",
                                  "table sums short"])
def test_packbits_as_packdecode_reads_it(case):
    """One stream a tile from its offset to the end of the file: a packet
    running past its row is cut there (the rest is dropped, not carried),
    0x80 is skipped, data that ends before the last row fails (400), and
    the row-count table only places the next channel's tile."""
    h, w = 6, 10
    img = _img(h, w, 3, 7)
    rows = [[packbits(bytes(r)) for r in img[..., c]] for c in range(3)]
    if case == "run past the row":
        rows[0][2] = bytes([256 - 20, 9])  # a run of 21 in a row of 10
    elif case == "literal past the row":
        rows[1][0] = bytes([15]) + bytes(range(16))
    elif case == "no-op packets":
        rows[2] = [b"\x80" + r + b"\x80" for r in rows[2]]
    elif case == "rows short":
        rows[2][-1] = rows[2][-1][:1]
    else:
        rows[0] = [r[:len(r) - 1] for r in rows[0]]
    data = psd([img[..., c] for c in range(3)], 3, rows=rows)
    assert _same_as_pil(data)


@pytest.mark.parametrize("name", sorted(PROBES))
def test_headers_pil_does_not_open_fall_through(name):
    """PIL's ``_open`` raises SyntaxError, KeyError or struct.error on
    these (version 0, a (mode, depth) pair outside its table, short
    reads): the walk goes on and no opener takes them, 400 as on the JAX
    server, never the 415 the port once answered."""
    data = PROBES[name]
    with pytest.raises(ValueError) as e:
        native.decode_image(data)
    assert not isinstance(e.value, native.UnsupportedImage)
    with pytest.raises(Exception):
        Image.open(io.BytesIO(data)).load()


def test_header_walk_edges():
    """Too few channels ends the walk (PIL's OSError); resources read past
    the end fall through; a compression PIL has no tile for fails its
    load; a layer section past the end leaves the image data short."""
    img = _img(5, 6, 3, 2)
    planes = [img[..., i] for i in range(3)]
    cases = [psd(planes[:1], 3, channels=1),
             psd(planes, 3)[:26] + struct.pack(">II", 0, 50) + b"8BIM",
             psd(planes, 3, compression=2),
             psd(planes, 3)[:30] + struct.pack(">I", 400) + bytes(8),
             psd(planes, 3, version=2), psd(planes, 3, bits=16)]
    for data in cases:
        assert _same_as_pil(data)


def test_seeded_cuts_and_flips_match_pil():
    for name in STREAMS:
        data = (JPEG_ASSETS / GOLDENS[name]["file"]).read_bytes()
        rng = np.random.default_rng(sum(map(ord, name)))
        for k in sorted(set(rng.integers(0, len(data), 8).tolist())
                        | {0, 5, 25, 26, 30, 34}):
            assert _same_as_pil(data[:k]), (name, k)
        for i in range(8):
            b = bytearray(data)
            pos = int(rng.integers(0, 48 if i % 2 == 0 else len(b)))
            b[pos] ^= 1 << int(rng.integers(0, 8))
            assert _same_as_pil(bytes(b)), (name, i)


def test_lab_to_rgb_is_littlecms():
    """Seeded LAB pixels and the grid's corners through PIL's transform
    (frombytes with raw mode LAB flips a and b's sign bit)."""
    rng = np.random.default_rng(0)
    px = rng.integers(0, 256, (256, 512, 3)).astype(np.uint8)
    px[0, :8] = [[a, b, c] for a in (0, 255) for b in (0, 255)
                 for c in (0, 255)]
    raw = px.copy()
    raw[..., 1:] ^= 128
    want = np.asarray(Image.frombytes("LAB", (512, 256), raw.tobytes())
                      .convert("RGB"))
    assert np.array_equal(cielab.lab_to_rgb(px), want)


def test_cielab_tiff_pixel():
    """The TIFF's signed a and b: (148, 185, 74) is RGB (0, 166, 0)."""
    lab = np.array([[[148, 185, 74]]], np.uint8)
    data = tiff_image(lab, 8, 8)
    assert native.decode_image(data).tolist() == [[[0, 166, 0]]]
    assert _same_as_pil(data)


def test_psd_photo_is_its_image():
    """chip_smoke's 800 x 608 PackBits upload decodes to the image it was
    made from (PIL's decode too)."""
    data, img = psd_photo(120, 160, 3)
    assert np.array_equal(native.decode_image(data), img)
    assert np.array_equal(format_differential.pil_outcome(data), img)


def test_opener_table():
    """PSD is decoded, not refused: it is no longer in REFUSED."""
    assert "PSD" not in openers.REFUSED and "PSD" in openers.DECODED
    assert dict((n, o) for n, _, o in openers.OPENERS)["PSD"] is \
        native.legacy.open_psd


@pytest.fixture(scope="module")
def srcnn_servers():
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


@pytest.mark.parametrize("name", ["psd_rgb", "psd_lab"])
def test_upload_answered_as_the_jax_server(srcnn_servers, name):
    """200 from both; the port's body is the PNG of its engine's upscale
    of PIL's pixels, and the bodies decode within 1 level of each other."""
    jport, pport, psrv = srcnn_servers
    data = (JPEG_ASSETS / GOLDENS[name]["file"]).read_bytes()
    (jcode, jbody), (pcode, pbody) = _post(jport, data), _post(pport, data)
    assert jcode == pcode == 200
    assert pbody == native.encode_png_rgb8(
        psrv.upscale(format_differential.pil_outcome(data)), psrv.png_level)
    jpx = native.decode_image(jbody).astype(np.int16)
    assert np.abs(jpx - native.decode_image(pbody)).max() <= 1


@pytest.mark.parametrize("name", sorted(PROBES))
def test_probe_answered_400_by_both_servers(srcnn_servers, name):
    jport, pport, _ = srcnn_servers
    assert _post(jport, PROBES[name])[0] == _post(pport, PROBES[name])[0] \
        == 400
