"""The port's HTTP front end (food101_sr_tpu_torch.serve) on the CPU,
against the JAX package's ``serve.py`` on shared weights: an AttentionSR
2 x 16 (JAX random init, carried over by ``convert.params_from_jax``)
served by both in float32 answers the same PNG, small and tiled, within
1 uint8 level; ``/healthz`` and ``/statz`` carry JAX's keys; zoo
routing, the JPEG response format, every error status of JAX's server
(and 415 for images the port does not read, such as PSD), the shutdown
drain, warmup, the CLI end to end with SIGTERM, and the unported flags
naming their ROADMAP items."""
import io
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401
from PIL import Image

from food101_sr_tpu.models.attention_sr import AttentionSR as JaxAttentionSR
from food101_sr_tpu.training import save_checkpoint as jax_save_checkpoint
from food101_sr_tpu_torch import native, serve
from food101_sr_tpu_torch.convert import params_from_jax
from food101_sr_tpu_torch.serving import SRServer

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import serve as jax_serve  # noqa: E402

TILE = 16  # the 2-block net's halo is 20: windows of 56 px
ASSET = ROOT / "food101_sr_tpu_torch" / "assets" / "winner_srcnn.pth"


def _img(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


def _start(handler):
    httpd = serve.SRHTTPServer(("127.0.0.1", 0), handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, httpd.server_address[1]


def _stop(httpd):
    httpd.shutdown()
    httpd.server_close()


def _request(port, path, body=None, headers=None, timeout=120):
    """(status, headers, body) of one request; HTTP errors are returned."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method="POST" if body is not None else "GET",
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX server, port server, JAX port, port port): the same AttentionSR
    2 x 16 weights behind both HTTP front ends, float32."""
    jnet = JaxAttentionSR(scale_factor=4, num_channels=16, num_residuals=2)
    variables = jnet.init(jax.random.PRNGKey(7), jnp.zeros((1, 8, 8, 3)))
    ckpt = jax_save_checkpoint({"params": variables["params"], "extra": {}},
                               str(tmp_path_factory.mktemp("ckpt") / "c"))
    jsrv = jax_serve.SRServer("auto", ckpt, scale=4, tile=TILE,
                              dtype=jnp.float32)
    psrv = SRServer("auto", params_from_jax(variables["params"]),
                    dtype=torch.float32, device="cpu", tile=TILE)
    jhttpd = jax_serve.SRHTTPServer(("127.0.0.1", 0),
                                    jax_serve.make_handler(jsrv))
    threading.Thread(target=jhttpd.serve_forever, daemon=True).start()
    phttpd, pport = _start(serve.make_handler(psrv))
    yield jsrv, psrv, jhttpd.server_address[1], pport
    _stop(phttpd)
    _stop(jhttpd)
    psrv.close()


@pytest.mark.parametrize("h,w", [(16, 12), (60, 40)], ids=["small", "tiled"])
def test_png_matches_jax_server(pair, h, w):
    jsrv, psrv, jport, pport = pair
    img = _img(h, w, seed=h + w)
    body = native.encode_png_rgb8(img)
    i0 = psrv.batcher.n_items
    outs = []
    for port in (jport, pport):
        code, hdrs, data = _request(port, "/sr", body)
        assert code == 200 and hdrs["Content-Type"] == "image/png"
        assert float(hdrs["X-Inference-Ms"]) >= 0
        outs.append(np.asarray(Image.open(io.BytesIO(data)).convert("RGB"),
                               np.int16))
    assert (psrv.batcher.n_items - i0 > 1) == (h == 60)  # tiled windows
    assert outs[0].shape == outs[1].shape == (4 * h, 4 * w, 3)
    assert np.abs(outs[0] - outs[1]).max() <= 1
    # PNG is lossless: the response is the engine's result exactly
    assert np.array_equal(outs[1], psrv.upscale(img))


def test_healthz_and_statz_have_jax_keys(pair):
    jsrv, psrv, jport, pport = pair
    _request(jport, "/sr", native.encode_png_rgb8(_img(8, 8, 1)))
    _request(pport, "/sr", native.encode_png_rgb8(_img(8, 8, 1)))
    jh, ph = (json.loads(_request(p, "/healthz")[2]) for p in (jport, pport))
    assert set(jh) <= set(ph)
    assert set(ph) - set(jh) == {"device_name", "jpeg"}
    assert ph["device"] == "cpu" and ph["jpeg"] == native.jpeg_available()
    assert ph["architecture"] == jh["architecture"] == "AttentionSR"
    assert set(ph["models"]["default"]) == set(jh["models"]["default"])
    js, ps = (json.loads(_request(p, "/statz")[2]) for p in (jport, pport))
    assert set(ps) == set(js)
    assert ps["t_exec_fetch_s"] > 0 and ps["rows_fetched"] >= 1
    assert ps["max_batch"] == psrv.batcher.max_batch
    assert ps["batched_items"] >= ps["device_batches"] >= 1
    assert "t_exec_s" not in ps  # not an instrumented server


def test_statz_instrumented_split_and_window():
    srv = SRServer("SRCNN", dtype=torch.float32, device="cpu", tile=TILE,
                   window_ms=7.5, instrument=True)
    httpd, port = _start(serve.make_handler(srv))
    try:
        _request(port, "/sr", native.encode_png_rgb8(_img(20, 12, 71)))
        stats = json.loads(_request(port, "/statz")[2])
    finally:
        _stop(httpd)
        srv.close()
    assert stats["window_ms"] == pytest.approx(7.5)
    assert stats["t_exec_s"] >= 0 and stats["t_d2h_s"] >= 0
    assert stats["t_exec_s"] + stats["t_d2h_s"] <= stats["t_exec_fetch_s"] \
        + 1e-3  # each rounded to the millisecond
    # /statz rounds to the millisecond; the server keeps the seconds
    assert srv.t_decode_s > 0 and srv.t_encode_s > 0
    assert stats["t_encode_s"] == round(srv.t_encode_s, 3)


def test_host_time_adds_up_under_contention(pair):
    """Handler threads add their decode and encode seconds at once; a lost
    update would leave the totals short."""
    psrv = pair[1]
    d0, e0 = psrv.t_decode_s, psrv.t_encode_s
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [
            psrv.add_host_time(w, 0.5) for _ in range(500)
            for w in ("decode", "encode")]) for _ in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
            assert not w.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert psrv.t_decode_s - d0 == psrv.t_encode_s - e0 == 16 * 500 * 0.5


def test_zoo_routes_by_model(pair):
    _, attn, _, _ = pair
    fast = SRServer("SRCNN", dtype=torch.float32, device="cpu", tile=TILE)
    httpd, port = _start(serve.make_handler({"fast": fast, "attn": attn}))
    try:
        h = json.loads(_request(port, "/healthz")[2])
        assert h["default"] == "fast" and set(h["models"]) == {"fast", "attn"}
        assert h["models"]["attn"]["architecture"] == "AttentionSR"
        assert "architecture" not in h  # the zoo shape
        body = native.encode_png_rgb8(_img(16, 16, 90))
        outs = {}
        for name in ("fast", "attn"):
            code, _, data = _request(port, f"/sr?model={name}", body)
            assert code == 200
            outs[name] = native.decode_image(data).astype(np.int16)
        assert np.abs(outs["fast"] - outs["attn"]).max() > 1
        code, _, data = _request(port, "/sr", body)
        assert np.array_equal(native.decode_image(data), outs["fast"])
        code, _, data = _request(port, "/sr?model=nope", body)
        assert code == 404 and b"fast, attn" in data
        assert set(json.loads(_request(port, "/statz")[2])) == {"fast", "attn"}
    finally:
        _stop(httpd)
        fast.close()


def test_jpeg_response_format(pair):
    if not native.jpeg_available():
        pytest.skip("libjpeg is not present on this host")
    port = pair[3]
    body = native.encode_png_rgb8(_img(24, 16, 60))
    for path, hdrs in (("/sr?format=jpeg&quality=85", {}),
                       ("/sr", {"Accept": "image/jpeg"})):
        code, h, data = _request(port, path, body, hdrs)
        assert code == 200 and h["Content-Type"] == "image/jpeg"
        out = Image.open(io.BytesIO(data))
        assert out.format == "JPEG" and out.size == (64, 96)
    assert _request(port, "/sr", body)[1]["Content-Type"] == "image/png"
    assert _request(port, "/sr?format=webp", body)[0] == 400
    assert _request(port, "/sr?quality=high", body)[0] == 400


def test_jpeg_refused_by_name_without_libjpeg(pair, monkeypatch):
    """The codec needs no libjpeg; JPEG is refused only on a host where
    its C++ unit does not build, with 415 naming that, and PNG still
    serves."""
    monkeypatch.setitem(native._libs, "fast_jpeg", None)
    monkeypatch.setitem(native._errors, "fast_jpeg", "g++: not found")
    port = pair[3]
    assert json.loads(_request(port, "/healthz")[2])["jpeg"] is False
    jpeg = b"\xff\xd8\xff\xe0" + bytes(64)
    code, _, data = _request(port, "/sr", jpeg)
    assert code == 415 and b"did not build" in data and b"g++" in data
    png = native.encode_png_rgb8(_img(8, 8, 2))
    code, _, data = _request(port, "/sr?format=jpeg", png)
    assert code == 415 and b"did not build" in data
    assert _request(port, "/sr", png)[0] == 200


def test_jpeg_upload_and_response_match_jax_server(pair):
    """A JPEG upload decodes as the JAX server decodes it (PIL): the PNG
    responses agree within 1 level; a ?format=jpeg response is the port's
    encode of SRServer.upscale at quality 90, and equals the JAX server's
    bytes wherever their pixels agree; a CMYK upload, which the JAX server
    decodes with PIL, is answered 200 with the port's upscale of PIL's
    pixels, and a truncated JPEG 400, as PIL refuses it."""
    jsrv, psrv, jport, pport = pair
    img = _img(16, 12, seed=70)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=90)
    body = buf.getvalue()
    outs = []
    for port in (jport, pport):
        code, hdrs, data = _request(port, "/sr", body)
        assert code == 200 and hdrs["Content-Type"] == "image/png"
        outs.append(native.decode_image(data).astype(np.int16))
    assert np.abs(outs[0] - outs[1]).max() <= 1
    sr = psrv.upscale(native.decode_image(body))
    code, hdrs, data = _request(pport, "/sr?format=jpeg", body)
    assert code == 200 and hdrs["Content-Type"] == "image/jpeg"
    assert data == native.encode_jpeg_rgb8(sr, 90)
    jcode, _, jdata = _request(jport, "/sr?format=jpeg", body)
    assert jcode == 200
    if np.array_equal(outs[0], outs[1]):
        assert jdata == data
    cmyk = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(cmyk, format="JPEG")
    code, _, data = _request(pport, "/sr", cmyk.getvalue())
    px = np.asarray(Image.open(io.BytesIO(cmyk.getvalue())).convert("RGB"))
    assert code == 200 and np.array_equal(native.decode_image(data),
                                          psrv.upscale(px))
    for port in (jport, pport):
        code, _, data = _request(port, "/sr", body[:len(body) * 2 // 3])
        assert code == 400 and b"could not decode" in data


def _raw_request(port, payload: bytes, recv_timeout=10.0) -> bytes:
    """Send raw bytes, half-close, read the whole response."""
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(payload)
        s.shutdown(socket.SHUT_WR)
        s.settimeout(recv_timeout)
        chunks = []
        try:
            while True:
                b = s.recv(65536)
                if not b:
                    break
                chunks.append(b)
        except OSError:
            pass
        return b"".join(chunks)


# a JBIG2 file header and an ISO-BMFF HEIC one: no PIL plugin takes them
JBIG2 = b"\x97JB2\r\n\x1a\n\x01\x00\x00\x00\x01"
HEIC = b"\x00\x00\x00\x1cftypheic\x00\x00\x00\x00heicmif1"


def _post(body: bytes, length=None) -> bytes:
    n = str(len(body)).encode() if length is None else length
    return (b"POST /sr HTTP/1.1\r\nHost: x\r\nContent-Length: " + n
            + b"\r\n\r\n" + body)


@pytest.mark.parametrize("payload,status,text", [
    (_post(b"", b"104857600"), b"413", b""),
    (_post(b"", b"-5"), b"400", b""),
    (_post(b"", b"banana"), b"400", b"integer"),
    (_post(b"0123456789", b"5000"), b"400", b"truncated"),
    (b"\x00\xff GARBAGE\r\n\r\n", None, b""),
    (_post(b"this is not an image at all, not even close"), b"400",
     b"could not decode"),
    (_post(b"8BPS" + bytes(64)), b"415", b"PSD"),
    (_post(b"RIFF\x00\x00\x00\x00WEBPVP8 " + bytes(64)), b"400",
     b"could not decode"),
    (_post(JBIG2 + bytes(64)), b"400", b"could not decode"),
    (_post(HEIC + bytes(64)), b"400", b"could not decode"),
    (b"GET /nowhere HTTP/1.1\r\nHost: x\r\n\r\n", b"404", b""),
    (_post(b"x", b"1").replace(b"/sr", b"/upscale"), b"404", b"/sr"),
], ids=["413", "negative-length", "non-numeric-length", "truncated-body",
        "garbage-request-line", "non-image", "bmp-415", "webp-400",
        "jbig2-400", "heic-400", "get-404", "post-404"])
def test_error_statuses_and_the_server_survives(pair, payload, status, text):
    port = pair[3]
    resp = _raw_request(port, payload)
    if status is None:  # http.server answers 400 or just closes
        assert resp == b"" or b"400" in resp.split(b"\r\n", 1)[0], resp[:200]
    else:
        assert resp.startswith(b"HTTP/1.1 " + status), resp[:200]
        assert text in resp
    code, _, data = _request(port, "/sr", native.encode_png_rgb8(
        _img(16, 16, 77)))
    assert code == 200 and native.decode_image(data).shape == (64, 64, 3)


@pytest.mark.parametrize("head", [JBIG2, HEIC], ids=["jbig2", "heic"])
def test_jbig2_and_heic_uploads_are_400_on_the_jax_server(pair, head):
    """PIL identifies neither, so the JAX server answers 400 (it cannot
    decode them): the port's 400 for the same uploads is held in
    ``test_error_statuses_and_the_server_survives``."""
    code, _, data = _request(pair[2], "/sr", head + bytes(256))
    assert code == 400 and b"could not decode" in data, data


def test_sixteen_bit_png_is_415_naming_it(pair):
    """Once 415, now decoded as the JAX server decodes it (PIL: a 16-bit
    RGB PNG keeps each sample's high byte) and answered 200 by both
    servers alike; a BMP, once 415 too, is served the same way."""
    jsrv, psrv, jport, pport = pair
    rgb16 = np.random.default_rng(9).integers(0, 65536, (8, 8, 3))
    rows = b"".join(b"\x00" + r.astype(">u2").tobytes() for r in rgb16)
    ihdr = struct.pack(">IIBBBBB", 8, 8, 16, 2, 0, 0, 0)
    png = (native.PNG_SIGNATURE + native._chunk(b"IHDR", ihdr)
           + native._chunk(b"IDAT", zlib.compress(rows))
           + native._chunk(b"IEND", b""))
    bmp = io.BytesIO()
    Image.fromarray(_img(9, 11, 5)).save(bmp, format="BMP")
    for body in (png, bmp.getvalue()):
        px = np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))
        code, _, data = _request(pport, "/sr", body)
        assert code == 200
        assert np.array_equal(native.decode_image(data), psrv.upscale(px))
        assert _request(jport, "/sr", body)[0] == 200


def test_shutdown_drains_in_flight_requests(pair):
    """httpd.shutdown() (what SIGTERM runs) while requests are inside
    their handlers: each is still answered in full."""
    psrv = pair[1]
    entered = threading.Semaphore(0)
    base = serve.make_handler(psrv)

    class Counting(base):
        def do_POST(self):
            entered.release()
            super().do_POST()

    httpd = serve.SRHTTPServer(("127.0.0.1", 0), Counting)
    port = httpd.server_address[1]
    server_thread = threading.Thread(target=httpd.serve_forever)
    server_thread.start()
    imgs = [_img(60, 40, seed=88 + i) for i in range(3)]
    results = [None] * 3

    def client(i):
        results[i] = _request(port, "/sr", native.encode_png_rgb8(imgs[i]))

    clients = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for c in clients:
        c.start()
    for _ in clients:
        assert entered.acquire(timeout=60)
    httpd.shutdown()
    httpd.server_close()  # joins the handler threads
    for c in clients + [server_thread]:
        c.join(timeout=120)
        assert not c.is_alive()
    for img, (code, _, data) in zip(imgs, results):
        assert code == 200
        assert np.array_equal(native.decode_image(data), psrv.upscale(img))


def test_warmup_runs_each_bucket_without_traffic(pair):
    psrv = pair[1]
    img = _img(20, 12, seed=40)
    before = psrv.upscale(img)
    rows, threads = [], set()

    def record(m, args):
        rows.append(tuple(args[0].shape))
        threads.add(threading.current_thread())

    hook = psrv.model.register_forward_pre_hook(record)
    b = psrv.batcher
    counts = (b.n_batches, b.n_items, b.rows_fetched)
    try:
        psrv.warmup()
    finally:
        hook.remove()
    win = TILE + 2 * psrv.halo
    assert rows == [(8, 3, TILE, TILE), (8, 3, win, win)]
    # on the thread that runs every forward (per-thread cuDNN handles)
    assert threads == {psrv.batcher._thread}
    assert (b.n_batches, b.n_items, b.rows_fetched) == counts
    assert np.array_equal(psrv.upscale(img), before)


def test_quantize_flag_quantizes_what_can_be():
    """``--quantize int8`` (ROADMAP item 8) on the CPU: a zoo quantizes
    RESNET and serves SRCNN, by name or as an "auto" checkpoint, in float
    with a note, as the JAX server does; a single SRCNN stays strict;
    ``--no_phase_tail`` reaches the net."""
    a = serve.parse_args(["--quantize", "int8", "--model", "fast=SRCNN",
                          "--model", "q=RESNET", "--model",
                          f"asset=auto@{ASSET}", "--device", "cpu",
                          "--tile", "16", "--max_batch", "2",
                          "--no_phase_tail"])
    zoo, default = serve.build_servers(a)
    try:
        assert default == "fast"
        assert {n: s.quantize for n, s in zoo.items()} == {
            "fast": "", "q": "int8", "asset": ""}
        assert zoo["q"].model.res_blocks[0].conv1.quantize == "int8"
        assert zoo["q"].phase_tail is False
        img = np.random.default_rng(0).integers(0, 256, (16, 16, 3),
                                                np.uint8)
        assert zoo["q"].upscale(img).shape == (64, 64, 3)
    finally:
        for s in zoo.values():
            s.close()
    with pytest.raises(ValueError, match="quantizable"):
        SRServer("SRCNN", device="cpu", quantize="int8")


def test_cli_zoo_serves_and_drains_on_sigterm(tmp_path):
    """``python -m food101_sr_tpu_torch.serve`` with two models (the
    registry SRCNN and the committed SRCNN asset through "auto"), warmed,
    on the CPU: both answer, then SIGTERM drains and exits cleanly."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "food101_sr_tpu_torch.serve", "--device",
         "cpu", "--dtype", "float32", "--model", "fast=SRCNN", "--model",
         f"asset=auto@{ASSET}", "--tile", "16", "--max_batch", "2",
         "--warmup_sizes", "16x16", "--no_phase_tail", "--port", str(port)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        deadline, h = time.time() + 120, None
        while time.time() < deadline and h is None:
            if proc.poll() is not None:
                raise AssertionError(proc.stdout.read()[-4000:])
            try:
                h = json.loads(_request(port, "/healthz", timeout=5)[2])
            except (urllib.error.URLError, OSError):
                time.sleep(0.5)
        assert h is not None, "server never came up"
        assert set(h["models"]) == {"fast", "asset"}
        assert h["models"]["asset"]["architecture"] == "SRCNN"
        body = native.encode_png_rgb8(_img(16, 16, 91))
        for name in ("fast", "asset"):
            code, _, data = _request(port, f"/sr?model={name}", body)
            assert code == 200
            assert native.decode_image(data).shape == (64, 64, 3)
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            out, _ = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
    assert proc.returncode == 0, out[-4000:]
    assert "warmup done" in out and "draining" in out
    assert "shut down cleanly after 2 image(s)" in out
