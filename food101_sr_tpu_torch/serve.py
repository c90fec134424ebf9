"""Inference server: HTTP POST an image, get the x4 super-resolved image
back (counterpart of the JAX package's ``serve.py``: the same routes,
flags, status codes and JSON shapes).

    python -m food101_sr_tpu_torch.serve --architecture AttentionSR \\
        --checkpoint w/attentionsr_best.pth --warmup &
    curl --data-binary @low_res.png http://localhost:8700/sr > out.png
    curl http://localhost:8700/healthz

One process owns the card; each model loads once into an
:class:`~food101_sr_tpu_torch.serving.SRServer`, whose micro-batcher
coalesces concurrent same-bucket requests (and the windows of large,
tiled images) into fixed-shape device batches. Requests are decoded and
responses encoded by the port's own codecs (``native``, needing no
library): PNG, JPEG, GIF, BMP, WebP (lossy, lossless, with alpha, the
first frame of an animation), TIFF (every compression but ZSTD, old-style
JPEG, ThunderScan and raw-16; strips, tiles, separate planes, BigTIFF),
Netpbm, ICO, CUR and QOI uploads decode to the pixels the JAX server's
PIL gives, and a stream PIL refuses (a truncated JPEG, a 12-bit one, a
broken WebP, a WebP-compressed TIFF) is answered 400 as there; so are
the formats PIL's opener walk reaches (PSD and JPEG 2000 among them).
A format or variant the codecs do not read (XBM, AVIF, HTJ2K and the
others ``native.decode_image`` names) is answered 415 with the reason,
never decoded another way.

Routes: ``GET /healthz``, ``GET /statz``, ``POST /sr[?model=NAME]
[&format=png|jpeg][&quality=Q]`` (or ``Accept: image/jpeg``).
Stdlib only besides torch and numpy: ``http.server``, no framework.
"""
from __future__ import annotations

import argparse
import json
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import torch

from . import native
from .serving import SRServer

MAX_BODY = 64 << 20  # bytes


class SRHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a listen backlog sized for bursty serving.

    socketserver's default request_queue_size of 5 drops (RST) connections
    whenever more than a handful arrive while handlers are busy, e.g. the
    first seconds of traffic on a cold bucket, where one request holds the
    batcher while cuDNN picks its algorithms and the rest pile up.

    Handler threads are non-daemon and block_on_close, so a graceful
    shutdown (SIGTERM/SIGINT, see main) finishes in-flight requests
    instead of killing them mid-response.
    """

    request_queue_size = 128
    daemon_threads = False
    block_on_close = True


def device_name(device: torch.device) -> str:
    """The card's name for a CUDA device, the device type otherwise."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def make_handler(server, default: str | None = None):
    """HTTP handler class for one SRServer or a {name: SRServer} zoo.

    With a dict, ``POST /sr?model=NAME`` routes per request (e.g. a fast
    SRCNN next to a quality AttentionSR on the same card; each model has
    its own micro-batcher); ``default`` names the unqualified route
    (first entry if omitted)."""
    servers = server if isinstance(server, dict) else {"default": server}
    default = default or next(iter(servers))

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 keep-alive: every response carries Content-Length, so
        # clients can reuse connections
        protocol_version = "HTTP/1.1"
        # Idle keep-alive timeout: without it a handler thread blocks in
        # readline() on an idle pooled connection forever, and graceful
        # shutdown, which joins handler threads, would hang on it.
        timeout = 30

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            if code >= 400:
                # error paths may bail before reading the request body;
                # under keep-alive the unread bytes would desync the next
                # request on this connection: close it instead
                self.close_connection = True
            try:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                if self.close_connection:
                    self.send_header("Connection", "close")
                self.end_headers()
                self.wfile.write(body)
            except OSError:
                # peer closed mid-response: nothing to tell it
                self.close_connection = True

        def _json(self, info: dict):
            self._send(200, json.dumps(info).encode(), "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                dev = servers[default].device
                info = {"status": "ok", "default": default,
                        "device": dev.type,
                        "device_name": device_name(dev),
                        "jpeg": native.jpeg_available(),
                        "models": {n: {"architecture": s.architecture,
                                       "scale": s.scale,
                                       "quantize": s.quantize,
                                       "served": s.n_served}
                                   for n, s in servers.items()}}
                if len(servers) == 1:  # single-model shape
                    s = servers[default]
                    info.update(architecture=s.architecture, scale=s.scale,
                                served=s.n_served)
                self._json(info)
            elif self.path == "/statz":
                info = (_stats(servers[default]) if len(servers) == 1
                        else {n: _stats(s) for n, s in servers.items()})
                self._json(info)
            else:
                self._send(404, b"not found; POST an image to /sr",
                           "text/plain")

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/sr":
                self._send(404, b"POST to /sr", "text/plain")
                return
            # ?format=jpeg[&quality=90] or Accept: image/jpeg; PNG
            # (lossless) by default
            q = parse_qs(url.query)
            fmt = q.get("format", [None])[0]
            if fmt is None and "image/jpeg" in self.headers.get("Accept", ""):
                fmt = "jpeg"
            if fmt not in (None, "png", "jpeg", "jpg"):
                self._send(400, b"format must be png or jpeg", "text/plain")
                return
            try:
                quality = int(q.get("quality", ["90"])[0])
            except ValueError:
                self._send(400, b"quality must be an integer", "text/plain")
                return
            srv = servers.get(q.get("model", [default])[0])
            if srv is None:
                self._send(404, ("unknown model; available: "
                                 + ", ".join(servers)).encode(), "text/plain")
                return
            jpeg_out = fmt in ("jpeg", "jpg")
            if jpeg_out and not native.jpeg_available():
                self._send(415, ("the JPEG codec did not build here: "
                                 f"{native.build_error('fast_jpeg')}; ask "
                                 "for format=png").encode(), "text/plain")
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                self._send(400, b"Content-Length must be an integer",
                           "text/plain")
                return
            # <= 0 must 400 before the read: read(-1) would read to EOF,
            # pinning this thread on an open connection
            if length <= 0:
                self._send(400, b"image body required (<=64MB)", "text/plain")
                return
            if length > MAX_BODY:
                self._send(413, b"image body required (<=64MB)", "text/plain")
                return
            try:
                data = self.rfile.read(length)
            except OSError:
                self.close_connection = True  # peer vanished mid-body
                return
            if len(data) < length:
                # the client promised more bytes than it sent: the
                # connection is desynced; reject rather than decode half
                self._send(400, b"truncated body", "text/plain")
                return
            t_dec = time.perf_counter()
            try:
                img = native.decode_image(data)
            except native.UnsupportedImage as e:
                self._send(415, f"unsupported image: {e}".encode(),
                           "text/plain")
                return
            except ValueError:
                self._send(400, b"could not decode image", "text/plain")
                return
            srv.add_host_time("decode", time.perf_counter() - t_dec)
            t0 = time.perf_counter()
            sr = srv.upscale(img)
            dt = (time.perf_counter() - t0) * 1e3
            t_enc = time.perf_counter()
            if jpeg_out:
                body = native.encode_jpeg_rgb8(sr, quality)
                ctype = "image/jpeg"
            else:
                body = native.encode_png_rgb8(sr, srv.png_level)
                ctype = "image/png"
            srv.add_host_time("encode", time.perf_counter() - t_enc)
            try:
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("X-Inference-Ms", f"{dt:.1f}")
                self.end_headers()
                self.wfile.write(body)
            except OSError:
                self.close_connection = True

    return Handler


def _stats(s: SRServer) -> dict:
    """/statz of one server: the micro-batcher's coalescing counters and
    the cumulative seconds of each stage (the JAX server's keys)."""
    b = s.batcher
    info = {
        "served": s.n_served,
        "device_batches": b.n_batches,
        "batched_items": b.n_items,
        # < 1.0: the micro-batcher is coalescing; 1/max_batch: every
        # dispatch is a full batch
        "batches_per_item": (round(b.n_batches / b.n_items, 4)
                             if b.n_items else None),
        "max_batch": b.max_batch,
        "window_ms": b.window * 1e3,
        "adaptive_window": b.adaptive,
        "collect_window_ms": round(b.collect_window() * 1e3, 2),
        "queue_depth": b._q.qsize(),
        "t_collect_s": round(b.t_collect_s, 3),
        "t_h2d_s": round(b.t_h2d_s, 3),
        "t_exec_fetch_s": round(b.t_exec_fetch_s, 3),
        "rows_fetched": b.rows_fetched,
        "t_decode_s": round(s.t_decode_s, 3),
        "t_encode_s": round(s.t_encode_s, 3),
    }
    if b.instrument:
        info["t_exec_s"] = round(b.t_exec_s, 3)
        info["t_d2h_s"] = round(b.t_d2h_s, 3)
    return info


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_parser() -> argparse.ArgumentParser:
    """The CLI's flags: the JAX ``serve.py``'s, plus ``--device`` and
    ``--dtype``."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--architecture", default="AttentionSR",
                   help="model name, or 'auto' to infer architecture and "
                        "width/depth from --checkpoint tensor shapes")
    p.add_argument("--checkpoint", default="",
                   help="the port's torch checkpoint file (a best file, a "
                        "rolling *_last file, or a state_dict); empty = "
                        "seeded random weights (smoke)")
    p.add_argument("--scale_factor", type=int, default=4)
    p.add_argument("--tile", type=int, default=64)
    p.add_argument("--png_level", type=int, default=1,
                   help="PNG zlib level for responses (1=fastest, 9=smallest)")
    p.add_argument("--tta", action="store_true",
                   help="x8 geometric self-ensemble per request (quality "
                        "mode; 8x device work inside the same batch)")
    p.add_argument("--mesh", action="store_true",
                   help="shard device batches over all local cards (one "
                        "replica of the model per card)")
    p.add_argument("--max_batch", type=int, default=8,
                   help="micro-batcher device batch size (rounded up to a "
                        "multiple of the card count with --mesh)")
    p.add_argument("--warmup", action="store_true",
                   help="run each shape bucket once before listening "
                        "(cuDNN otherwise picks its algorithms on the first "
                        "request of each bucket)")
    p.add_argument("--warmup_sizes", default="",
                   help="comma-separated HxW LR bucket sizes to warm, e.g. "
                        "'64x64,224x224' (implies --warmup)")
    p.add_argument("--model", action="append", default=[],
                   metavar="NAME=ARCH[@CKPT]",
                   help="multi-model serving: repeat, e.g. --model "
                        "fast=SRCNN --model best=auto@w/attn_best.pth; "
                        "POST /sr?model=NAME routes (first entry is the "
                        "default). Overrides --architecture/--checkpoint.")
    p.add_argument("--quantize", default="", choices=["", "int8", "int8_dot"],
                   help="dynamic-int8 body convs (per-sample activation and "
                        "per-channel weight scales; int8_dot, JAX's "
                        "im2col lowering, is the same GEMM here). RESNET/"
                        "AttentionSR/RRDB; with --model, SRCNN entries are "
                        "served in float with a note")
    p.add_argument("--no_phase_tail", action="store_true",
                   help="run the materialized upsample tail instead of the "
                        "phase-space one (the same function and weights)")
    p.add_argument("--batch_window_ms", type=float, default=3.0,
                   help="micro-batcher coalescing window")
    p.add_argument("--adaptive_window", action="store_true", default=True,
                   help="(default on) extend the coalescing window toward "
                        "the measured batch-exec time while the previous "
                        "dispatch went out >=75%% full (sustained load); "
                        "sparse traffic keeps the short fixed window")
    p.add_argument("--no_adaptive_window", action="store_true",
                   help="disable the adaptive coalescing window (fixed "
                        "--batch_window_ms only)")
    p.add_argument("--instrument", action="store_true",
                   help="split device-execute vs D2H time per batch in "
                        "/statz (a device synchronize per batch; "
                        "attribution runs only)")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda; cpu for tests)")
    p.add_argument("--dtype", default="bfloat16", choices=sorted(_DTYPES))
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8700)
    return p


def parse_args(argv=None) -> argparse.Namespace:
    """Parsed flags with every ``--model`` spec validated (as ``specs``)
    before anything is built."""
    p = build_parser()
    a = p.parse_args(argv)
    specs = []
    for spec in a.model:
        name, _, rest = spec.partition("=")
        arch, _, ckpt = rest.partition("@")
        if not name or not arch:
            p.error(f"--model needs NAME=ARCH[@CKPT], got {spec!r}")
        if arch == "auto" and not ckpt:
            p.error(f"--model {spec!r}: auto requires @CKPT")
        if any(n == name for n, _, _ in specs):
            p.error(f"--model: duplicate name {name!r}")
        specs.append((name, arch, ckpt))
    a.specs = specs
    return a


def build_servers(a: argparse.Namespace):
    """(server or {name: server} zoo, default name or None) for parsed
    arguments; every --model spec was validated before any is built.

    In a zoo, ``--quantize`` means "quantize what can be", as in the JAX
    server: an SRCNN entry (by name, or an "auto" checkpoint that turns
    out to be one) has no body stack and is served in float with a note
    instead of failing the zoo. A single model stays strict."""
    def build(arch, ckpt, quantize=a.quantize):
        return SRServer(arch, checkpoint=ckpt or None, scale=a.scale_factor,
                        tile=a.tile, dtype=_DTYPES[a.dtype], device=a.device,
                        png_level=a.png_level, max_batch=a.max_batch,
                        tta=a.tta, window_ms=a.batch_window_ms,
                        instrument=a.instrument, use_mesh=a.mesh,
                        adaptive_window=(a.adaptive_window
                                         and not a.no_adaptive_window),
                        quantize=quantize, phase_tail=not a.no_phase_tail)

    def build_spec(name, arch, ckpt):
        q = a.quantize
        if q and arch == "SRCNN":
            print(f"--quantize {q}: model {name!r} (SRCNN) has no "
                  "quantizable body stack; serving it in float", flush=True)
            q = ""
        try:
            return build(arch, ckpt, q)
        except ValueError as e:
            if not (q and "quantizable" in str(e)):
                raise
            print(f"--quantize {q}: model {name!r} ({arch}) is not "
                  "quantizable; serving it in float", flush=True)
            return build(arch, ckpt, "")

    if a.specs:
        zoo = {name: build_spec(name, arch, ckpt)
               for name, arch, ckpt in a.specs}
        return zoo, next(iter(zoo))
    return build(a.architecture, a.checkpoint), None


def main(argv=None) -> None:
    a = parse_args(argv)
    srv, default = build_servers(a)
    zoo = srv if isinstance(srv, dict) else {"default": srv}
    try:
        if a.warmup or a.warmup_sizes:
            sizes = None
            if a.warmup_sizes:
                sizes = [tuple(int(v) for v in s.split("x"))
                         for s in a.warmup_sizes.split(",") if s]
            t0 = time.perf_counter()
            for s in zoo.values():
                s.warmup(sizes)
            print(f"warmup done in {time.perf_counter() - t0:.1f}s",
                  flush=True)
        httpd = SRHTTPServer((a.host, a.port), make_handler(srv, default))

        def _graceful(signum, _frame):
            print(f"signal {signum}: draining in-flight requests ...",
                  flush=True)
            threading.Thread(target=httpd.shutdown, daemon=True).start()

        signal.signal(signal.SIGTERM, _graceful)
        signal.signal(signal.SIGINT, _graceful)
        label = ", ".join(f"{n}={s.architecture}x{s.scale}"
                          for n, s in zoo.items())
        dev = zoo[default or "default"].device
        print(f"serving {label} on {dev} ({device_name(dev)}) at "
              f"http://{a.host}:{httpd.server_address[1]}  (POST /sr, GET "
              f"/healthz; jpeg {native.jpeg_available()})", flush=True)
        httpd.serve_forever()
        httpd.server_close()  # joins handler threads (block_on_close)
    finally:
        for s in zoo.values():
            s.close()
    n = sum(s.n_served for s in zoo.values())
    print(f"shut down cleanly after {n} image(s)", flush=True)


if __name__ == "__main__":
    main()
