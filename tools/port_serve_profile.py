#!/usr/bin/env python3
"""Where the serving time goes in the PyTorch/CUDA port, on one GPU.

    python3 tools/port_serve_profile.py [--iters 20] [--out FILE]

For the registry AttentionSR x4 (32 blocks x 96 channels, seeded weights,
bf16) and each serving bucket (64x64 requests, 224x224 tiled windows; 8 rows
per device batch), three setups of the net, in one process and in turns
(A B C C B A):

* ``nchw+plane``: NCHW memory, SE squeeze through K2's plane kernel;
* ``channels_last+nhwc``: channels-last memory (the served setup), SE
  squeeze through K2's NHWC kernel;
* ``channels_last+x.mean``: channels-last memory, SE squeeze ``x.mean``.

For each setup and bucket:

* ``fwd_ms``: CUDA-event time per ``SRServer.forward_u8`` call (uint8 in,
  uint8 out, the device batch the micro-batcher runs), back to back, one
  entry per turn;
* ``enqueue_ms``: host time to enqueue one call without waiting; when it is
  close to ``fwd_ms`` the forward is host-bound;
* ``busy_share``: device kernel time over wall time in a profiled window of
  5 calls (``torch.profiler``), and the top kernels by device time;
* ``levels_vs_nchw``: the largest uint8 difference of its output from the
  NCHW net's on the same batch (cuDNN picks other algorithms per layout).

Also: the memory format at the input and output of the upsample tail and
of the 9x9 output conv, and at each SE block's input, in the served setup;
``images_per_s``: 64x64 requests from 16 threads through the micro-batcher,
as ``chip_smoke.py`` sends them.

Prints one JSON object (and writes it to ``--out``); exits 1 without CUDA.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from food101_sr_tpu_torch.models import layers  # noqa: E402
from food101_sr_tpu_torch.ops.spatial_mean import spatial_mean  # noqa: E402
from food101_sr_tpu_torch.serving import SRServer  # noqa: E402


def _event_ms(fn, iters: int) -> float:
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _enqueue_ms(fn, iters: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e3


def _profile(fn, calls: int = 5) -> dict:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key, str(ev.device_type)))
    rows.sort(reverse=True)
    # device rows only: CPU ops also carry their kernels' device time
    busy_ms = sum(r[0] for r in rows if r[3].endswith("CUDA"))
    return {"wall_ms": wall_ms, "device_ms": busy_ms,
            "busy_share": busy_ms / wall_ms if wall_ms else None,
            "top": [{"ms_per_call": ms / calls, "count": n // calls,
                     "type": t, "name": name[:90]}
                    for ms, n, name, t in rows[:12]]}


SETUPS = {"nchw+plane": (torch.contiguous_format, spatial_mean),
          "channels_last+nhwc": (torch.channels_last, spatial_mean),
          "channels_last+x.mean": (torch.channels_last,
                                   lambda x: x.mean((2, 3)))}


def _use(server, setup: str) -> None:
    fmt, squeeze = SETUPS[setup]
    server.model.memory_format = fmt
    server.model.to(memory_format=fmt)
    layers.spatial_mean = squeeze


def _formats(server, x8) -> dict:
    """Memory format (channels-last contiguous or not) at the tail's and
    the output conv's input and output, and at every SE block's input."""
    model, seen = server.model, {}

    def fmt(t):
        return ("channels_last" if t.is_contiguous(
            memory_format=torch.channels_last) else
            "nchw" if t.is_contiguous() else "other")

    def record(name):
        def hook(_, args, out):
            seen[f"{name}.in"] = fmt(args[0])
            seen[f"{name}.out"] = fmt(out)
        return hook

    hooks = [model.upsample.register_forward_hook(record("upsample")),
             model.output_conv.register_forward_hook(record("output_conv"))]
    se_in = []
    hooks += [blk.se.register_forward_pre_hook(
        lambda _, args: se_in.append(fmt(args[0]))) for blk in model.res_blocks]
    try:
        server.forward_u8(x8)
    finally:
        for h in hooks:
            h.remove()
    seen["se_blocks.in"] = sorted(set(se_in))
    return seen


def _bucket(server, x8, iters: int) -> dict:
    fwd = lambda: server.forward_u8(x8)  # noqa: E731
    out = {k: {"fwd_ms": [], "enqueue_ms": []} for k in SETUPS}
    ref = None
    order = list(SETUPS) + list(SETUPS)[::-1]  # A B C C B A
    try:
        for setup in order:
            _use(server, setup)
            for _ in range(3):  # cuDNN picks its algorithms per layout
                y = fwd()
            if ref is None:
                ref = y.cpu().numpy().astype(np.int16)
            out[setup]["levels_vs_nchw"] = int(np.abs(
                y.cpu().numpy().astype(np.int16) - ref).max())
            out[setup]["fwd_ms"].append(_event_ms(fwd, iters))
            out[setup]["enqueue_ms"].append(_enqueue_ms(fwd, iters))
        for setup in SETUPS:
            _use(server, setup)
            out[setup]["profile"] = _profile(fwd)
    finally:
        _use(server, "channels_last+nhwc")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default="",
                    help="also write the JSON object to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_serve_profile: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    server = SRServer("AttentionSR", device="cuda", dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    result = {"card": smi, "torch": torch.__version__, "buckets": {}}
    try:
        for side in (server.tile, server.tile + 2 * server.halo):
            x8 = torch.from_numpy(rng.integers(0, 256, (8, side, side, 3),
                                               np.uint8)).cuda()
            result["buckets"][f"{side}x{side}"] = _bucket(server, x8,
                                                          args.iters)
        result["memory_formats"] = _formats(server, x8)
        imgs = [rng.integers(0, 256, (64, 64, 3), np.uint8)
                for _ in range(256)]
        with cf.ThreadPoolExecutor(max_workers=16) as pool:
            list(pool.map(server.upscale, imgs[:16]))  # warm
            b0 = server.batcher.n_batches
            t0 = time.perf_counter()
            for i in range(0, len(imgs), 16):
                list(pool.map(server.upscale, imgs[i:i + 16]))
            dt = time.perf_counter() - t0
        result["batcher_64x64"] = {
            "images": len(imgs), "batches": server.batcher.n_batches - b0,
            "images_per_s": len(imgs) / dt}
    finally:
        server.close()
    line = json.dumps(result)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
