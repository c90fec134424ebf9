#!/usr/bin/env python3
"""Host cost of the port's kernel wrappers, and of one NLPD call, on one GPU.

    python3 tools/port_wrapper_host.py [--root DIR] [--iters 200] [--out FILE]

Imports ``food101_sr_tpu_torch`` from ``--root`` (default: this checkout),
so that two trees, e.g. a parent commit unpacked with ``git archive``, can
be run in turns on one card and compared. It reports:

* ``host_us``: host microseconds per wrapper call, the time to enqueue
  ``--iters`` calls without waiting, for K1 (``ops.blur_kernel``) at the
  four NLPD pyramid levels, (16, 3, {200, 100, 50, 25}^2) float32, and for
  K2 (``ops.mean_kernel``) at the serving shapes (8, 96, {64, 224}^2)
  bfloat16, in NCHW and in channels-last memory (``"refused"`` where the
  tree's wrapper does not take that layout);
* ``ms``: CUDA-event milliseconds per call of the same, back to back;
* ``nlpd``: one ``losses.nlpd_loss`` call on (8, 3, 200, 200) float32 as
  ``MetricsCalculator`` makes it: event ms, host enqueue ms, and K1
  launches per call.

Prints one JSON object (and writes it to ``--out``); exits 1 without CUDA.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time

import torch

K1_SHAPES = [(16, 3, 200, 200), (16, 3, 100, 100), (16, 3, 50, 50),
             (16, 3, 25, 25)]
K2_SHAPES = [(8, 96, 64, 64), (8, 96, 224, 224)]


def _event_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _host_us(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


def _both(fn, iters: int) -> dict:
    return {"host_us": _host_us(fn, iters), "ms": _event_ms(fn, iters)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="tree to import the port from")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--out", default="",
                    help="also write the JSON object to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_wrapper_host: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    ops = importlib.import_module("food101_sr_tpu_torch.ops")
    nlpd = importlib.import_module("food101_sr_tpu_torch.losses.nlpd")
    if not ops.__file__.startswith(root):
        raise RuntimeError(f"imported {ops.__file__}, not from {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"card": smi, "root": root, "torch": torch.__version__,
              "k1": {}, "k2": {}}
    for shape in K1_SHAPES:
        x = torch.rand(shape, device="cuda", generator=gen)
        result["k1"]["x".join(map(str, shape))] = _both(
            lambda: ops.blur_kernel(x), args.iters)
    for shape in K2_SHAPES:
        base = torch.rand(shape, device="cuda", generator=gen) \
            .to(torch.bfloat16)
        row = {}
        for name, fmt in (("nchw", torch.contiguous_format),
                          ("channels_last", torch.channels_last)):
            x = base.contiguous(memory_format=fmt)
            try:
                ops.mean_kernel(x)
            except ValueError:
                row[name] = "refused"
                continue
            row[name] = _both(lambda: ops.mean_kernel(x), args.iters)
        result["k2"]["x".join(map(str, shape))] = row
    sr, hr = (torch.rand((8, 3, 200, 200), device="cuda", generator=gen)
              for _ in range(2))
    fn = lambda: nlpd.nlpd_loss(sr, hr)  # noqa: E731
    with ops.full_fp32():
        n0 = ops.blur_kernel.launches
        fn()
        launches = ops.blur_kernel.launches - n0
        result["nlpd"] = {"shape": [8, 3, 200, 200], "k1_launches": launches,
                          "ms": _event_ms(fn, 50),
                          "enqueue_ms": _host_us(fn, 50) / 1e3}
    line = json.dumps(result)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
