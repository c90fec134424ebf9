#!/usr/bin/env python3
"""What sets the pace of the port's training loop on one GPU: the train
step alone, the loader alone, and the step while the loader's threads
work beside it.

    python3 tools/port_loop_contention.py [--steps 10] [--out FILE]
    python3 tools/port_loop_contention.py --cublas_ab [--steps 10] [--out FILE]

The step is ``training.make_train_step`` on the registry AttentionSR x4
(f32, channels-last, NLPD, fused Adam 4e-4) on one device-resident batch
of 16 uint8 200 px crops, so no input work is inside it. The loader is
``data.SRDataLoader`` over ``SyntheticSource`` at crop 200, batch 16, as
``training.train`` builds it. Legs, run in turns and then in reverse
(A B C D E F F E D C B A) so drift shows as a difference between the turns:

* ``alone``: the step, nothing else running;
* ``alone_det``: the same under ``torch.use_deterministic_algorithms``
  (the switch chip_smoke.py's loop phase sets);
* ``loader_w{N}``: the step while a background thread drains an
  ``SRDataLoader`` with N worker threads (N = 8, the default on an
  8-core host, and 2);
* ``loader_only_w{N}``: the loader alone, draining batches with no step.

The legs run with ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (what deterministic
cuBLAS needs). ``--cublas_ab`` runs instead the ``alone`` leg in four
child processes, with the variable and without it in turns (with,
without, without, with), since cuBLAS reads it only when CUDA starts.

Per leg: ``step_ms`` (CUDA events around each step), ``host_ms`` (host
clock per step, synchronised at the end), and for loader legs the
batches per second the loader delivered meanwhile. Prints one
JSON object (and writes it to ``--out``) with the card's name and power
limit; exits 1 without CUDA.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BATCH, CROP, LR = 16, 200, 4e-4
CUBLAS_VAR, CUBLAS_WORKSPACE = "CUBLAS_WORKSPACE_CONFIG", ":4096:8"


def _drain(loader, stop: threading.Event, counts: dict) -> None:
    """Consume ``loader`` epoch after epoch until ``stop`` is set."""
    epoch = 0
    while not stop.is_set():
        loader.set_epoch(epoch)
        for _ in loader:
            counts["batches"] += 1
            if stop.is_set():
                break
        epoch += 1


def _cublas_ab(steps: int) -> dict:
    """The ``alone`` leg in child processes, with and without the cuBLAS
    workspace variable."""
    turns = []
    for with_var in (True, False, False, True):
        env = dict(os.environ)
        env.pop(CUBLAS_VAR, None)
        if with_var:
            env[CUBLAS_VAR] = CUBLAS_WORKSPACE
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--alone_only", "--steps", str(steps)],
                             env=env, capture_output=True, text=True,
                             timeout=600)
        if out.returncode != 0:
            raise RuntimeError(f"child exited {out.returncode}: "
                               f"{out.stderr[-2000:]}")
        leg = json.loads(out.stdout.strip().splitlines()[-1])["legs"]["alone"][0]
        turns.append({CUBLAS_VAR: env.get(CUBLAS_VAR), **leg})
        print(f"cublas_ab: {turns[-1]}", flush=True)
    return {"cublas_ab": turns}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default="")
    ap.add_argument("--cublas_ab", action="store_true",
                    help="the step alone in child processes, with and "
                         "without CUBLAS_WORKSPACE_CONFIG")
    ap.add_argument("--alone_only", action="store_true",
                    help="only the alone leg, once, in the environment "
                         "given (one child of --cublas_ab)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_loop_contention: no CUDA device", file=sys.stderr)
        return 1
    if not (args.cublas_ab or args.alone_only):
        os.environ.setdefault(CUBLAS_VAR, CUBLAS_WORKSPACE)
    from food101_sr_tpu_torch.data import SRDataLoader, SyntheticSource
    from food101_sr_tpu_torch.losses import get_loss_function
    from food101_sr_tpu_torch.models import get_model
    from food101_sr_tpu_torch.training import (FIRST_LAST, SRTrainState,
                                               make_adam, make_train_step)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    if args.cublas_ab:
        return _emit({"card": smi, "device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__, "steps": args.steps,
                      "batch": BATCH, "crop": CROP,
                      **_cublas_ab(args.steps)}, args.out)
    model = get_model("AttentionSR", device="cuda")
    state = SRTrainState.create(model, make_adam(LR))
    step = make_train_step(model, get_loss_function("nlpd"), 4,
                           *FIRST_LAST["AttentionSR"])
    hr = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (BATCH, CROP, CROP, 3), np.uint8)).cuda()
    for _ in range(3):
        state, _ = step(state, hr)
    torch.cuda.synchronize()

    def steps() -> dict:
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(2 * args.steps)]
        t0 = time.perf_counter()
        for i in range(args.steps):
            ev[2 * i].record()
            step(state, hr)
            ev[2 * i + 1].record()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) / args.steps * 1e3
        ms = [ev[2 * i].elapsed_time(ev[2 * i + 1])
              for i in range(args.steps)]
        return {"step_ms": float(np.mean(ms)), "host_ms": host}

    def with_loader(workers: int, run_steps: bool) -> dict:
        loader = SRDataLoader(SyntheticSource(n=512), crop_size=CROP,
                              batch_size=BATCH, train=True, device="cuda",
                              num_workers=workers)
        stop, counts = threading.Event(), {"batches": 0}
        t = threading.Thread(target=_drain, args=(loader, stop, counts))
        t.start()
        time.sleep(0.5)  # the producer is past its first batch
        b0, t0 = counts["batches"], time.perf_counter()
        out = steps() if run_steps else (time.sleep(2.0) or {})
        out["loader_batches_per_s"] = ((counts["batches"] - b0)
                                       / (time.perf_counter() - t0))
        stop.set()
        t.join(timeout=60)
        if t.is_alive():
            raise RuntimeError("the loader thread did not stop")
        return out

    def deterministic() -> dict:
        from torch.utils import deterministic as det

        torch.use_deterministic_algorithms(True)
        det.fill_uninitialized_memory = False  # as chip_smoke.py's loop phase
        try:
            return steps()
        finally:
            torch.use_deterministic_algorithms(False)
            det.fill_uninitialized_memory = True

    legs = {"alone": steps, "alone_det": deterministic,
            "loader_w8": lambda: with_loader(8, True),
            "loader_w2": lambda: with_loader(2, True),
            "loader_only_w8": lambda: with_loader(8, False),
            "loader_only_w2": lambda: with_loader(2, False)}
    order = (["alone"] if args.alone_only
             else list(legs) + list(reversed(legs)))
    results: dict = {k: [] for k in legs}
    for name in order:
        results[name].append(legs[name]())
        print(f"{name}: {results[name][-1]}", flush=True)
    return _emit({"card": smi, "device": torch.cuda.get_device_name(0),
                  "torch": torch.__version__, "steps": args.steps,
                  "batch": BATCH, "crop": CROP, "order": order,
                  "legs": {k: v for k, v in results.items() if v}}, args.out)


def _emit(record: dict, out: str) -> int:
    """Print the record as one JSON line and write it to ``out``."""
    line = json.dumps(record)
    print(line, flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
