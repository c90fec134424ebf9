"""Throughput of the port on the card: ``python -m food101_sr_tpu_torch.bench``.

The counterpart of the root ``bench.py``'s measurement, with its modes,
argv, sizes and metric names:

    python -m food101_sr_tpu_torch.bench [--architecture NAME]
        [--train | --gan | --input | --quantize [int8|int8_dot] |
         --quantize_dot] [--device cuda|cpu]

- inference (default): the registry net (AttentionSR unless
  ``--architecture`` names SRCNN, RESNET or RRDB) as ``SRServer`` builds
  it, bf16 weights, channels-last, under ``torch.inference_mode()``, on a
  float32 [0, 1] batch of ``BATCH`` x ``LR_SIZE``^2 LR images: first with
  the materialized upsample tail (a provisional line, ``"tail":
  "standard"``), then with the phase-space tail (``"tail": "phase"``);
  SRCNN has no tail and runs once. ``--quantize`` serves the body convs in
  int8 (SRCNN refuses it, as the registry does);
- ``--train``: the supervised train step (bf16 compute on float32 master
  weights, the phase tail, NLPD, Adam 1e-4, diagnostics and the non-finite
  guard) on ``TRAIN_BATCH`` seeded uint8 200^2 crops on the device;
- ``--gan``: the GAN's G step on every batch and a D step every 5th, G
  and D in bf16 compute (G Adam 1e-4 clipped at 1.0, D Adam 1e-5), VGG19
  from ``weights/vgg19_features.npz`` or seeded, at ``GAN_BATCH`` x
  ``GAN_CROP``^2; images/s = batch / (t_G + t_D / 5);
- ``--input``: the host input pipeline alone, ``SRDataLoader`` with one
  worker thread (so images/s per core) over a seeded tree of 512^2 JPEGs
  written by the port's own encoder, its batches left on the host.

Every timing is overhead-cancelled: ``n_short`` and ``n_long`` calls
back to back, each run ended by reading one scalar of the last output
(which makes the host wait for the device's queue), the minimum of
``repeats`` runs each, and the slope between the two. stdout carries the
JSON lines only, the last one the result; ``vs_baseline`` is null in
every mode (no yardstick on the card). stderr carries ms per batch or
step, the device ms between CUDA events, peak device memory, the
kernels' launches per forward or step, and the card's name and power
limit. ``--device`` defaults to cuda, which needs a card; ``--device cpu``
runs the same programs on the CPU and tags the line ``"platform":
"cpu"``. The measuring functions take the sizes and counts as arguments,
with the module constants as defaults.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable

import numpy as np
import torch

from .models import Discriminator, build_model, get_model
from .ops import blur_kernel, mean_nhwc_kernel, mean_plane_kernel

BATCH = 256
LR_SIZE = 50
SCALE = 4
N_SHORT, N_LONG = 5, 25
REPEATS = 3
TRAIN_BATCH = 128
GAN_BATCH, GAN_CROP = 32, 192
GAN_N_SHORT, GAN_N_LONG = 3, 15
GAN_D_EVERY = 5
INPUT_IMAGES, INPUT_BATCHES, INPUT_BATCH_SIZE, INPUT_CROP = 8, 24, 16, 200
INPUT_SIDE, INPUT_QUALITY = 512, 90


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# the command line: the root bench.py's parsing and names
# ---------------------------------------------------------------------------

def parse_arch(argv) -> str:
    """--architecture NAME (default: the flagship AttentionSR)."""
    if "--architecture" in argv:
        i = argv.index("--architecture")
        nxt = argv[i + 1] if i + 1 < len(argv) else ""
        if nxt in ("SRCNN", "RESNET", "AttentionSR", "RRDB"):
            return nxt
        sys.exit(f"unknown --architecture {nxt!r} "
                 "(SRCNN|RESNET|AttentionSR|RRDB)")
    return "AttentionSR"


def parse_mode(argv):
    """(mode, quantize, arch) from the command line."""
    arch = parse_arch(argv)
    if "--input" in argv:
        return "input", "", arch
    if "--gan" in argv:
        return "gan", "", arch
    if "--train" in argv:
        return "train", "", arch
    quantize = ""
    if "--quantize_dot" in argv:
        quantize = "int8_dot"
    elif "--quantize" in argv:
        # the value form (--quantize int8_dot) or bare --quantize (int8);
        # an unknown mode is refused, not benchmarked as another lowering
        i = argv.index("--quantize")
        nxt = argv[i + 1] if i + 1 < len(argv) else ""
        if nxt in ("int8", "int8_dot"):
            quantize = nxt
        elif nxt and not nxt.startswith("-"):
            sys.exit(f"unknown --quantize mode {nxt!r} (int8|int8_dot)")
        else:
            quantize = "int8"
    return "infer", quantize, arch


def metric_name(mode: str, quantize: str, arch: str) -> tuple[str, str]:
    """(metric, unit) for a mode."""
    if mode == "input":
        return "input_pipeline_host_throughput", "images/sec/core"
    a = arch.lower()
    if mode == "gan":
        return f"{a}_x4_gan_train_throughput", "images/sec/chip"
    if mode == "train":
        return f"{a}_x4_train_throughput", "images/sec/chip"
    m = f"{a}_x4_inference_throughput"
    if quantize:
        m += f"_{quantize}"
    return m, "images/sec/chip"


def parse_device(argv) -> str:
    """--device cuda|cpu (default cuda)."""
    if "--device" in argv:
        i = argv.index("--device")
        nxt = argv[i + 1] if i + 1 < len(argv) else ""
        if nxt in ("cuda", "cpu"):
            return nxt
        sys.exit(f"unknown --device {nxt!r} (cuda|cpu)")
    return "cuda"


def _device(device: str | torch.device) -> torch.device:
    """``device``; a CUDA device needs a card (no move to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench: no CUDA device; pass --device cpu to run "
                           "on the CPU")
    return dev


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def launch_counts() -> dict[str, int]:
    """The kernel wrappers' launch counters (read, never reset here)."""
    return {"K1": blur_kernel.launches, "K2 nhwc": mean_nhwc_kernel.launches,
            "K2 nchw": mean_plane_kernel.launches}


def launches_of(fn: Callable[[], object]) -> dict[str, int]:
    """Kernel launches of one call of ``fn``, as counter differences."""
    before = launch_counts()
    fn()
    return {k: v - before[k] for k, v in launch_counts().items()}


def slope(run: Callable[[], torch.Tensor], n_short: int, n_long: int,
          repeats: int, device: torch.device) -> dict:
    """Overhead-cancelled seconds per call of ``run`` (which returns a
    tensor): ``n`` calls back to back, then the host reads one scalar
    (the sum) of the last result, which waits for the queue; the best of
    ``repeats`` runs at ``n_short`` and at ``n_long``, and the slope
    between them. On CUDA also the device ms per call between events
    recorded around the calls of the best runs. Returns ``s`` (seconds
    per call), ``device_ms`` (None on the CPU), ``t_short``, ``t_long``."""
    cuda = device.type == "cuda"

    def timed(n):
        best, best_dev = math.inf, None
        for _ in range(repeats):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            for _ in range(n):
                out = run()
            if cuda:
                end.record()
            float(out.float().sum())
            dt = time.perf_counter() - t0
            if dt < best:
                best = dt
                best_dev = start.elapsed_time(end) if cuda else None
        return best, best_dev

    (t_s, d_s), (t_l, d_l) = timed(n_short), timed(n_long)
    return {"s": (t_l - t_s) / (n_long - n_short),
            "device_ms": None if d_s is None
            else (d_l - d_s) / (n_long - n_short),
            "t_short": t_s, "t_long": t_l}


def _peak_reset(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def _peak_gib(device: torch.device) -> float | None:
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**30


def _report(what: str, t: dict, per: str, n: int, launches: dict,
            peak: float | None, warm_s: float) -> None:
    dev = ("not measured (cpu)" if t["device_ms"] is None
           else f"{t['device_ms']:.3f} ms")
    mem = "not measured (cpu)" if peak is None else f"{peak:.3f} GiB"
    log(f"{what}: {n / t['s']:.1f} images/s | {t['s'] * 1e3:.3f} ms / {per} "
        f"(t_short {t['t_short'] * 1e3:.1f} ms, t_long "
        f"{t['t_long'] * 1e3:.1f} ms) | device {dev} / {per} | peak {mem} | "
        f"launches / {per} {launches} | first call {warm_s:.1f} s")


# ---------------------------------------------------------------------------
# the legs
# ---------------------------------------------------------------------------

def build_infer(arch: str = "AttentionSR", quantize: str = "",
                phase_tail: bool = True, device="cuda",
                dtype: torch.dtype = torch.bfloat16):
    """(model, forward): the registry net as ``SRServer`` holds it (the
    weights cast to ``dtype`` once, channels-last, eval mode) and its
    forward of a float32 [0, 1] (N, 3, H, W) batch under
    ``torch.inference_mode()``, cast to ``dtype`` on the way in."""
    model = get_model(arch, scale_factor=SCALE, dtype=dtype, device=device,
                      quantize=quantize, phase_tail=phase_tail)

    @torch.inference_mode()
    def forward(x: torch.Tensor) -> torch.Tensor:
        return model(x.to(dtype))

    return model, forward


def lr_batch(batch: int, lr_size: int, device) -> torch.Tensor:
    """The root bench's input: float32 uniform [0, 1] from
    ``default_rng(0)``, NHWC, viewed as a channels-last (N, 3, H, W)."""
    x = np.random.default_rng(0).uniform(
        0, 1, (batch, lr_size, lr_size, 3)).astype(np.float32)
    return torch.from_numpy(x).to(device).permute(0, 3, 1, 2)


def bench_infer(arch: str = "AttentionSR", quantize: str = "",
                phase_tail: bool = True, batch: int = BATCH,
                lr_size: int = LR_SIZE, n_short: int = N_SHORT,
                n_long: int = N_LONG, repeats: int = REPEATS,
                device="cuda") -> dict:
    """Inference images/s (``ips``) of ``build_infer``'s forward, with
    ``ms`` per batch, ``device_ms``, ``peak_gib`` and ``launches`` per
    forward."""
    device = _device(device)
    _, forward = build_infer(arch, quantize, phase_tail, device)
    x = lr_batch(batch, lr_size, device)
    _peak_reset(device)
    t0 = time.perf_counter()
    float(forward(x).float().sum())
    warm_s = time.perf_counter() - t0
    t = slope(lambda: forward(x), n_short, n_long, repeats, device)
    launches = launches_of(lambda: float(forward(x).float().sum()))
    peak = _peak_gib(device)
    tail = "" if arch == "SRCNN" else (" phase tail" if phase_tail
                                       else " standard tail")
    _report(f"infer {arch}{tail}{' ' + quantize if quantize else ''} "
            f"batch {batch} of {lr_size}^2", t, "batch", batch, launches,
            peak, warm_s)
    return {"ips": batch / t["s"], "ms": t["s"] * 1e3,
            "device_ms": t["device_ms"], "peak_gib": peak,
            "launches": launches}


def build_train(arch: str = "AttentionSR", device="cuda",
                dtype: torch.dtype = torch.bfloat16):
    """(state, step): the registry net on float32 master weights computing
    in ``dtype`` (bf16; float32 runs without a compute dtype), the phase
    tail (SRCNN has none), Adam 1e-4 and the NLPD train step."""
    from .losses import nlpd_loss
    from .training import (FIRST_LAST, SRTrainState, make_adam,
                           make_train_step)

    model = get_model(arch, scale_factor=SCALE, device=device,
                      phase_tail=arch != "SRCNN",
                      compute_dtype=None if dtype == torch.float32 else dtype)
    state = SRTrainState.create(model, make_adam(1e-4))
    first, last = FIRST_LAST[arch]
    return state, make_train_step(model, nlpd_loss, SCALE, first, last)


def hr_batch(batch: int, crop: int, device) -> torch.Tensor:
    """The root bench's train input: uint8 (batch, crop, crop, 3) from
    ``default_rng(0)``, on ``device``."""
    return torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (batch, crop, crop, 3), dtype=np.uint8)).to(device)


def bench_train(arch: str = "AttentionSR", batch: int = TRAIN_BATCH,
                crop: int = LR_SIZE * SCALE, n_short: int = N_SHORT,
                n_long: int = N_LONG, repeats: int = REPEATS, device="cuda",
                dense_layout: str | None = None) -> dict:
    """Train-step images/s (``ips``) of ``build_train``'s step, with ``ms``
    per step, ``device_ms``, ``peak_gib`` and ``launches`` per step.
    ``dense_layout`` sets RRDB's dense layout (the net's "auto" when
    None)."""
    device = _device(device)
    state, step = build_train(arch, device)
    if dense_layout is not None:
        state.model.dense_layout = dense_layout
    hr = hr_batch(batch, crop, device)

    def run():
        return step(state, hr)[1]["train_loss"]

    _peak_reset(device)
    t0 = time.perf_counter()
    float(run())
    warm_s = time.perf_counter() - t0
    t = slope(run, n_short, n_long, repeats, device)
    launches = launches_of(lambda: float(run()))
    peak = _peak_gib(device)
    layout = f" {dense_layout}" if dense_layout else ""
    _report(f"train {arch}{layout} batch {batch} of {crop}^2", t, "step",
            batch, launches, peak, warm_s)
    return {"ips": batch / t["s"], "ms": t["s"] * 1e3,
            "device_ms": t["device_ms"], "peak_gib": peak,
            "launches": launches}


def build_gan(arch: str = "AttentionSR", device="cuda"):
    """(g_state, d_state, d_step, g_step): the registry generator (phase
    tail, seed 0) with Adam 1e-4 clipped at 1.0, the Discriminator (seed
    2) with Adam 1e-5, both computing in bf16 on float32 weights, and the
    perceptual loss's VGG19 (``weights/vgg19_features.npz``, or seeded
    when it is absent)."""
    from .losses import get_loss_function
    from .training import (FIRST_LAST, SRTrainState, make_adam,
                           make_gan_d_step, make_gan_g_step)

    g = get_model(arch, scale_factor=SCALE, device=device, phase_tail=True,
                  compute_dtype=torch.bfloat16)
    d = build_model(lambda: Discriminator(compute_dtype=torch.bfloat16),
                    device=device, generator=torch.Generator().manual_seed(2))
    g_state = SRTrainState.create(g, make_adam(1e-4, clip_norm=1.0))
    d_state = SRTrainState.create(d, make_adam(1e-5))
    percep = get_loss_function("perceptual", weights_dir="weights",
                               device=device)
    first, last = FIRST_LAST[arch]
    return (g_state, d_state, make_gan_d_step(g, d, SCALE),
            make_gan_g_step(g, d, percep, SCALE, first, last))


def bench_gan(arch: str = "AttentionSR", batch: int = GAN_BATCH,
              crop: int = GAN_CROP, n_short: int = GAN_N_SHORT,
              n_long: int = GAN_N_LONG, repeats: int = REPEATS,
              device="cuda") -> dict:
    """GAN images/s (``ips``), batch / (t_G + t_D / GAN_D_EVERY), with the
    G and D steps' ``g_ms`` and ``d_ms``, their ``g_device_ms`` and
    ``d_device_ms``, ``peak_gib`` and ``launches`` per G and D step."""
    device = _device(device)
    g_state, d_state, d_step, g_step = build_gan(arch, device)
    hr = hr_batch(batch, crop, device)
    noise = torch.Generator(device=device).manual_seed(0)

    def d_run():
        return d_step(g_state, d_state, hr, noise)[1]["train_loss_D"]

    def g_run():
        return g_step(g_state, d_state, hr)[2]["train_loss"]

    _peak_reset(device)
    t0 = time.perf_counter()
    float(d_run())
    float(g_run())
    warm_s = time.perf_counter() - t0
    t_d = slope(d_run, n_short, n_long, repeats, device)
    t_g = slope(g_run, n_short, n_long, repeats, device)
    launches = {"G": launches_of(lambda: float(g_run())),
                "D": launches_of(lambda: float(d_run()))}
    peak = _peak_gib(device)
    ips = batch / (t_g["s"] + t_d["s"] / GAN_D_EVERY)
    _report(f"gan {arch} G step batch {batch} of {crop}^2", t_g, "step",
            batch, launches["G"], peak, warm_s)
    _report(f"gan {arch} D step batch {batch} of {crop}^2", t_d, "step",
            batch, launches["D"], peak, warm_s)
    log(f"gan: {ips:.1f} images/s effective (D every {GAN_D_EVERY}th)")
    return {"ips": ips, "g_ms": t_g["s"] * 1e3, "d_ms": t_d["s"] * 1e3,
            "g_device_ms": t_g["device_ms"],
            "d_device_ms": t_d["device_ms"], "peak_gib": peak,
            "launches": launches}


def _write_jpeg_tree(root: str, n_images: int = INPUT_IMAGES,
                    side: int = INPUT_SIDE) -> list[str]:
    """A Food-101-layout tree under ``root`` (``food-101/images/pizza``,
    ``meta/train.txt``) of ``n_images`` seeded photo-like ``side``^2
    JPEGs (uniform noise smoothed twice, as the root bench's), encoded at
    quality ``INPUT_QUALITY`` by the port's own encoder. Returns the
    stems."""
    from . import native

    base = os.path.join(root, "food-101")
    os.makedirs(os.path.join(base, "meta"))
    os.makedirs(os.path.join(base, "images", "pizza"))
    rng = np.random.default_rng(0)
    stems = []
    for k in range(n_images):
        x = rng.integers(0, 255, (side, side, 3)).astype(np.float32)
        for _ in range(2):
            x = (x + np.roll(x, 1, 0) + np.roll(x, 1, 1)) / 3
        img = np.clip(x, 0, 255).astype(np.uint8)
        with open(os.path.join(base, "images", "pizza", f"im{k}.jpg"),
                  "wb") as f:
            f.write(native.encode_jpeg_rgb8(img, INPUT_QUALITY))
        stems.append(f"pizza/im{k}")
    with open(os.path.join(base, "meta", "train.txt"), "w") as f:
        f.write("\n".join(stems))
    return stems


def bench_input(n_images: int = INPUT_IMAGES, batches: int = INPUT_BATCHES,
                batch_size: int = INPUT_BATCH_SIZE, crop: int = INPUT_CROP,
                side: int = INPUT_SIDE) -> dict:
    """Host input-pipeline images/s per core (``ips``): ``batches``
    batches of ``batch_size`` ``crop``^2 train crops through
    ``SRDataLoader`` with one worker thread, its batches on the host, over
    :func:`_write_jpeg_tree` (in a temporary directory, removed after);
    one warm-up pass, then one timed pass. Also ``ms`` per batch."""
    from .data import Food101Source, SRDataLoader

    with tempfile.TemporaryDirectory(prefix="bench_input_") as root:
        _write_jpeg_tree(root, n_images, side)
        src = Food101Source(root=root, split="train")
        idx = np.arange(batches * batch_size) % n_images

        def run() -> float:
            loader = SRDataLoader(src, indices=idx, crop_size=crop,
                                  batch_size=batch_size, train=True, seed=0,
                                  device="cpu", num_workers=1)
            n = 0
            t0 = time.perf_counter()
            for b in loader:
                n += b.shape[0]
            return n / (time.perf_counter() - t0)

        run()  # page cache, the codec's first load
        ips = run()
    log(f"input pipeline: {ips:.1f} images/s on one worker thread "
        f"({batch_size / ips * 1e3:.2f} ms / batch of {batch_size} "
        f"{crop}^2 crops from {side}^2 JPEGs; {os.cpu_count()} cores)")
    return {"ips": ips, "ms": batch_size / ips * 1e3}


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    mode, quantize, arch = parse_mode(argv)
    device = _device(parse_device(argv))
    metric, unit = metric_name(mode, quantize, arch)
    if device.type == "cuda":
        log(f"card: {card()} | torch {torch.__version__} cuda "
            f"{torch.version.cuda}")
    else:
        log(f"device: cpu | torch {torch.__version__}")

    def result(value: float, **extra) -> str:
        return json.dumps({"metric": metric, "value": round(value, 1),
                           "unit": unit, "vs_baseline": None, **extra})

    tail = {}
    if mode == "input":
        value = bench_input()["ips"]
    elif mode == "gan":
        value = bench_gan(arch, device=device)["ips"]
    elif mode == "train":
        value = bench_train(arch, device=device)["ips"]
    elif arch == "SRCNN":
        value = bench_infer(arch, quantize, device=device)["ips"]
    else:
        std = bench_infer(arch, quantize, phase_tail=False, device=device)
        print(result(std["ips"], tail="standard"), flush=True)
        value = bench_infer(arch, quantize, phase_tail=True,
                            device=device)["ips"]
        tail = {"tail": "phase"}
    platform = {"platform": "cpu"} if device.type == "cpu" else {}
    print(result(value, **tail, **platform), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
