#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (food101_sr_tpu_torch) once on one NVIDIA
GPU and check it.

    python3 chip_smoke.py

Phases, one short line each; any failure raises and the exit code is 1:

1. env    nvidia-smi's name and power limit, torch and nvcc versions
2. build  nvcc builds the CUDA kernels from csrc/ (no PyTorch headers)
3. K1     the blur kernel against its plain version, forward and backward,
          at the NLPD metric's shapes; times per pyramid: the wrapper's
          (CUDA events), the device's alone (a CUDA graph of the calls,
          replayed), the host's per call (enqueue), the plain version's
          and F.conv2d's
4. K2     both spatial-mean entry points against the plain version, bf16
          and f32, at the SE squeeze's serving shapes: the NHWC kernel on
          channels-last input (the main path) and the plane kernel on
          NCHW input, with the same times and x.mean as the yardstick
5. serve  the registry AttentionSR x4 (32 blocks x 96 channels, seeded
          weights, bf16, channels-last) serves 64x64 requests from 16
          threads at a time
          and one 256x256 request (tiled: halo 80, 224 px windows); each
          batched result is held against a direct forward of its input
          alone, and tiling against the whole image in float32
          through the batcher's adaptive window (serve.py's default)
6. score  a seeded HR batch is degraded, served, and scored (PSNR, SSIM,
          LPIPS, NLPD through K1); NLPD and LPIPS are held against the
          plain CPU calculator's
7. close  the server stops
8. train  the supervised step on the registry AttentionSR x4 (float32,
          channels-last, train mode), NLPD loss, Adam 4e-4, batch 16 of
          seeded 200x200 uint8 crops made on the device: one step's raw
          gradients on 2 crops against the CPU's plain path (TF32 off);
          2 warm-up and 10 timed steps (the loss falls); K1 and K2 at
          the step's shapes against their plain versions, with their
          times; the NCHW copy before the pyramid and the target half of
          K1's backward, timed; the non-finite guard; the eval step; a
          profile of 3 steps; peak memory
9. done   the kernels' JSON line and the elapsed time

Kernel launch counts (one per entry point) are zeroed just before each
main path and read just after it: serving (the serve and score phases:
K2 32 per device batch, all through the NHWC entry, and K1 4 for the one
NLPD call) and one train step (K1 4 forward and 4 backward, K2 NHWC 32,
K2 plane 0). The last line is the JSON device record; the line before it
is the kernels' JSON.
Exits non-zero, printing no result, when no CUDA device is present.
"""
from __future__ import annotations

import concurrent.futures as cf
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

K1_SHAPES = [(16, 3, 200, 200), (16, 3, 100, 100), (16, 3, 50, 50),
             (16, 3, 25, 25), (8, 3, 13, 13), (3, 5, 37, 61)]
# the blurs of one NLPD call on 8 images of 200 px: pred and target share
# one pyramid, so 16 images per level
PYRAMID = K1_SHAPES[:4]
K2_SHAPES = [(8, 96, 64, 64), (8, 96, 224, 224)]  # batch / tiled bucket
K1_TOL = 1e-5   # abs; float32, the same 25 products summed in another order
K2_RTOL = 1e-5  # float32; bf16 is held to one bf16 ulp
NLPD_RTOL = 1e-5
LPIPS_RTOL = 1e-4  # AlexNet convs in float32, cuDNN against the CPU
LEVEL_TOL = 1   # uint8 levels between served and direct forward
# the train step: the training loop's defaults (batch 16 of 200 px crops,
# NLPD, Adam 4e-4); gradients on 2 crops held per leaf within 5e-5 of the
# leaf's largest sum of absolute terms (float32 sums in another order;
# _term_sums says why not of the gradient's own max abs)
TRAIN_BATCH, TRAIN_CROP, TRAIN_LR = 16, 200, 4e-4
WARMUP_STEPS, TIMED_STEPS, PROFILED_STEPS = 2, 10, 3
GRAD_BATCH, GRAD_TOL = 2, 5e-5

# Peak rates (NVIDIA data sheets, dense): HBM bytes/s and float32 (non-tensor)
# flop/s by card model; matched against the device name, first hit wins.
CARD_RATES = [("H100 PCIe", 2.0e12, 51e12), ("H100 NVL", 3.9e12, 60e12),
              ("H200", 4.8e12, 67e12), ("H100", 3.35e12, 67e12)]


def card_rates(name: str) -> tuple[float, float]:
    for key, bw, fp32 in CARD_RATES:
        if key in name:
            return bw, fp32
    raise RuntimeError(f"no peak rates recorded for {name!r}")


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds per call, CUDA events around back-to-back calls."""
    for _ in range(warmup):
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


def device_ms(fn, calls: int = 10, replays: int = 20) -> float:
    """Device milliseconds per call of ``fn`` with the host taken out:
    ``calls`` calls captured in one CUDA graph (the wrappers' ctypes
    launches go to PyTorch's current stream, which capture records), the
    graph replayed back to back under CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, replays, warmup=2) / calls


def host_us(fn, launches: int, iters: int = 100) -> float:
    """Host microseconds per wrapper call: the time to enqueue ``iters``
    calls of ``fn`` (``launches`` wrapper calls each) without waiting."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / (iters * launches) * 1e6


def bound(nbytes: float, flops: float, rates) -> tuple[float, str]:
    """Least time (ms) for the work: bytes over HBM rate vs flops over peak."""
    t_bytes, t_ops = nbytes / rates[0] * 1e3, flops / rates[1] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_env() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from food101_sr_tpu_torch import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[-1]
    print(f"env: torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{nvcc} | {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}", flush=True)
    return smi


def phase_build() -> None:
    from food101_sr_tpu_torch import _build

    t0 = time.perf_counter()
    _build.kernels()
    print(f"build: nvcc {' '.join(_build.NVCC_FLAGS)} -> "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


def _timings(fn, plain, library, launches: int) -> dict:
    """Wrapper, device-only, host and yardstick times of one workload."""
    return {"ms": cuda_ms(fn), "device_ms": device_ms(fn),
            "host_us": host_us(fn, launches), "plain_ms": cuda_ms(plain),
            "library_ms": cuda_ms(library)}


def phase_k1(rates) -> dict:
    from food101_sr_tpu_torch.ops.gaussian import (depthwise_blur,
                                                   gaussian_kernel_2d)
    from food101_sr_tpu_torch.ops.pallas_blur import blur, blur_kernel
    from food101_sr_tpu_torch.ops.precision import full_fp32

    gen = torch.Generator(device="cuda").manual_seed(1)
    err = 0.0
    for shape in K1_SHAPES:
        x = torch.rand(shape, device="cuda", generator=gen)
        g = torch.rand(shape, device="cuda", generator=gen)
        err = max(err, (blur_kernel(x) - depthwise_blur(x)).abs().max().item())
        xa = x.clone().requires_grad_(True)
        (blur(xa, 5, 1.0) * g).sum().backward()
        xb = x.clone().requires_grad_(True)
        (depthwise_blur(xb) * g).sum().backward()
        err = max(err, (xa.grad - xb.grad).abs().max().item())
    torch.cuda.synchronize()
    if not err <= K1_TOL:
        raise AssertionError(f"K1 disagrees with its plain version: {err}")

    xs = [torch.rand(s, device="cuda", generator=gen) for s in PYRAMID]
    w = torch.from_numpy(gaussian_kernel_2d(5, 1.0)).cuda().expand(3, 1, 5, 5)
    # TF32 off for the yardstick conv, entered once around all the timing
    # so that no timed call pays for the switch
    with full_fp32():
        t = _timings(lambda: [blur_kernel(x) for x in xs],
                     lambda: [depthwise_blur(x) for x in xs],
                     lambda: [F.conv2d(x, w, padding=2, groups=3) for x in xs],
                     launches=len(xs))
    nbytes = sum(2 * x.numel() * 4 for x in xs)
    bound_ms, bound_by = bound(nbytes, sum(20 * x.numel() for x in xs), rates)
    print(f"K1 blur: max_abs_err {err:.3g} (tol {K1_TOL}, fwd+bwd, "
          f"{len(K1_SHAPES)} shapes) | pyramid 16x3x{{200,100,50,25}}^2 f32: "
          f"kernel {t['ms']:.4f} ms, device {t['device_ms']:.4f}, "
          f"host {t['host_us']:.1f} us/call, "
          f"plain {t['plain_ms']:.4f}, conv2d {t['library_ms']:.4f}, "
          f"bound {bound_ms:.4f} ({bound_by})", flush=True)
    return {"name": "K1 depthwise Gaussian blur 5x5", "route": "cuda",
            "source": "food101_sr_tpu_torch/csrc/kernels.cu",
            "replaces": "food101_sr_tpu/ops/pallas_blur.py:65",
            "wrapper": "food101_sr_tpu_torch/ops/pallas_blur.py:blur_kernel",
            "at": "4 launches: (16,3,200,200),(16,3,100,100),(16,3,50,50),"
                  "(16,3,25,25) float32; host_us per launch",
            "max_abs_err": err, **t, "bound_ms": bound_ms,
            "bound_by": bound_by}


def _ulp_bf16(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each value (8 significant bits)."""
    e = torch.floor(torch.log2(v.abs().clamp_min(2.0**-126)))
    return torch.pow(2.0, e - 7)


def phase_k2(rates) -> list[dict]:
    """Both K2 entry points, each on its layout: the NHWC kernel on
    channels-last input (the main path), the plane kernel on NCHW."""
    from food101_sr_tpu_torch.ops.spatial_mean import (mean_nhwc_kernel,
                                                       mean_plane_kernel,
                                                       spatial_mean_plain)

    entries = {"nhwc": (mean_nhwc_kernel, torch.channels_last),
               "nchw": (mean_plane_kernel, torch.contiguous_format)}
    gen = torch.Generator(device="cuda").manual_seed(2)
    errs = {k: [0.0, 0.0, 0.0] for k in entries}  # abs, f32 rel, bf16 ulp
    for shape in K2_SHAPES:
        base = torch.rand(shape, device="cuda", generator=gen) * 2.0 - 0.5
        for dtype in (torch.float32, torch.bfloat16):
            for key, (kernel, layout) in entries.items():
                x = base.to(dtype).contiguous(memory_format=layout)
                got, want = kernel(x).float(), spatial_mean_plain(x).float()
                diff = (got - want).abs()
                e = errs[key]
                e[0] = max(e[0], diff.max().item())
                if dtype == torch.float32:
                    e[1] = max(e[1], (diff / want.abs().clamp_min(1e-6))
                               .max().item())
                else:
                    e[2] = max(e[2], (diff / _ulp_bf16(want)).max().item())
    torch.cuda.synchronize()
    for key, (_, rel, ulp) in errs.items():
        if not (rel <= K2_RTOL and ulp <= 1.0):
            raise AssertionError(f"K2 {key} disagrees with its plain "
                                 f"version: rel {rel} (f32), {ulp} ulp (bf16)")

    records = []
    for key, (kernel, layout) in entries.items():
        per_shape = {}
        for shape in K2_SHAPES:
            x = (torch.rand(shape, device="cuda", generator=gen)
                 .to(torch.bfloat16).contiguous(memory_format=layout))
            n = int(np.prod(shape))
            t = _timings(lambda: kernel(x), lambda: spatial_mean_plain(x),
                         lambda: x.mean((2, 3)), launches=1)
            t["bound_ms"], t["bound_by"] = bound(
                2 * n + 2 * shape[0] * shape[1], n, rates)
            per_shape[shape] = t
        big, small = per_shape[K2_SHAPES[1]], per_shape[K2_SHAPES[0]]
        abs_err, rel, ulp = errs[key]
        print(f"K2 spatial mean, {key} ({kernel.__name__}): max_abs_err "
              f"{abs_err:.3g} (f32 rel {rel:.2g} <= {K2_RTOL}, bf16 "
              f"{ulp:.2g} ulp <= 1)", flush=True)
        for shape, t in per_shape.items():
            print(f"  bf16 {'x'.join(map(str, shape))}: kernel "
                  f"{t['ms']:.4f} ms, device {t['device_ms']:.4f}, "
                  f"host {t['host_us']:.1f} us, "
                  f"plain {t['plain_ms']:.4f}, x.mean {t['library_ms']:.4f}, "
                  f"bound {t['bound_ms']:.4f} ({t['bound_by']})", flush=True)
        records.append({
            "name": f"K2 spatial mean (SE squeeze), {key} input",
            "route": "cuda", "source": "food101_sr_tpu_torch/csrc/kernels.cu",
            "replaces": "food101_sr_tpu/ops/spatial_mean.py:45",
            "wrapper": "food101_sr_tpu_torch/ops/spatial_mean.py:"
                       + kernel.__name__,
            "at": "1 launch: (8,96,224,224) bfloat16, "
                  + ("channels-last" if key == "nhwc" else "NCHW")
                  + "; at_64: (8,96,64,64)",
            "max_abs_err": abs_err, **big, "at_64": small})
    return records


def _levels(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def _direct(server, img: np.ndarray) -> np.ndarray:
    """Unbatched forward of one whole (edge-padded) image, cropped back."""
    h, w = img.shape[:2]
    ph, pw = (-h) % server.tile, (-w) % server.tile
    xp = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge")
    out = server.forward_u8(torch.from_numpy(xp)[None].cuda())[0]
    return out.cpu().numpy()[: h * server.scale, : w * server.scale]


def _term_sums(model, loss_fn, hr_u8) -> dict[str, float]:
    """Per parameter of ``model``, the largest sum of absolute terms behind
    one entry of its gradient on ``hr_u8`` (the weight-gradient products of
    |input| and |output gradient| of its conv, linear or PReLU layer), by
    forward and output-gradient hooks on the CPU. A float32 sum's rounding
    error is bounded relative to that sum, not to the gradient's own size,
    which cancellation can make hundreds of times smaller (a PReLU slope
    sums g*x over every negative activation of its layer)."""
    from torch import nn

    from food101_sr_tpu_torch.training import loss_and_grads

    seen: dict = {}

    def keep(mod, inp, out, name):
        seen[name] = [inp[0].detach()]
        out.register_hook(lambda g: seen[name].append(g.detach()))

    layers = {n: m for n, m in model.named_modules()
              if isinstance(m, (nn.Conv2d, nn.Linear, nn.PReLU))}
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, n=n: keep(mod, inp, out, n))
        for n, m in layers.items()]
    try:
        loss_and_grads(model, loss_fn, 4, hr_u8)
    finally:
        for h in hooks:
            h.remove()
    sums = {}
    for n, m in layers.items():
        x, g = seen[n]
        ax, ag = x.abs(), g.abs()
        if isinstance(m, nn.Conv2d):
            sums[f"{n}.weight"] = torch.nn.grad.conv2d_weight(
                ax, m.weight.shape, ag, m.stride, m.padding).max().item()
            sums[f"{n}.bias"] = ag.sum((0, 2, 3)).max().item()
        elif isinstance(m, nn.Linear):
            sums[f"{n}.weight"] = (ag.T @ ax).max().item()
        else:  # one shared slope: g * x over the negative inputs
            sums[f"{n}.weight"] = (ag * ax * (x < 0)).sum().item()
    return sums


def _grad_check(model, batch: int = GRAD_BATCH,
                crop: int = TRAIN_CROP) -> dict:
    """One step's raw gradients of ``model`` on ``batch`` seeded crops: on
    the card (K1, K2) and on a CPU copy (their plain versions), TF32 off.
    Per leaf, the largest difference over the leaf's scale: its largest
    sum of absolute terms (``_term_sums``; asserted) and, for the record,
    its max abs."""
    from food101_sr_tpu_torch.losses import nlpd_loss
    from food101_sr_tpu_torch.models import get_model
    from food101_sr_tpu_torch.ops import full_fp32
    from food101_sr_tpu_torch.training import loss_and_grads

    cpu = get_model("AttentionSR", device="cpu")
    cpu.load_state_dict(model.state_dict())
    hr = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (batch, crop, crop, 3), np.uint8))
    with full_fp32():
        _, on_card = loss_and_grads(model, nlpd_loss, 4, hr.cuda())
    _, on_cpu = loss_and_grads(cpu, nlpd_loss, 4, hr)
    sums = _term_sums(cpu, nlpd_loss, hr)
    out = {"term_sum": (0.0, ""), "max_abs": (0.0, ""), "ratio": {}}
    for (name, _), a, b in zip(cpu.named_parameters(), on_card, on_cpu):
        diff, peak = (a.cpu() - b).abs().max().item(), b.abs().max().item()
        if sums[name] < peak * (1 - 1e-5):
            raise AssertionError(f"{name}: term sum {sums[name]} below the "
                                 f"gradient's max abs {peak}")
        out["ratio"][name] = sums[name] / (peak + 1e-30)
        for key, scale in (("term_sum", sums[name]), ("max_abs", peak)):
            err = diff / (scale + 1e-30)
            if err >= out[key][0]:
                out[key] = (err, name)
    return out


def _state_bits(state) -> list[torch.Tensor]:
    """Every tensor the guard must keep: params, optimizer moments and
    step counts, the EMA, the step."""
    return ([p.detach().clone() for p in state.params]
            + [v.clone() for s in state.optimizer.state.values()
               for v in s.values()]
            + [e.clone() for e in state.ema] + [state.step.clone()])


_KERNEL_GROUPS = (("K1 blur (f101_blur5)", ("blur5",)),
                  ("K2 SE mean (f101_nhwc_mean)", ("nhwc_mean",)),
                  ("convolutions (cuDNN)", ("xmma", "conv", "cudnn", "gemm",
                                            "wgrad", "dgrad", "implicit")),
                  ("Adam (fused)", ("adam",)),
                  ("layout and copies", ("copy", "nchwtonhwc", "nhwctonchw",
                                         "transpose", "cat")),
                  ("reductions", ("reduce", "norm")),
                  ("elementwise", ("elementwise", "vectorized", "where")))


def _profile(step, state, hr_u8, steps: int, step_ms: float) -> None:
    """Device time of ``steps`` train steps by kernel group and the top
    kernels, from torch.profiler; the busy share is the device time per
    step over ``step_ms``, the step time measured without the profiler
    (whose own host cost stretches the profiled steps)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = step(state, hr_u8)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print("profile: the profiler recorded no device time", flush=True)
        return
    total = sum(e.time_range.elapsed_us() for e in kernels)
    groups: dict = {}
    by_name: dict = {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        low = e.name.lower()
        group = next((g for g, keys in _KERNEL_GROUPS
                      if any(k in low for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + us
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + us, n + 1)
    print(f"profile: {steps} steps, {len(kernels) / steps:.0f} kernels and "
          f"{total / steps / 1e3:.3f} ms of device time per step, busy share "
          f"{total / steps / 1e3 / step_ms:.3f} of the {step_ms:.3f} ms step",
          flush=True)
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g}: {us / steps / 1e3:.3f} ms/step "
              f"({us / total:.3f})", flush=True)
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  top: {us / steps / 1e3:.3f} ms/step, {n // steps}/step "
              f"{name[:90]}", flush=True)


def _train_kernels(rates) -> tuple[dict, dict]:
    """K1 and K2 at the train step's shapes: against their plain versions
    and timed; K1 also at the pred half alone (what its backward would
    cost without the target half) and the NCHW copy before the pyramid."""
    from food101_sr_tpu_torch.ops.gaussian import (depthwise_blur,
                                                   gaussian_kernel_2d)
    from food101_sr_tpu_torch.ops.pallas_blur import blur, blur_kernel
    from food101_sr_tpu_torch.ops.precision import full_fp32
    from food101_sr_tpu_torch.ops.spatial_mean import (mean_nhwc_kernel,
                                                       spatial_mean_plain)

    gen = torch.Generator(device="cuda").manual_seed(6)
    sides = [TRAIN_CROP >> i for i in range(4)]
    pyr = [torch.rand((2 * TRAIN_BATCH, 3, s, s), device="cuda",
                      generator=gen) for s in sides]
    err = 0.0
    for x in pyr:
        g = torch.rand(x.shape, device="cuda", generator=gen)
        err = max(err, (blur_kernel(x) - depthwise_blur(x)).abs().max().item())
        xa = x.clone().requires_grad_(True)
        (blur(xa) * g).sum().backward()
        xb = x.clone().requires_grad_(True)
        (depthwise_blur(xb) * g).sum().backward()
        err = max(err, (xa.grad - xb.grad).abs().max().item())
    w = torch.from_numpy(gaussian_kernel_2d(5, 1.0)).cuda().expand(3, 1, 5, 5)
    with full_fp32():
        t1 = _timings(lambda: [blur_kernel(x) for x in pyr],
                      lambda: [depthwise_blur(x) for x in pyr],
                      lambda: [F.conv2d(x, w, padding=2, groups=3)
                               for x in pyr], launches=len(pyr))
    half = [x[:TRAIN_BATCH] for x in pyr]
    t1["half_device_ms"] = device_ms(lambda: [blur_kernel(x) for x in half])
    xcl = pyr[0].contiguous(memory_format=torch.channels_last)
    t1["nchw_copy_ms"] = cuda_ms(lambda: xcl.contiguous())
    t1["nchw_copy_device_ms"] = device_ms(lambda: xcl.contiguous())
    t1["bound_ms"], t1["bound_by"] = bound(
        sum(2 * x.numel() * 4 for x in pyr), sum(20 * x.numel() for x in pyr),
        rates)
    if not err <= K1_TOL:
        raise AssertionError(f"K1 disagrees with its plain version at the "
                             f"train shapes: {err}")

    n_se = (TRAIN_BATCH, 96, TRAIN_CROP // 4, TRAIN_CROP // 4)
    x = (torch.rand(n_se, device="cuda", generator=gen) * 2 - 0.5) \
        .contiguous(memory_format=torch.channels_last)
    want = spatial_mean_plain(x)
    rel = ((mean_nhwc_kernel(x) - want).abs()
           / want.abs().clamp_min(1e-6)).max().item()
    if not rel <= K2_RTOL:
        raise AssertionError(f"K2 nhwc disagrees at the train shape: {rel}")
    t2 = _timings(lambda: mean_nhwc_kernel(x), lambda: spatial_mean_plain(x),
                  lambda: x.mean((2, 3)), launches=1)
    t2["bound_ms"], t2["bound_by"] = bound(
        4 * x.numel() + 4 * n_se[0] * n_se[1], x.numel(), rates)
    t2["max_abs_err"] = (mean_nhwc_kernel(x) - want).abs().max().item()
    t2["rel_err"] = rel
    t1["max_abs_err"] = err
    return t1, t2


def phase_train(rates) -> tuple[dict, dict]:
    """The supervised train step on the card (module docstring, phase 8).
    Returns the K1 and K2 records at the step's shapes, launches included."""
    from food101_sr_tpu_torch.losses import get_loss_function
    from food101_sr_tpu_torch.models import get_model
    from food101_sr_tpu_torch.ops import (blur_kernel, mean_nhwc_kernel,
                                          mean_plane_kernel)
    from food101_sr_tpu_torch.training import (FIRST_LAST, SRTrainState,
                                               make_adam, make_eval_step,
                                               make_train_step)

    t0 = time.perf_counter()
    model = get_model("AttentionSR", device="cuda",
                      generator=torch.Generator().manual_seed(0)).train()
    arch = f"AttentionSR x4 {model.num_residuals}x" \
           f"{model.input_conv.out_channels} f32 channels-last"
    worst = _grad_check(model)
    (err, leaf), (err_peak, leaf_peak) = worst["term_sum"], worst["max_abs"]
    if not err <= GRAD_TOL:
        raise AssertionError(f"train gradients, card vs CPU plain: {leaf} "
                             f"off by {err} of its largest term sum")
    print(f"train: {arch} | raw gradients on {GRAD_BATCH}x{TRAIN_CROP}^2, "
          f"card (K1, K2, TF32 off) vs CPU plain: worst leaf {leaf} "
          f"{err:.3g} of its largest sum of absolute terms (tol {GRAD_TOL});"
          f" worst over the max abs: {leaf_peak} {err_peak:.3g} (its term "
          f"sum is {worst['ratio'][leaf_peak]:.0f}x its size; largest ratio "
          f"{max(worst['ratio'].values()):.0f}) | "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    loss_fn = get_loss_function("nlpd")
    first, last = FIRST_LAST["AttentionSR"]
    state = SRTrainState.create(model, make_adam(TRAIN_LR))
    step = make_train_step(model, loss_fn, 4, first, last)
    gen = torch.Generator(device="cuda").manual_seed(5)
    hr_u8 = torch.randint(0, 256, (TRAIN_BATCH, TRAIN_CROP, TRAIN_CROP, 3),
                          dtype=torch.uint8, device="cuda", generator=gen)
    losses = []
    for _ in range(WARMUP_STEPS):
        state, m = step(state, hr_u8)
        losses.append(m["train_loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_STEPS + 1)]
    t_wall = time.perf_counter()
    ev[0].record()
    for i in range(TIMED_STEPS):
        if i == 0:  # ---- main path: one train step, counts from zero ----
            blur_kernel.launches = 0
            mean_nhwc_kernel.launches = mean_plane_kernel.launches = 0
        state, m = step(state, hr_u8)
        if i == 0:
            launches = {"K1": blur_kernel.launches,
                        "K2 nhwc": mean_nhwc_kernel.launches,
                        "K2 nchw": mean_plane_kernel.launches}
            # ---- end of main path ----
        losses.append(m["train_loss"])
        ev[i + 1].record()
    ev[-1].synchronize()
    t_wall = (time.perf_counter() - t_wall) / TIMED_STEPS * 1e3
    peak = torch.cuda.max_memory_allocated()
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(TIMED_STEPS)]
    losses = [float(v) for v in losses]
    mean_ms = float(np.mean(step_ms))
    n_blocks = model.num_residuals
    if launches != {"K1": 8, "K2 nhwc": n_blocks, "K2 nchw": 0}:
        raise AssertionError(f"one train step launched {launches}; expected "
                             f"K1 8 (4 forward, 4 backward), K2 nhwc "
                             f"{n_blocks}, K2 nchw 0")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"train losses {losses}")
    if int(state.skipped) != 0 or int(state.step) != WARMUP_STEPS + TIMED_STEPS:
        raise AssertionError(f"step {int(state.step)}, skipped "
                             f"{int(state.skipped)}")
    print(f"train: batch {TRAIN_BATCH}x{TRAIN_CROP}^2 uint8, NLPD, Adam "
          f"{TRAIN_LR:g} | {WARMUP_STEPS} warm-up + {TIMED_STEPS} timed steps:"
          f" {mean_ms:.3f} ms/step (CUDA events; min {min(step_ms):.3f}, max "
          f"{max(step_ms):.3f}; host clock {t_wall:.3f}), "
          f"{TRAIN_BATCH / mean_ms * 1e3:.1f} images/s | peak memory "
          f"{peak / 2**30:.3f} GiB | one step launched K1 {launches['K1']}, "
          f"K2 nhwc {launches['K2 nhwc']}, K2 nchw {launches['K2 nchw']}",
          flush=True)
    print("train: step ms " + " ".join(f"{t:.3f}" for t in step_ms),
          flush=True)
    print("train: loss " + " ".join(f"{v:.6f}" for v in losses), flush=True)

    # the guard: a NaN loss keeps every tensor of an EMA-keeping state
    ema_state = SRTrainState.create(model, make_adam(TRAIN_LR), ema=True)
    ema_step = make_train_step(model, loss_fn, 4, first, last, ema_decay=0.999)
    nan_step = make_train_step(model, lambda sr, hr: loss_fn(sr, hr) * np.nan,
                               4, first, last, ema_decay=0.999)
    ema_state, _ = ema_step(ema_state, hr_u8)
    before = _state_bits(ema_state)
    ema_state, m = nan_step(ema_state, hr_u8)
    after = _state_bits(ema_state)
    same = len(before) == len(after) and all(
        torch.equal(a, b) for a, b in zip(before, after))
    if not (same and int(ema_state.skipped) == 1
            and float(m["nonfinite_steps"]) == 1.0
            and int(m["nonfinite_total"]) == 1):
        raise AssertionError(f"guard: state kept {same}, skipped "
                             f"{int(ema_state.skipped)}, metrics {m}")
    ev_out = make_eval_step(model, loss_fn, 4)(hr_u8)
    psnr_eval = float(ev_out["psnr"])
    if not (np.isfinite(psnr_eval) and np.isfinite(float(ev_out["val_loss"]))):
        raise AssertionError(f"eval step {ev_out}")
    print(f"train: guard on a NaN loss: {len(before)} tensors (params, Adam "
          f"moments and steps, EMA, step) bit-equal, skipped 0 -> "
          f"{int(ema_state.skipped)} | eval step psnr {psnr_eval:.4f} "
          f"val_loss {float(ev_out['val_loss']):.6f}", flush=True)

    _profile(step, state, hr_u8, PROFILED_STEPS, mean_ms)
    k1, k2 = _train_kernels(rates)
    sides = ",".join(str(TRAIN_CROP >> i) for i in range(4))
    print(f"train K1: pyramid {2 * TRAIN_BATCH}x3x{{{sides}}}^2 f32 "
          f"(pred and target), fwd+bwd max_abs_err {k1['max_abs_err']:.3g}: "
          f"kernel {k1['ms']:.4f} ms, device {k1['device_ms']:.4f}, host "
          f"{k1['host_us']:.1f} us/call, plain {k1['plain_ms']:.4f}, conv2d "
          f"{k1['library_ms']:.4f}, bound {k1['bound_ms']:.4f} "
          f"({k1['bound_by']}) | pred half alone: device "
          f"{k1['half_device_ms']:.4f} | NCHW copy of the channels-last "
          f"{2 * TRAIN_BATCH}x3x{TRAIN_CROP}^2 input: {k1['nchw_copy_ms']:.4f}"
          f" ms, device {k1['nchw_copy_device_ms']:.4f}", flush=True)
    print(f"train K2 nhwc: {TRAIN_BATCH}x96x{TRAIN_CROP // 4}^2 f32 "
          f"channels-last, rel err {k2['rel_err']:.2g}: kernel "
          f"{k2['ms']:.4f} ms, device {k2['device_ms']:.4f}, host "
          f"{k2['host_us']:.1f} us, plain {k2['plain_ms']:.4f}, x.mean "
          f"{k2['library_ms']:.4f}, bound {k2['bound_ms']:.4f} "
          f"({k2['bound_by']}) | train phase {time.perf_counter() - t0:.1f} s",
          flush=True)
    k1.update({"name": "K1 depthwise Gaussian blur 5x5, train step",
               "route": "cuda", "source": "food101_sr_tpu_torch/csrc/kernels.cu",
               "replaces": "food101_sr_tpu/ops/pallas_blur.py:65",
               "wrapper": "food101_sr_tpu_torch/ops/pallas_blur.py:blur_kernel",
               "launches": launches["K1"],
               "at": f"one train step: 4 forward + 4 backward launches; timed "
                     f"per pyramid of 4: ({2 * TRAIN_BATCH},3,{{{sides}}}^2) "
                     "float32; host_us per launch",
               "step_ms": mean_ms, "images_per_s": TRAIN_BATCH / mean_ms * 1e3,
               "peak_bytes": peak})
    k2.update({"name": "K2 spatial mean (SE squeeze), nhwc input, train step",
               "route": "cuda", "source": "food101_sr_tpu_torch/csrc/kernels.cu",
               "replaces": "food101_sr_tpu/ops/spatial_mean.py:45",
               "wrapper": "food101_sr_tpu_torch/ops/spatial_mean.py:"
                          "mean_nhwc_kernel",
               "launches": launches["K2 nhwc"],
               "at": f"one train step: {n_blocks} forward launches; 1 launch: "
                     f"({TRAIN_BATCH},96,{TRAIN_CROP // 4},{TRAIN_CROP // 4}) "
                     "float32 channels-last"})
    return k1, k2


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = phase_env()
    rates = card_rates(torch.cuda.get_device_name(0))
    phase_build()
    k1 = phase_k1(rates)
    k2_nhwc, k2_nchw = phase_k2(rates)

    from food101_sr_tpu_torch.metrics import MetricsCalculator
    from food101_sr_tpu_torch.ops import (blur_kernel, degrade_bicubic,
                                          full_fp32, mean_nhwc_kernel,
                                          mean_plane_kernel)
    from food101_sr_tpu_torch.serving import SRServer

    server = SRServer("AttentionSR", device="cuda", dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(0),
                      adaptive_window=True)
    metrics = MetricsCalculator(device="cuda")
    rng = np.random.default_rng(0)
    try:
        n_blocks = server.model.num_residuals
        win = server.tile + 2 * server.halo
        for side in (server.tile, win):  # first calls pick cuDNN algorithms
            server.forward_u8(torch.zeros((8, side, side, 3), dtype=torch.uint8,
                                          device="cuda"))
        torch.cuda.synchronize()
        small = [rng.integers(0, 256, (64, 64, 3), np.uint8) for _ in range(64)]
        large = rng.integers(0, 256, (256, 256, 3), np.uint8)
        hr = rng.integers(0, 256, (8, 200, 200, 3), np.uint8)

        # ---- main path: counts from zero -------------------------------
        blur_kernel.launches = 0
        mean_nhwc_kernel.launches = mean_plane_kernel.launches = 0
        b0 = server.batcher.n_batches
        with cf.ThreadPoolExecutor(max_workers=16) as pool:
            t0 = time.perf_counter()
            small_out = []
            for i in range(0, len(small), 16):
                small_out += list(pool.map(server.upscale, small[i:i + 16]))
            t_small = time.perf_counter() - t0
            b_small = server.batcher.n_batches - b0
            b1 = server.batcher.n_batches
            large_out = server.upscale(large)
            b_large = server.batcher.n_batches - b1
            hr_t = torch.from_numpy(hr).cuda().permute(0, 3, 1, 2).float() / 255
            lr = degrade_bicubic(hr_t, server.scale)
            lr8 = (lr.clamp(0, 1) * 255 + 0.5).to(torch.uint8)
            lr8 = list(lr8.permute(0, 2, 3, 1).cpu().numpy())
            sr8 = np.stack(list(pool.map(server.upscale, lr8)))
        sr, hrf = sr8.astype(np.float32) / 255, hr.astype(np.float32) / 255
        scores = metrics.compute(sr, hrf)
        torch.cuda.synchronize()
        launches = {"K1": blur_kernel.launches,
                    "K2 nhwc": mean_nhwc_kernel.launches,
                    "K2 nchw": mean_plane_kernel.launches}
        n_batches = server.batcher.n_batches - b0
        # ---- end of main path ------------------------------------------

        if (launches["K2 nhwc"] != n_blocks * n_batches
                or launches["K2 nchw"] != 0):
            raise AssertionError(f"K2 launched {launches} for {n_batches} "
                                 "device batches (all through the NHWC entry "
                                 "expected)")
        if launches["K1"] != 4:
            raise AssertionError(f"K1 launched {launches['K1']} times for "
                                 "one NLPD call")
        if not all(o.shape == (256, 256, 3) and o.dtype == np.uint8
                   for o in small_out):
            raise AssertionError("bad output shape or dtype (64x64 requests)")
        if large_out.shape != (1024, 1024, 3) or sr8.shape != (8, 200, 200, 3):
            raise AssertionError(f"bad output shapes {large_out.shape} "
                                 f"{sr8.shape}")
        # batch bucket: identical device batch shape, so within 1 level
        lv_small = max(_levels(o, _direct(server, i))
                       for i, o in zip(small, small_out))
        lv_score = max(_levels(o, _direct(server, i))
                       for i, o in zip(lr8, sr8))
        if max(lv_small, lv_score) > LEVEL_TOL:
            raise AssertionError(f"served vs direct forward: {lv_small}, "
                                 f"{lv_score} levels")
        # tiled: windows and the whole image are different conv shapes, so
        # bf16 rounds differently; exactness is held in float32, TF32 off
        lv_tiled_bf16 = _levels(large_out, _direct(server, large))
        exact = SRServer("AttentionSR", device="cuda", dtype=torch.float32,
                         generator=torch.Generator().manual_seed(0))
        try:
            with full_fp32():
                whole32 = _direct(exact, large)
                lv_tiled_f32 = _levels(exact.upscale(large), whole32)
        finally:
            exact.close()
        if lv_tiled_f32 > LEVEL_TOL:
            raise AssertionError(f"tiled vs whole image (float32): "
                                 f"{lv_tiled_f32} levels")
        print(f"serve: AttentionSR x{server.scale} {n_blocks}x"
              f"{server.model.input_conv.out_channels} bf16 | window "
              f"{server.batcher.window * 1e3:g} ms, adaptive "
              f"{server.batcher.adaptive} | 64x64: "
              f"{len(small)} req from 16 threads in {b_small} batches, "
              f"{len(small) / t_small:.1f} images/s, max {lv_small} level(s) "
              f"from direct | 256x256 tiled: {b_large} batches of {win}px "
              f"windows, f32 tiled vs whole {lv_tiled_f32} level(s), bf16 "
              f"tiled vs whole {lv_tiled_bf16}, bf16 vs f32 "
              f"{_levels(large_out, whole32)} | K2 nhwc "
              f"{launches['K2 nhwc']} launches = {n_blocks} x {n_batches} "
              f"batches, K2 nchw {launches['K2 nchw']}", flush=True)

        plain = MetricsCalculator(device="cpu").compute(sr, hrf)
        rel = abs(scores["nlpd"] - plain["nlpd"]) / abs(plain["nlpd"])
        rel_lp = abs(scores["lpips"] - plain["lpips"]) / abs(plain["lpips"])
        if not (set(scores) == {"psnr", "ssim", "lpips", "nlpd"}
                and rel <= NLPD_RTOL and rel_lp <= LPIPS_RTOL
                and all(np.isfinite(list(scores.values())))
                and scores["ssim"] <= 1.0):
            raise AssertionError(f"scores {scores} vs plain {plain}")
        print(f"score: 8x200x200 served from 50x50: psnr {scores['psnr']:.4f} "
              f"ssim {scores['ssim']:.5f} lpips {scores['lpips']:.6f} "
              f"(AlexNet pretrained {metrics.pretrained}) nlpd "
              f"{scores['nlpd']:.6f} | plain: nlpd {plain['nlpd']:.6f} (rel "
              f"{rel:.2g}), lpips {plain['lpips']:.6f} (rel {rel_lp:.2g}) | "
              f"K1 {launches['K1']} launches", flush=True)
    finally:
        server.close()
    if server.batcher._thread.is_alive():
        raise AssertionError("batcher thread still alive after close()")
    k1["launches"] = launches["K1"]
    k2_nhwc["launches"] = launches["K2 nhwc"]
    k2_nchw["launches"] = launches["K2 nchw"]
    print(f"close: server stopped | {time.perf_counter() - t_start:.1f} s",
          flush=True)
    k1_train, k2_train = phase_train(rates)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "device_ms", "host_us", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "wrapper", "at", "at_64",
            "half_device_ms", "nchw_copy_ms", "nchw_copy_device_ms",
            "step_ms", "images_per_s", "peak_bytes")
    kernels = [{k: d[k] for k in keys if k in d}
               for d in (k1, k2_nhwc, k2_nchw, k1_train, k2_train)]
    print(f"done: elapsed_s {time.perf_counter() - t_start:.1f} | {smi}",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
