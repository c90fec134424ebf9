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
6. score  a seeded HR batch is degraded, served, and scored (PSNR, SSIM,
          NLPD through K1); NLPD is held against the plain blur's
7. close  the server stops; the kernels' JSON line and the elapsed time

Kernel launch counts (one per entry point) are zeroed just before the
serve phase and read just after the score phase, so they count the main
path only: K2 32 per device batch, all through the NHWC entry, and K1 4
for the one NLPD call. The last line is
the JSON device record; the line before it is the kernels' JSON.
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
LEVEL_TOL = 1   # uint8 levels between served and direct forward

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
            "replaces": "food101_sr_tpu/ops/pallas_blur.py:64",
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
            "replaces": "food101_sr_tpu/ops/spatial_mean.py:46",
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
                      generator=torch.Generator().manual_seed(0))
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
              f"{server.model.input_conv.out_channels} bf16 | 64x64: "
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
        if not (rel <= NLPD_RTOL and all(np.isfinite(list(scores.values())))
                and scores["ssim"] <= 1.0):
            raise AssertionError(f"scores {scores} vs plain {plain}")
        print(f"score: 8x200x200 served from 50x50: psnr {scores['psnr']:.4f} "
              f"ssim {scores['ssim']:.5f} nlpd {scores['nlpd']:.6f} | plain "
              f"blur nlpd {plain['nlpd']:.6f} (rel {rel:.2g}) | K1 "
              f"{launches['K1']} launches", flush=True)
    finally:
        server.close()
    if server.batcher._thread.is_alive():
        raise AssertionError("batcher thread still alive after close()")
    k1["launches"] = launches["K1"]
    k2_nhwc["launches"] = launches["K2 nhwc"]
    k2_nchw["launches"] = launches["K2 nchw"]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "device_ms", "host_us", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "wrapper", "at", "at_64")
    kernels = [{k: d[k] for k in keys if k in d}
               for d in (k1, k2_nhwc, k2_nchw)]
    print(f"close: server stopped | elapsed_s "
          f"{time.perf_counter() - t_start:.1f} | {smi}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
