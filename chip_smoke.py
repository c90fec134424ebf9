#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (food101_sr_tpu_torch) once on one NVIDIA
GPU and check it.

    python3 chip_smoke.py

Phases, one short line each; any failure raises and the exit code is 1:

1. env    nvidia-smi's name and power limit, torch and nvcc versions
2. build  nvcc builds the CUDA kernels from csrc/ (no PyTorch headers)
3. K1     the blur kernel against its plain version, forward and backward,
          at the NLPD metric's shapes, with kernel, plain, library times
4. K2     the spatial-mean kernel against its plain version, bf16 and f32,
          at the SE squeeze's serving shapes, with the same times
5. serve  the registry AttentionSR x4 (32 blocks x 96 channels, seeded
          weights, bf16) serves 64x64 requests from 16 threads at a time
          and one 256x256 request (tiled: halo 80, 224 px windows); each
          batched result is held against a direct forward of its input
          alone, and tiling against the whole image in float32
6. score  a seeded HR batch is degraded, served, and scored (PSNR, SSIM,
          NLPD through K1); NLPD is held against the plain blur's
7. close  the server stops; the kernels' JSON line and the elapsed time

Kernel launch counts are zeroed just before the serve phase and read just
after the score phase, so they count the main path only. The last line is
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

K1_SHAPES = [(8, 3, 200, 200), (8, 3, 100, 100), (8, 3, 50, 50),
             (8, 3, 25, 25), (8, 3, 13, 13), (3, 5, 37, 61)]
PYRAMID = K1_SHAPES[:4]  # the blurs of one Laplacian pyramid, 200 px HR
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

    def library():
        with full_fp32():
            for x in xs:
                F.conv2d(x, w, padding=2, groups=3)

    ms = cuda_ms(lambda: [blur_kernel(x) for x in xs])
    plain_ms = cuda_ms(lambda: [depthwise_blur(x) for x in xs])
    library_ms = cuda_ms(library)
    nbytes = sum(2 * x.numel() * 4 for x in xs)
    bound_ms, bound_by = bound(nbytes, sum(20 * x.numel() for x in xs), rates)
    print(f"K1 blur: max_abs_err {err:.3g} (tol {K1_TOL}, fwd+bwd, "
          f"{len(K1_SHAPES)} shapes) | pyramid 8x3x{{200,100,50,25}}^2 f32: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f}, conv2d {library_ms:.4f}, "
          f"bound {bound_ms:.4f} ({bound_by})", flush=True)
    return {"name": "K1 depthwise Gaussian blur 5x5", "route": "cuda",
            "source": "food101_sr_tpu_torch/csrc/kernels.cu",
            "replaces": "food101_sr_tpu/ops/pallas_blur.py:64",
            "wrapper": "food101_sr_tpu_torch/ops/pallas_blur.py:blur_kernel",
            "at": "4 launches: (8,3,200,200),(8,3,100,100),(8,3,50,50),"
                  "(8,3,25,25) float32",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def _ulp_bf16(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each value (8 significant bits)."""
    e = torch.floor(torch.log2(v.abs().clamp_min(2.0**-126)))
    return torch.pow(2.0, e - 7)


def phase_k2(rates) -> dict:
    from food101_sr_tpu_torch.ops.spatial_mean import (mean_kernel,
                                                       spatial_mean_plain)

    gen = torch.Generator(device="cuda").manual_seed(2)
    err, worst_rel, worst_ulp = 0.0, 0.0, 0.0
    for shape in K2_SHAPES:
        base = torch.rand(shape, device="cuda", generator=gen) * 2.0 - 0.5
        for dtype in (torch.float32, torch.bfloat16):
            x = base.to(dtype)
            got, want = mean_kernel(x).float(), spatial_mean_plain(x).float()
            diff = (got - want).abs()
            err = max(err, diff.max().item())
            if dtype == torch.float32:
                worst_rel = max(worst_rel, (diff / want.abs().clamp_min(1e-6))
                                .max().item())
            else:
                worst_ulp = max(worst_ulp, (diff / _ulp_bf16(want)).max().item())
    torch.cuda.synchronize()
    if not (worst_rel <= K2_RTOL and worst_ulp <= 1.0):
        raise AssertionError(f"K2 disagrees with its plain version: rel "
                             f"{worst_rel} (f32), {worst_ulp} ulp (bf16)")

    times = {}
    for shape in K2_SHAPES:
        x = torch.rand(shape, device="cuda", generator=gen).to(torch.bfloat16)
        times[shape] = (cuda_ms(lambda: mean_kernel(x)),
                        cuda_ms(lambda: spatial_mean_plain(x)),
                        cuda_ms(lambda: x.mean((2, 3))))
    shape = K2_SHAPES[1]
    ms, plain_ms, library_ms = times[shape]
    n = int(np.prod(shape))
    bound_ms, bound_by = bound(2 * n + 2 * shape[0] * shape[1], n, rates)
    small = times[K2_SHAPES[0]]
    print(f"K2 spatial mean: max_abs_err {err:.3g} (f32 rel {worst_rel:.2g} "
          f"<= {K2_RTOL}, bf16 {worst_ulp:.2g} ulp <= 1) | bf16 "
          f"8x96x224^2: kernel {ms:.4f} ms, plain {plain_ms:.4f}, "
          f"x.mean {library_ms:.4f}, bound {bound_ms:.4f} ({bound_by}) | "
          f"8x96x64^2: kernel {small[0]:.4f}, plain {small[1]:.4f}, "
          f"x.mean {small[2]:.4f}", flush=True)
    return {"name": "K2 spatial mean (SE squeeze)", "route": "cuda",
            "source": "food101_sr_tpu_torch/csrc/kernels.cu",
            "replaces": "food101_sr_tpu/ops/spatial_mean.py:46",
            "wrapper": "food101_sr_tpu_torch/ops/spatial_mean.py:mean_kernel",
            "at": "1 launch: (8,96,224,224) bfloat16",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


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
    k2 = phase_k2(rates)

    from food101_sr_tpu_torch.metrics import MetricsCalculator
    from food101_sr_tpu_torch.ops import (blur_kernel, degrade_bicubic,
                                          full_fp32, mean_kernel)
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
        blur_kernel.launches = mean_kernel.launches = 0
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
        launches = {"K1": blur_kernel.launches, "K2": mean_kernel.launches}
        n_batches = server.batcher.n_batches - b0
        # ---- end of main path ------------------------------------------

        if launches["K2"] != n_blocks * n_batches:
            raise AssertionError(f"K2 launched {launches['K2']} times for "
                                 f"{n_batches} device batches")
        if launches["K1"] != 8:
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
              f"{_levels(large_out, whole32)} | K2 {launches['K2']} "
              f"launches = {n_blocks} x {n_batches} batches", flush=True)

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
    k1["launches"], k2["launches"] = launches["K1"], launches["K2"]
    kernels = [{k: d[k] for k in ("name", "route", "source", "replaces",
                                  "launches", "max_abs_err", "ms",
                                  "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "wrapper", "at")}
               for d in (k1, k2)]
    print(f"close: server stopped | elapsed_s "
          f"{time.perf_counter() - t_start:.1f} | {smi}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
