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
8. http   the port's HTTP front end (food101_sr_tpu_torch.serve) on
          127.0.0.1, in this process: a zoo of the registry AttentionSR x4
          (bf16, seeded, warmed, instrumented) and the committed SRCNN
          asset (float32); two rounds of 32 64x64 PNGs (the front end's
          first traffic, then warm) and 8 tiled 200x152 PNGs, each round
          from 8 client threads, every response bit-equal to
          SRServer.upscale of its input (PNG is lossless and the device
          batch has one shape); images/s and the client's p50/p95 per
          round; /statz's attribution per round (decode and encode per
          request; collect, h2d, exec_fetch, exec, d2h per batch); a
          round of 32 64x64 JPEG uploads answered ?format=jpeg, each
          response byte-equal to encode_jpeg_rgb8(SRServer.upscale) at
          quality 90, with its images/s, p50/p95 and encode ms; a JPEG
          request and response; a CMYK upload 415 naming CMYK; /healthz
          "jpeg": true; the SRCNN asset's responses (TF32 off) within 1 level of the
          JAX package's goldens, and its bf16 distance; a --tta server's
          responses within 1 level of the eight dihedral forwards averaged
          by hand; predict.main on 16 64x64 PNGs and a tiled one, every
          output equal to upscale's; a shutdown with 4 requests inside
          their handlers answers each; 404, 413, 400 (truncated) and 415
          (16-bit PNG); then K2 NHWC at the --tta forwards' shape
          (32,96,64,64) bf16 against its plain version, with its times
9. train  the supervised step on the registry AttentionSR x4 (float32,
          channels-last, train mode), NLPD loss, Adam 4e-4, batch 16 of
          seeded 200x200 uint8 crops made on the device: one step's raw
          gradients on 2 crops against the CPU's plain path (TF32 off);
          2 warm-up and 10 timed steps (the loss falls); K1 and K2 at
          the step's shapes against their plain versions, with their
          times; the NCHW copy before the pyramid and the target half of
          K1's backward, timed; the non-finite guard; the eval step; a
          profile of 3 steps; peak memory
10. gan   the relativistic GAN's D and G steps on the same generator,
          batch and lr (G Adam with clip 1, D Adam at lr/10), the
          spectral-norm Discriminator at nf=64 and VGG19 through conv5_4
          (seeded: no weights file on the card host): one D step's and
          one G step's raw gradients on 2 crops against the CPU's plain
          path (TF32 off, each leaf over its max abs: the comment at
          G_GRAD_TOL says why not over its term sums), and D's spectral
          vectors and running stats after each; 2 warm-up and 10 timed
          iterations, a D step on iterations 0 and
          5, CUDA events around each step; a NaN D step and a NaN G step
          leave both states bit-equal, each ticking its own skipped; a
          profile of 3 iterations split by net (G, D, VGG19: convolutions
          and the rest) and K2; K2 at the steps' shape, forward and
          backward, against its plain version; peak memory
11. generators  SRCNN (hidden 64), ResNetSR (16 blocks x 64, BatchNorm)
          and RRDB (23 RRDBs x 64, growth 32) at registry size, seeded,
          channels-last, one after the other: each takes the train phase's
          step from seeded weights (f32, TF32 convs, NLPD, Adam 4e-4, batch
          16 of 200 px uint8 crops made on the device): raw gradients on
          2 crops against the CPU's plain path (GEN_ARCHS' comment says
          how each leaf is scaled), 2 warm-up and 5 timed steps under CUDA
          events, the first timed one launching K1 8 times and K2 0 times,
          a profile of 2 steps for the busy share, peak memory, and a NaN
          loss leaving the parameters, Adam's state and the BatchNorm
          buffers bit-equal with skipped 1; then SRServer("auto") on the
          trained weights serves 16 64x64 requests from 8 threads in bf16
          (each within 1 level of a direct forward) and one image larger
          than tile + 2 * halo, tiled (within 1 level of the whole-image
          forward in float32, TF32 off)
12. loop  training.train() on the card, in a child process of its own
          (``chip_smoke.py --loop DIR``) that alone gets the determinism
          switches (CUBLAS_WORKSPACE_CONFIG, deterministic algorithms, no
          cuDNN autotuning): the registry AttentionSR x4 f32, synthetic
          data (96 images: 86 train, 5 steps of 16 a epoch; a val batch
          of 10; one test batch of 16), crop 200, NLPD, Adam 4e-4, EMA
          0.999, 2 epochs, run and weights directories in a temporary
          directory that is removed afterwards. K1 (forward and backward)
          and K2 NHWC are first held against their plain versions at the
          loop's train, val and test shapes, derived from the loop's
          config. Over the run, K1 launches 8 per step and 4 per val or
          test batch, K2 NHWC 32 per step and per batch, K2 plane none;
          the final metrics are finite; the best checkpoint loads strictly
          into a fresh registry model; a run preempted after 7 updates and
          resumed ends with a full-state checkpoint bit-equal to the
          uninterrupted run's; an epochs-0 run warm-started from the best
          checkpoint gives the same test metrics (1e-6 relative). Prints
          the loop's numbers per epoch (images/s with the loader, the step
          alone, the consumer's wait on the loader, the producer's ms per
          batch) and the device busy share of a profile of 3 steps in the
          preempted run (device time over the trace's span). Then a GAN
          run (one epoch of the same 5 steps, a D step every 2 batches):
          K1 launches 4 per test batch (it validates on the MAE), K2
          NHWC 32 per G step, D step, val and test batch; final metrics
          finite; a run preempted after 3 updates and resumed ends with
          a full-state checkpoint, D's state included, bit-equal to the
          uninterrupted run's. Then the same GAN run around the registry
          RRDB (K1 4 per test batch, K2 none), preempted and resumed alike
13. food101  in the loop phase's process, after it: the port's JPEG codec
          and the Food-101 data path. The committed fixtures
          (food101_sr_tpu_torch/assets/jpeg/, tools/export_port_assets.py)
          decode to the JAX package's digests, the CMYK one is refused
          naming CMYK, two encodes hash to JAX's bytes, random region
          decodes equal full-decode-then-crop, and SRDataLoader's first
          two train and eval batches over the committed mini Food-101
          tree hash to JAX's; then a Food-101-layout tree of 96 + 24
          seeded 512x384 and 384x512 images, encoded by the port at q92,
          is written to a temporary directory and train() runs on it with
          the loop phase's settings (K1 8 per step and 4 per val or test
          batch, K2 NHWC 32 per step and batch: the main path, counts
          from zero around it); the train CLI runs once with no --dataset
          (SRCNN, --subset 0.25). Prints decode ms (full 512x384, 200^2
          crop), encode ms (256^2, 800x608), the loader's batches/s alone
          (8 threads) and train()'s images/s beside the synthetic run's
14. done  the kernels' JSON line and the elapsed time

Kernel launch counts (one per entry point) are zeroed just before each
main path and read just after it: serving (the serve and score phases:
K2 32 per device batch, all through the NHWC entry, and K1 4 for the one
NLPD call), the http phase (K2 NHWC 32 per device batch of the zoo and
of predict's server, 64 per --tta device batch, K1 0: ``http_launches``;
the --tta requests' alone on K2's TTA-shape row), one train step (K1 4
forward and 4 backward, K2 NHWC 32, K2 plane 0), one GAN D step and one G step (K2 NHWC 32 each, K1 0), one
train step of each of the other generators (K1 8, K2 0:
``generator_launches``), the uninterrupted train() runs of the loop
phase, NLPD (``loop_launches``), GAN (``gan_loop_launches``) and RRDB GAN
(``rrdb_gan_loop_launches``), and train() on Food-101 JPEGs
(``food101_loop_launches``). The last line is the JSON device record;
the line before it is the kernels' JSON.
Exits non-zero, printing no result, when no CUDA device is present.
"""
from __future__ import annotations

import concurrent.futures as cf
import contextlib
import io
import itertools
import json
import os
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import warnings
import zlib

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

# the loop phase: train() at the loop's defaults on synthetic data; 96
# images give 86 train images (5 steps of 16 a epoch, 6 dropped), 10 val
# images (one batch of 10) and 24 test images (one batch of 16)
LOOP_CFG = dict(dataset="synthetic", architecture="AttentionSR",
                synthetic_size=96, crop_size=200, batch_size=16,
                loss_function="nlpd", lr=4e-4, ema=0.999, epochs=2, seed=0,
                log_every=1, use_wandb=False)
LOOP_PREEMPT, LOOP_PROFILED = 7, 3
LOOP_RTOL = 1e-6  # the epochs-0 run against the first run's test metrics
LOOP_CUBLAS = ":4096:8"  # CUBLAS_WORKSPACE_CONFIG for deterministic cuBLAS
# the GAN phase: the loop's GAN branch at the train phase's batch and lr,
# the discriminator at full width, the D step every GAN_D_EVERY iterations;
# gradients on GRAD_BATCH crops within G_GRAD_TOL and D_GRAD_TOL of each
# leaf's max abs, not of its term sums as in the train phase: the term sums
# count a layer's own products only, and here the gradients reach a layer
# as differences of terms far larger than themselves, which they do not
# count: G's through VGG19's 16 convs and the SE rescale's spatial sums,
# D's through three train-mode BatchNorms, whose backward subtracts the
# batch means of the gradient and of its product with x_hat; and the D
# step's fake comes from two G forwards that differ in float32. Runs on
# an H100 80GB HBM3 measured 1.3e-3 (G) and 5.6e-3 (D) of a leaf's max
# abs, 2.7e-4 and 1.4e-4 of its term sum (PERF.md). The discriminator's buffers (u, v, running
# stats) after each step within BUF_TOL of each buffer's max abs (measured
# 6.7e-7)
GAN_NF, GAN_D_EVERY = 64, 5
GAN_WARMUP, GAN_TIMED, GAN_PROFILED = 2, 10, 3
G_GRAD_TOL, D_GRAD_TOL, BUF_TOL = 1e-2, 2e-2, 1e-5
# the loop phase's GAN run: one epoch of the loop's 5 steps, a D step every
# 2 batches, preempted after 3 updates and resumed
GAN_LOOP_CFG = {**LOOP_CFG, "loss_function": "gan", "epochs": 1,
                "d_update_every": 2}
GAN_LOOP_PREEMPT = 3
# the generators phase: the other three registry nets, each served (bf16,
# GEN_REQUESTS 64x64 requests and one tiled image) and trained as the
# train phase trains AttentionSR (GEN_WARMUP + GEN_TIMED steps, a profile
# of GEN_PROFILED); gradients on GRAD_BATCH crops held per leaf within
# GRAD_TOL of its term sum or G_GRAD_TOL of its max abs, whichever is
# looser for the leaf: a conv bias ahead of a train-mode BatchNorm has an
# exact-zero gradient, rounding noise on both sides, which only the term
# sum scales; a deep net's early leaves get gradients that passed through
# many layers, which only the max abs scales (the GAN phase's finding)
GEN_ARCHS = ("SRCNN", "RESNET", "RRDB")
GEN_REQUESTS = 16
GEN_WARMUP, GEN_TIMED, GEN_PROFILED = 2, 5, 2
# the loop phase's RRDB GAN run: GAN_LOOP_CFG around the registry RRDB
RRDB_GAN_LOOP_CFG = {**GAN_LOOP_CFG, "architecture": "RRDB"}
# the http phase: two rounds of HTTP_REQUESTS 64x64 PNGs and one of
# HTTP_TILED PNGs of HTTP_TILED_SHAPE (the tiled path), each from
# HTTP_THREADS client threads,
# TTA_REQUESTS 64x64 PNGs to a --tta server, predict.main on
# PREDICT_IMAGES 64x64 PNGs and one tiled image, DRAIN_REQUESTS tiled
# requests in flight at shutdown; the committed SRCNN asset and the JAX
# package's float32 goldens for it (tools/export_port_assets.py)
HTTP_REQUESTS, HTTP_TILED, HTTP_THREADS = 32, 8, 8
HTTP_TILED_SHAPE = (200, 152)
TTA_REQUESTS, TTA_CHECKED, PREDICT_IMAGES, DRAIN_REQUESTS = 16, 2, 16, 4
ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "food101_sr_tpu_torch", "assets")

# the food101 phase: the committed JPEG fixtures and the JAX package's
# goldens for them (tools/export_port_assets.py writes both), and train()
# on a Food-101-layout tree made on the card: FOOD_TRAIN train and
# FOOD_TEST test images at FOOD_SHAPES (Food-101's usual 512 px sides),
# encoded by the port at FOOD_QUALITY, with the loop phase's settings
JPEG_ASSETS = os.path.join(ASSETS, "jpeg")
FOOD_TRAIN, FOOD_TEST, FOOD_QUALITY = 96, 24, 92
FOOD_SHAPES = ((384, 512), (512, 384))
FOOD_CROPS = 40  # random crops held against full-decode-then-crop
FOOD_CLI_SUBSET = 0.25
LOADER_THREADS = 8
JPEG_ROUND = 32  # 64x64 JPEG uploads answered as JPEG, HTTP_THREADS at once


def jpeg_test_image(h: int, w: int, seed: int, noise: int = 24) -> np.ndarray:
    """A seeded uint8 (h, w, 3) image with edges, gradients and +-noise
    levels of noise, made with integer arithmetic only, so that every host
    makes the same bytes (the encode goldens are digests of its JPEGs)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    ramp = (3 * xx[..., None] + 2 * yy[..., None]
            + np.array([0, 85, 170])) % 256
    blocks = ((xx // 37 + yy // 29) % 3)[..., None] * 40
    noise = rng.integers(-noise, noise + 1, (h, w, 3))
    return np.clip(ramp // 2 + blocks + noise + 20, 0, 255).astype(np.uint8)


def sha256(a) -> str:
    """Digest of an array's C-order bytes (or of bytes)."""
    import hashlib

    if isinstance(a, np.ndarray):
        a = np.ascontiguousarray(a).tobytes()
    return hashlib.sha256(a).hexdigest()


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


def _k1_err(xs, gen) -> float:
    """K1 against its plain version on each input: the forward, and the
    backward of a seeded cotangent; the largest absolute difference."""
    from food101_sr_tpu_torch.ops.gaussian import depthwise_blur
    from food101_sr_tpu_torch.ops.pallas_blur import blur, blur_kernel

    err = 0.0
    for x in xs:
        g = torch.rand(x.shape, device="cuda", generator=gen)
        err = max(err, (blur_kernel(x) - depthwise_blur(x)).abs().max().item())
        xa = x.clone().requires_grad_(True)
        (blur(xa) * g).sum().backward()
        xb = x.clone().requires_grad_(True)
        (depthwise_blur(xb) * g).sum().backward()
        err = max(err, (xa.grad - xb.grad).abs().max().item())
    return err


def _k2_nhwc_err(shape, gen) -> tuple[float, float, torch.Tensor]:
    """The NHWC K2 entry against the plain mean on a seeded float32
    channels-last input: (largest relative error, largest absolute
    error, the input)."""
    from food101_sr_tpu_torch.ops.spatial_mean import (mean_nhwc_kernel,
                                                       spatial_mean_plain)

    x = (torch.rand(shape, device="cuda", generator=gen) * 2 - 0.5) \
        .contiguous(memory_format=torch.channels_last)
    want, got = spatial_mean_plain(x), mean_nhwc_kernel(x)
    rel = ((got - want).abs() / want.abs().clamp_min(1e-6)).max().item()
    return rel, (got - want).abs().max().item(), x


def _k1_timings(pyr, rates) -> dict:
    """Times of K1 over one NLPD pyramid (one launch per level) against
    its plain version and F.conv2d, with the pyramid's bound."""
    from food101_sr_tpu_torch.ops.gaussian import (depthwise_blur,
                                                   gaussian_kernel_2d)
    from food101_sr_tpu_torch.ops.pallas_blur import blur_kernel
    from food101_sr_tpu_torch.ops.precision import full_fp32

    w = torch.from_numpy(gaussian_kernel_2d(5, 1.0)).cuda().expand(3, 1, 5, 5)
    # TF32 off for the yardstick conv, entered once around all the timing
    # so that no timed call pays for the switch
    with full_fp32():
        t = _timings(lambda: [blur_kernel(x) for x in pyr],
                     lambda: [depthwise_blur(x) for x in pyr],
                     lambda: [F.conv2d(x, w, padding=2, groups=3)
                              for x in pyr], launches=len(pyr))
    t["bound_ms"], t["bound_by"] = bound(
        sum(2 * x.numel() * 4 for x in pyr), sum(20 * x.numel() for x in pyr),
        rates)
    return t


def _k2_nhwc_timings(x, rates) -> dict:
    """Times of the NHWC K2 entry on a float32 channels-last input against
    the plain mean and x.mean, with the bound."""
    from food101_sr_tpu_torch.ops.spatial_mean import (mean_nhwc_kernel,
                                                       spatial_mean_plain)

    t = _timings(lambda: mean_nhwc_kernel(x), lambda: spatial_mean_plain(x),
                 lambda: x.mean((2, 3)), launches=1)
    t["bound_ms"], t["bound_by"] = bound(
        4 * x.numel() + 4 * x.shape[0] * x.shape[1], x.numel(), rates)
    return t


def phase_k1(rates) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1)
    err = _k1_err([torch.rand(s, device="cuda", generator=gen)
                   for s in K1_SHAPES], gen)
    if not err <= K1_TOL:
        raise AssertionError(f"K1 disagrees with its plain version: {err}")

    t = _k1_timings([torch.rand(s, device="cuda", generator=gen)
                     for s in PYRAMID], rates)
    print(f"K1 blur: max_abs_err {err:.3g} (tol {K1_TOL}, fwd+bwd, "
          f"{len(K1_SHAPES)} shapes) | pyramid 16x3x{{200,100,50,25}}^2 f32: "
          f"kernel {t['ms']:.4f} ms, device {t['device_ms']:.4f}, "
          f"host {t['host_us']:.1f} us/call, "
          f"plain {t['plain_ms']:.4f}, conv2d {t['library_ms']:.4f}, "
          f"bound {t['bound_ms']:.4f} ({t['bound_by']})", flush=True)
    return {"name": "K1 depthwise Gaussian blur 5x5", "route": "cuda",
            "source": "food101_sr_tpu_torch/csrc/kernels.cu",
            "replaces": "food101_sr_tpu/ops/pallas_blur.py:65",
            "wrapper": "food101_sr_tpu_torch/ops/pallas_blur.py:blur_kernel",
            "at": "4 launches: (16,3,200,200),(16,3,100,100),(16,3,50,50),"
                  "(16,3,25,25) float32; host_us per launch",
            "max_abs_err": err, **t}


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


@contextlib.contextmanager
def _term_sums(model, sums: dict):
    """Within the block, record each conv, linear, PReLU, spectral-norm or
    BatchNorm layer of ``model``'s inputs and output gradients (every call,
    by forward and output-gradient hooks, on the CPU); on exit fill
    ``sums``, per parameter, with the largest sum of absolute terms behind
    one entry of its gradient: the weight-gradient products of |input| and
    |output gradient| (over every call of the layer), the shared PReLU
    slope's g*x over the negative inputs, a BatchNorm scale's g*x_hat. A
    spectral-norm kernel W enters its layer as W/sigma, so its terms are
    those products over sigma plus their sum weighted by |W| over sigma
    squared (sigma's gradient; the power iteration's own derivative is
    left out). A float32 sum's rounding error is bounded relative to that
    sum, not to the gradient's own size, which cancellation can make
    hundreds of times smaller (a PReLU slope sums g*x over every negative
    activation of its layer)."""
    from torch import nn

    from food101_sr_tpu_torch.models import SNConv2d, SNLinear

    seen: dict = {}

    def keep(mod, inp, out, name):
        pair = [inp[0].detach()]
        seen.setdefault(name, []).append(pair)
        if out.requires_grad:
            out.register_hook(lambda g: pair.append(g.detach()))

    kinds = (nn.Conv2d, nn.Linear, nn.PReLU, SNConv2d, SNLinear,
             nn.BatchNorm2d)
    layers = {n: m for n, m in model.named_modules() if isinstance(m, kinds)}
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, n=n: keep(mod, inp, out, n))
        for n, m in layers.items()]
    try:
        yield sums
    finally:
        for h in hooks:
            h.remove()
    for n, m in layers.items():
        pairs = [(x.abs(), g.abs(), x) for x, g in
                 (p for p in seen.get(n, []) if len(p) == 2)]
        if not pairs:
            continue
        if isinstance(m, (nn.Conv2d, SNConv2d)):
            w = m.weight_orig if isinstance(m, SNConv2d) else m.weight
            t = sum(torch.nn.grad.conv2d_weight(ax, w.shape, ag, m.stride,
                                                m.padding)
                    for ax, ag, _ in pairs)
            bias = sum(ag.sum((0, 2, 3)) for _, ag, _ in pairs)
        elif isinstance(m, (nn.Linear, SNLinear)):
            w = m.weight_orig if isinstance(m, SNLinear) else m.weight
            t = sum(ag.T @ ax for ax, ag, _ in pairs)
            bias = sum(ag.sum(0) for _, ag, _ in pairs)
        elif isinstance(m, nn.BatchNorm2d):
            def x_hat(x):
                mean = x.mean((0, 2, 3), keepdim=True)
                var = x.var((0, 2, 3), unbiased=False, keepdim=True)
                return ((x - mean) / torch.sqrt(var + m.eps)).abs()
            sums[f"{n}.weight"] = sum((ag * x_hat(x)).sum((0, 2, 3))
                                      for _, ag, x in pairs).max().item()
            sums[f"{n}.bias"] = sum(ag.sum((0, 2, 3))
                                    for _, ag, _ in pairs).max().item()
            continue
        else:  # one shared slope: g * x over the negative inputs
            sums[f"{n}.weight"] = sum((ag * ax * (x < 0)).sum().item()
                                      for ax, ag, x in pairs)
            continue
        if isinstance(m, (SNConv2d, SNLinear)):
            with torch.no_grad():
                wm = w.flatten(1)
                sigma = torch.dot(m.weight_v, wm.t() @ m.weight_u).abs()
                t = t / sigma
                t = t.max() + (t * w.abs()).sum() / sigma
            sums[f"{n}.weight_orig"] = t.item()
        else:
            sums[f"{n}.weight"] = t.max().item()
        if m.bias is not None:
            sums[f"{n}.bias"] = bias.max().item()


def _worst(names, on_card, on_cpu, sums) -> dict:
    """Per leaf, the largest card-CPU difference over the leaf's largest
    sum of absolute terms (asserted to be at least its max abs) and, for
    the record, over its max abs: the worst of each, the worst leaf by the
    lesser of the two over their phases' tolerances (``either``), and the
    ratios."""
    out = {"term_sum": (0.0, ""), "max_abs": (0.0, ""), "either": (0.0, ""),
           "ratio": {}}
    for name, a, b in zip(names, on_card, on_cpu, strict=True):
        diff, peak = (a.cpu() - b).abs().max().item(), b.abs().max().item()
        if sums[name] < peak * (1 - 1e-5):
            raise AssertionError(f"{name}: term sum {sums[name]} below the "
                                 f"gradient's max abs {peak}")
        out["ratio"][name] = sums[name] / (peak + 1e-30)
        # a leaf that is exactly 0 (D's last bias: the relativistic loss's
        # real and fake terms cancel) is scaled by its term sum
        for key, scale in (("term_sum", sums[name]),
                           ("max_abs", peak or sums[name])):
            err = diff / (scale + 1e-30)
            if err >= out[key][0]:
                out[key] = (err, name)
        # the generators phase: within the train phase's tolerance of the
        # term sum or the GAN phase's of the max abs (1 = at the limit)
        either = min(diff / (sums[name] + 1e-30) / GRAD_TOL,
                     diff / ((peak or sums[name]) + 1e-30) / G_GRAD_TOL)
        if either >= out["either"][0]:
            out["either"] = (either, name)
    return out


def _grad_check(model, batch: int = GRAD_BATCH, crop: int = TRAIN_CROP,
                arch: str = "AttentionSR") -> dict:
    """One step's raw gradients of ``model`` (registry ``arch``) on
    ``batch`` seeded crops: on the card (K1, K2) and on a CPU copy (their
    plain versions), TF32 off.
    Per leaf, the largest difference over the leaf's scale: its largest
    sum of absolute terms (``_term_sums``; asserted) and, for the record,
    its max abs."""
    from food101_sr_tpu_torch.losses import nlpd_loss
    from food101_sr_tpu_torch.models import get_model
    from food101_sr_tpu_torch.ops import full_fp32
    from food101_sr_tpu_torch.training import loss_and_grads

    cpu = get_model(arch, device="cpu")
    cpu.load_state_dict(model.state_dict())
    hr = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (batch, crop, crop, 3), np.uint8))
    with full_fp32():
        _, on_card = loss_and_grads(model, nlpd_loss, 4, hr.cuda())
    with _term_sums(cpu, {}) as sums:
        _, on_cpu = loss_and_grads(cpu, nlpd_loss, 4, hr)
    return _worst([k for k, _ in cpu.named_parameters()], on_card, on_cpu,
                  sums)


def _bits(state) -> list[torch.Tensor]:
    """Every tensor of a train state: the model's params and buffers, the
    optimizer's moments and step counts, the EMA, step and skipped."""
    return ([t.detach().clone() for t in state.model.state_dict().values()]
            + [v.clone() for s in state.optimizer.state.values()
               for v in s.values()]
            + [e.clone() for e in (state.ema or [])]
            + [state.step.clone(), state.skipped.clone()])


def _bit_equal(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


_KERNEL_GROUPS = (("K1 blur (f101_blur5)", ("blur5",)),
                  ("K2 SE mean (f101_nhwc_mean)", ("nhwc_mean",)),
                  ("convolutions (cuDNN)", ("xmma", "conv", "cudnn", "gemm",
                                            "wgrad", "dgrad", "implicit")),
                  ("Adam (fused)", ("adam",)),
                  ("layout and copies", ("copy", "nchwtonhwc", "nhwctonchw",
                                         "transpose", "cat")),
                  ("reductions", ("reduce", "norm")),
                  ("elementwise", ("elementwise", "vectorized", "where")))


def _profile(step, state, hr_u8, steps: int, step_ms: float,
             verbose: bool = True, label: str = "profile"
             ) -> tuple[float, float]:
    """Device time of ``steps`` train steps by kernel group and the top
    kernels, from torch.profiler; the busy share is the device time per
    step over ``step_ms``, the step time measured without the profiler
    (whose own host cost stretches the profiled steps). Returns kernels
    and device ms per step (0, 0 when the profiler saw no device time);
    prints the groups and top kernels when ``verbose``, on lines that
    start with ``label``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = step(state, hr_u8)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print(f"{label}: the profiler recorded no device time", flush=True)
        return 0.0, 0.0
    total = sum(e.time_range.elapsed_us() for e in kernels)
    if not verbose:
        return len(kernels) / steps, total / steps / 1e3
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
    print(f"{label}: {steps} steps, {len(kernels) / steps:.0f} kernels and "
          f"{total / steps / 1e3:.3f} ms of device time per step, busy share "
          f"{total / steps / 1e3 / step_ms:.3f} of the {step_ms:.3f} ms step",
          flush=True)
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g}: {us / steps / 1e3:.3f} ms/step "
              f"({us / total:.3f})", flush=True)
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  top: {us / steps / 1e3:.3f} ms/step, {n // steps}/step "
              f"{name[:90]}", flush=True)
    return len(kernels) / steps, total / steps / 1e3


def _train_kernels(rates) -> tuple[dict, dict]:
    """K1 and K2 at the train step's shapes: against their plain versions
    and timed; K1 also at the pred half alone (what its backward would
    cost without the target half) and the NCHW copy before the pyramid."""
    from food101_sr_tpu_torch.ops.pallas_blur import blur_kernel

    gen = torch.Generator(device="cuda").manual_seed(6)
    sides = [TRAIN_CROP >> i for i in range(4)]
    pyr = [torch.rand((2 * TRAIN_BATCH, 3, s, s), device="cuda",
                      generator=gen) for s in sides]
    err = _k1_err(pyr, gen)
    if not err <= K1_TOL:
        raise AssertionError(f"K1 disagrees with its plain version at the "
                             f"train shapes: {err}")
    t1 = _k1_timings(pyr, rates)
    half = [x[:TRAIN_BATCH] for x in pyr]
    t1["half_device_ms"] = device_ms(lambda: [blur_kernel(x) for x in half])
    xcl = pyr[0].contiguous(memory_format=torch.channels_last)
    t1["nchw_copy_ms"] = cuda_ms(lambda: xcl.contiguous())
    t1["nchw_copy_device_ms"] = device_ms(lambda: xcl.contiguous())

    n_se = (TRAIN_BATCH, 96, TRAIN_CROP // 4, TRAIN_CROP // 4)
    rel, abs_err, x = _k2_nhwc_err(n_se, gen)
    if not rel <= K2_RTOL:
        raise AssertionError(f"K2 nhwc disagrees at the train shape: {rel}")
    t2 = _k2_nhwc_timings(x, rates)
    t2["max_abs_err"] = abs_err
    t2["rel_err"] = rel
    t1["max_abs_err"] = err
    return t1, t2


def phase_train(rates) -> tuple[dict, dict]:
    """The supervised train step on the card (module docstring, phase 9).
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
    before = _bits(ema_state)
    ema_state, m = nan_step(ema_state, hr_u8)
    after = _bits(ema_state)
    same = _bit_equal(before[:-1], after[:-1])  # all but skipped
    if not (same and int(ema_state.skipped) == 1
            and float(m["nonfinite_steps"]) == 1.0
            and int(m["nonfinite_total"]) == 1):
        raise AssertionError(f"guard: state kept {same}, skipped "
                             f"{int(ema_state.skipped)}, metrics {m}")
    ev_out = make_eval_step(model, loss_fn, 4)(hr_u8)
    psnr_eval = float(ev_out["psnr"])
    if not (np.isfinite(psnr_eval) and np.isfinite(float(ev_out["val_loss"]))):
        raise AssertionError(f"eval step {ev_out}")
    print(f"train: guard on a NaN loss: {len(before) - 1} tensors (params, Adam "
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


def _labelled(modules: dict):
    """Forward hooks that run each module's forward inside a
    ``torch.profiler.record_function`` of its label; returns the handles."""
    from torch.profiler import record_function

    handles = []
    for label, mod in modules.items():
        def pre(m, inp, label=label):
            m._smoke_range = record_function(label)
            m._smoke_range.__enter__()

        def post(m, inp, out):
            m._smoke_range.__exit__(None, None, None)

        handles += [mod.register_forward_pre_hook(pre),
                    mod.register_forward_hook(post)]
    return handles


def _device_split(prof, labels) -> dict[str, float]:
    """Device microseconds of a profile by group: K2 (by kernel name), then
    each label's convolutions and the rest of it, and the rest. A kernel
    belongs to a label when the op that launched it (the profiler lists
    each op's kernels) runs inside the label's forward, or is a backward
    op whose forward did: backward ops find their forward through the
    autograd sequence number and the forward thread. Kernels the profiler
    ties to no op go to the rest. The labels' own spans on the device
    timeline (the profiler mirrors each labelled range there) are not
    kernels and are left out."""
    from torch.autograd import DeviceType

    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]

    def label_of(e):
        while e is not None:
            if e.name in labels:
                return e.name
            e = e.cpu_parent
        return None

    fwd = {(e.thread, e.sequence_nr): label_of(e) for e in cpu
           if e.sequence_nr >= 0 and label_of(e)}

    def group_of(op):
        label, e = label_of(op), op
        while label is None and e is not None:
            if e.sequence_nr >= 0 and e.fwd_thread:
                label = fwd.get((e.fwd_thread, e.sequence_nr))
            e = e.cpu_parent
        return label

    conv_keys = dict(_KERNEL_GROUPS)["convolutions (cuDNN)"]
    split: dict = {"rest": 0.0}
    for op in (e for e in cpu if e.kernels):
        label = group_of(op)
        for k in op.kernels:
            low = k.name.lower()
            if k.name in labels:
                continue
            if "nhwc_mean" in low:
                g = "K2 SE mean"
            elif label:
                conv = any(key in low for key in conv_keys)
                g = f"{label} {'convs' if conv else 'other'}"
            else:
                g = "rest"
            split[g] = split.get(g, 0.0) + k.duration
    total = sum(e.time_range.elapsed_us() for e in events
                if e.device_type == DeviceType.CUDA and e.name not in labels)
    split["rest"] += max(total - sum(split.values()), 0.0)
    return split


def _gan_grad_check(g, d, percep) -> dict:
    """One D step's and one G step's raw gradients and D's buffers after
    each, on GRAD_BATCH seeded crops with seeded noise tensors: on the card
    (K2, TF32 off) and on CPU copies (its plain version). Fused SGD at lr 0
    leaves each step's raw gradients in .grad and the parameters as they
    were. Returns the worst leaves (``_worst``) per step and the largest
    buffer difference over the buffer's max abs."""
    from food101_sr_tpu_torch.losses import PerceptualLoss
    from food101_sr_tpu_torch.models import (Discriminator, build_model,
                                             get_model)
    from food101_sr_tpu_torch.ops import full_fp32
    from food101_sr_tpu_torch.training import (FIRST_LAST, SRTrainState,
                                               Transform, make_gan_d_step,
                                               make_gan_g_step)

    sgd0 = Transform(lambda params, lr: torch.optim.SGD(params, lr=lr,
                                                        fused=True), 0.0)
    g_cpu = get_model("AttentionSR", device="cpu")
    g_cpu.load_state_dict(g.state_dict())
    d_cpu = build_model(lambda: Discriminator(nf=GAN_NF), device="cpu")
    d_cpu.load_state_dict(d.state_dict())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        p_cpu = PerceptualLoss(device="cpu")
    for (k, a), b in zip(percep.net.state_dict().items(),
                         p_cpu.net.state_dict().values()):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"VGG19 {k}: the card's and the CPU's "
                                 "seeded weights differ")
    rng = np.random.default_rng(4)
    hr = torch.from_numpy(rng.integers(0, 256, (GRAD_BATCH, TRAIN_CROP,
                                                TRAIN_CROP, 3), np.uint8))
    noise = [torch.from_numpy(rng.standard_normal(
        (GRAD_BATCH, 3, TRAIN_CROP, TRAIN_CROP), np.float32))
        for _ in range(2)]
    first, last = FIRST_LAST["AttentionSR"]
    runs = {}
    card = next(g.parameters()).device
    for dev, gm, dm, pl in ((card, g, d, percep),
                            ("cpu", g_cpu, d_cpu, p_cpu)):
        gs, ds = SRTrainState(gm, sgd0), SRTrainState(dm, sgd0)
        d_step = make_gan_d_step(gm, dm, 4)
        g_step = make_gan_g_step(gm, dm, pl, 4, first, last)
        sums_d, sums_g = {}, {}
        with full_fp32():
            with (_term_sums(dm, sums_d) if dev == "cpu"
                  else contextlib.nullcontext()):
                d_step(gs, ds, hr.to(dev), [n.to(dev) for n in noise])
            d_grads = [p.grad.clone() for p in ds.params]
            d_bufs = [b.clone() for b in dm.buffers()]
            with (_term_sums(gm, sums_g) if dev == "cpu"
                  else contextlib.nullcontext()):
                g_step(gs, ds, hr.to(dev))
            g_grads = [p.grad.clone() for p in gs.params]
            g_bufs = [b.clone() for b in dm.buffers()]
        runs[dev] = (d_grads, d_bufs, g_grads, g_bufs, sums_d, sums_g,
                     ds.names, gs.names)
    d_card, db_card, g_card, gb_card = runs[card][:4]
    d_cpu_g, db_cpu, g_cpu_g, gb_cpu, sums_d, sums_g, d_names, g_names = \
        runs["cpu"]
    buf = 0.0
    for a, b in zip(db_card + gb_card, db_cpu + gb_cpu):
        if a.is_floating_point():
            buf = max(buf, (a.cpu() - b).abs().max().item()
                      / (b.abs().max().item() + 1e-30))
        elif not torch.equal(a.cpu(), b):
            raise AssertionError("a BatchNorm step count differs")
    return {"D": _worst(d_names, d_card, d_cpu_g, sums_d),
            "G": _worst(g_names, g_card, g_cpu_g, sums_g), "buffers": buf}


def phase_gan(rates) -> dict:
    """The GAN branch on the card (module docstring, phase 10). Returns the
    K2 record at the GAN steps' shape, launches per step included."""
    from food101_sr_tpu_torch.losses import get_loss_function
    from food101_sr_tpu_torch.models import (Discriminator, build_model,
                                             get_model)
    from food101_sr_tpu_torch.ops import (blur_kernel, mean_nhwc_kernel,
                                          mean_plane_kernel)
    from food101_sr_tpu_torch.training import (FIRST_LAST, SRTrainState,
                                               make_adam, make_gan_d_step,
                                               make_gan_g_step)

    t0 = time.perf_counter()
    g = get_model("AttentionSR", device="cuda",
                  generator=torch.Generator().manual_seed(0)).train()
    d = build_model(lambda: Discriminator(nf=GAN_NF), device="cuda",
                    generator=torch.Generator().manual_seed(2))
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        percep = get_loss_function("perceptual", device="cuda")
    n_blocks = g.num_residuals
    worst = _gan_grad_check(g, d, percep)
    (g_err, g_leaf), (d_err, d_leaf) = (worst["G"]["max_abs"],
                                        worst["D"]["max_abs"])
    print(f"gan: G AttentionSR x4 {n_blocks}x{g.input_conv.out_channels} "
          f"f32 channels-last, D nf={GAN_NF} (spectral norm, "
          f"{sum(p.numel() for p in d.parameters())} params), VGG19 "
          f"through conv5_4 (pretrained {percep.pretrained}) | raw gradients "
          f"on {GRAD_BATCH}x{TRAIN_CROP}^2, card (K2, TF32 off) vs CPU "
          f"plain: G step worst {g_leaf} {g_err:.3g} of its max abs (tol "
          f"{G_GRAD_TOL}; over the term sum {worst['G']['term_sum'][0]:.3g}"
          f" at {worst['G']['term_sum'][1]}), D step worst {d_leaf} "
          f"{d_err:.3g} of its max abs (tol {D_GRAD_TOL}; over the term sum "
          f"{worst['D']['term_sum'][0]:.3g} at {worst['D']['term_sum'][1]})"
          f" | D buffers after both steps "
          f"{worst['buffers']:.3g} of their max abs (tol {BUF_TOL}) | "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not (g_err <= G_GRAD_TOL and d_err <= D_GRAD_TOL
            and worst["buffers"] <= BUF_TOL):
        raise AssertionError(f"GAN: card vs CPU off (G {g_err}, D {d_err}, "
                             f"buffers {worst['buffers']})")

    first, last = FIRST_LAST["AttentionSR"]
    gs = SRTrainState.create(g, make_adam(TRAIN_LR, clip_norm=1.0))
    ds = SRTrainState.create(d, make_adam(TRAIN_LR * 0.1))
    d_step = make_gan_d_step(g, d, 4)
    g_step = make_gan_g_step(g, d, percep, 4, first, last)
    gen = torch.Generator(device="cuda").manual_seed(5)
    hr_u8 = torch.randint(0, 256, (TRAIN_BATCH, TRAIN_CROP, TRAIN_CROP, 3),
                          dtype=torch.uint8, device="cuda", generator=gen)
    noise = torch.Generator(device="cuda").manual_seed(3)

    def iteration(i, timing=None, count=None):
        nonlocal gs, ds
        for kind in ("D", "G"):
            if kind == "D" and i % GAN_D_EVERY:
                continue
            if count is not None:
                blur_kernel.launches = 0
                mean_nhwc_kernel.launches = mean_plane_kernel.launches = 0
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            if kind == "D":
                ds, m = d_step(gs, ds, hr_u8, noise)
            else:
                gs, ds, m = g_step(gs, ds, hr_u8)
            ev[1].record()
            if count is not None:
                count[kind] = (blur_kernel.launches,
                               mean_nhwc_kernel.launches,
                               mean_plane_kernel.launches)
            if timing is not None:
                timing[kind].append(ev)
                timing[kind + " loss"].append(
                    m["train_loss_D" if kind == "D" else "train_loss"])

    for i in range(GAN_WARMUP):
        iteration(i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timing = {"D": [], "G": [], "D loss": [], "G loss": []}
    launches: dict = {}
    t_wall = time.perf_counter()
    for i in range(GAN_TIMED):
        # ---- main path: iteration 0 (a D step and a G step), counts from
        # zero before each step and read after it ----
        iteration(i, timing, launches if i == 0 else None)
    torch.cuda.synchronize()
    t_wall = (time.perf_counter() - t_wall) / GAN_TIMED * 1e3
    peak = torch.cuda.max_memory_allocated()
    d_ms = [a.elapsed_time(b) for a, b in timing["D"]]
    g_ms = [a.elapsed_time(b) for a, b in timing["G"]]
    iter_ms = (sum(d_ms) + sum(g_ms)) / GAN_TIMED
    losses = {k: [float(v) for v in timing[k + " loss"]] for k in "DG"}
    want = {"D": (0, n_blocks, 0), "G": (0, n_blocks, 0)}
    if launches != want:
        raise AssertionError(f"GAN launches (K1, K2 nhwc, K2 plane) per "
                             f"step {launches}, expected {want}")
    if not all(np.isfinite(losses["D"] + losses["G"])):
        raise AssertionError(f"GAN losses {losses}")
    if (int(gs.step), int(ds.step), int(gs.skipped), int(ds.skipped)) != (
            GAN_WARMUP + GAN_TIMED, 1 + len(d_ms), 0, 0):
        raise AssertionError(f"GAN steps: G {int(gs.step)}, D "
                             f"{int(ds.step)}, skipped {int(gs.skipped)}, "
                             f"{int(ds.skipped)}")
    print(f"gan: batch {TRAIN_BATCH}x{TRAIN_CROP}^2 uint8, Adam "
          f"{TRAIN_LR:g} (G, clip 1) and {TRAIN_LR * 0.1:g} (D), D every "
          f"{GAN_D_EVERY} | {GAN_WARMUP} warm-up + {GAN_TIMED} timed "
          f"iterations: G step {np.mean(g_ms):.3f} ms (CUDA events; min "
          f"{min(g_ms):.3f}, max {max(g_ms):.3f}), D step "
          f"{np.mean(d_ms):.3f} ms ({len(d_ms)} steps), "
          f"{iter_ms:.3f} ms per iteration (host clock {t_wall:.3f}), "
          f"{TRAIN_BATCH / iter_ms * 1e3:.1f} images/s | peak memory "
          f"{peak / 2**30:.3f} GiB | launches (K1, K2 nhwc, K2 plane): D "
          f"step {launches['D']}, G step {launches['G']}", flush=True)
    print("gan: G step ms " + " ".join(f"{t:.3f}" for t in g_ms)
          + " | D step ms " + " ".join(f"{t:.3f}" for t in d_ms), flush=True)
    print("gan: G loss " + " ".join(f"{v:.6f}" for v in losses["G"])
          + " | D loss " + " ".join(f"{v:.6f}" for v in losses["D"]),
          flush=True)

    # the guard: non-finite D and G steps keep both states bit-equal
    g0, d0 = _bits(gs), _bits(ds)
    nan = torch.full((TRAIN_BATCH, 3, TRAIN_CROP, TRAIN_CROP), float("nan"),
                     device="cuda")
    ds, md = d_step(gs, ds, hr_u8, (nan, nan))
    d1 = _bits(ds)
    nan_g = make_gan_g_step(g, d, lambda a, b: percep(a, b) * np.nan, 4,
                            first, last)
    gs, ds, mg = nan_g(gs, ds, hr_u8)
    g1, d2 = _bits(gs), _bits(ds)
    kept = (_bit_equal(d1[:-1], d0[:-1]) and _bit_equal(g1[:-1], g0[:-1])
            and _bit_equal(d2, d1))
    if not (kept and int(ds.skipped) == 1 and int(gs.skipped) == 1
            and float(md["nonfinite_steps_D"]) == 1.0
            and float(mg["nonfinite_steps"]) == 1.0):
        raise AssertionError(f"GAN guard: states kept {kept}, skipped G "
                             f"{int(gs.skipped)} D {int(ds.skipped)}")
    print(f"gan: guard: a NaN D step and a NaN G step leave G's {len(g0)} "
          f"and D's {len(d0)} tensors (params, buffers, Adam moments and "
          f"steps, step) bit-equal; skipped G 0 -> 1 (G step only), D 0 -> "
          f"1 (D step only)", flush=True)

    handles = _labelled({"G": g, "D": d, "VGG19": percep.net})
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(GAN_PROFILED):
                iteration(i)
            torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    split = _device_split(prof, ("G", "D", "VGG19"))
    total = sum(split.values())
    n_kernels = sum(1 for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and e.name not in ("G", "D", "VGG19"))
    if total:
        print(f"gan: profile of {GAN_PROFILED} iterations (1 D step): "
              f"{n_kernels / GAN_PROFILED:.0f} kernels and "
              f"{total / GAN_PROFILED / 1e3:.3f} ms of device time per "
              f"iteration, busy share {total / GAN_PROFILED / 1e3 / iter_ms:.3f}"
              f" of the {iter_ms:.3f} ms iteration | "
              + ", ".join(f"{k} {v / GAN_PROFILED / 1e3:.3f} ms ({v / total:.3f})"
                          for k, v in sorted(split.items(),
                                             key=lambda kv: -kv[1])),
              flush=True)
    else:
        print("gan: the profiler recorded no device time", flush=True)

    # K2 at the GAN steps' shape, forward and backward, against its plain
    # version (the G step's forward, the D step's no-grad forward)
    from food101_sr_tpu_torch.ops.spatial_mean import (spatial_mean,
                                                       spatial_mean_plain)

    kgen = torch.Generator(device="cuda").manual_seed(8)
    shape = (TRAIN_BATCH, 96, TRAIN_CROP // 4, TRAIN_CROP // 4)
    rel, abs_err, x = _k2_nhwc_err(shape, kgen)
    gy = torch.rand(shape[:2], device="cuda", generator=kgen)
    xa, xb = (x.clone().requires_grad_(True) for _ in range(2))
    (spatial_mean(xa) * gy).sum().backward()
    (spatial_mean_plain(xb) * gy).sum().backward()
    bwd = (xa.grad - xb.grad).abs().max().item()
    if not (rel <= K2_RTOL and bwd <= K1_TOL):
        raise AssertionError(f"K2 nhwc at the GAN shape: rel {rel}, "
                             f"backward {bwd}")
    t2 = _k2_nhwc_timings(x, rates)
    print(f"gan K2 nhwc: {'x'.join(map(str, shape))} f32 channels-last, rel "
          f"err {rel:.2g} forward, backward max abs {bwd:.2g}: kernel "
          f"{t2['ms']:.4f} ms, device {t2['device_ms']:.4f}, plain "
          f"{t2['plain_ms']:.4f}, x.mean {t2['library_ms']:.4f}, bound "
          f"{t2['bound_ms']:.4f} ({t2['bound_by']}) | gan phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t2.update({
        "name": "K2 spatial mean (SE squeeze), nhwc input, GAN steps",
        "route": "cuda", "source": "food101_sr_tpu_torch/csrc/kernels.cu",
        "replaces": "food101_sr_tpu/ops/spatial_mean.py:45",
        "wrapper": "food101_sr_tpu_torch/ops/spatial_mean.py:"
                   "mean_nhwc_kernel",
        "launches": launches["D"][1] + launches["G"][1],
        "max_abs_err": max(abs_err, bwd),
        "at": f"one GAN iteration with a D step: {n_blocks} launches in "
              f"the D step (the eval-mode fake) and {n_blocks} in the G "
              f"step; 1 launch: ({TRAIN_BATCH},96,{TRAIN_CROP // 4},"
              f"{TRAIN_CROP // 4}) float32 channels-last",
        "g_step_ms": float(np.mean(g_ms)), "d_step_ms": float(np.mean(d_ms)),
        "images_per_s": TRAIN_BATCH / iter_ms * 1e3, "peak_bytes": peak,
        "device_split_ms": {k: v / GAN_PROFILED / 1e3
                            for k, v in split.items()}})
    return t2


def _serve_generator(arch: str, state_dict: dict, rng) -> dict:
    """The generators phase's serving part: ``state_dict`` (the registry
    ``arch`` after the phase's train steps) through ``SRServer("auto")``
    in bf16, channels-last: GEN_REQUESTS 64x64 requests from 8 threads,
    each within LEVEL_TOL of a direct forward of its input alone, then one
    image larger than tile + 2 * halo, tiled; the tiled result held within
    LEVEL_TOL of the whole-image forward in float32, TF32 off. Served
    after training because the seeded ResNetSR's BatchNorms have no
    running stats yet: its outputs reach ~1e4, where float32 rounding
    alone moves a uint8 level (25 levels on the card before the
    reordering), whatever the tiling."""
    from food101_sr_tpu_torch.ops import full_fp32
    from food101_sr_tpu_torch.serving import SRServer

    server = SRServer("auto", state_dict=state_dict, device="cuda",
                      dtype=torch.bfloat16)
    try:
        if server.architecture != arch:
            raise AssertionError(f"SRServer('auto') took {arch}'s weights "
                                 f"for {server.architecture}")
        win = server.tile + 2 * server.halo
        side = server.tile * (-(-win // server.tile) + 1)  # > the window
        server.warmup([(s, s) for s in (server.tile, min(win, side))])
        small = [rng.integers(0, 256, (64, 64, 3), np.uint8)
                 for _ in range(GEN_REQUESTS)]
        large = rng.integers(0, 256, (side, side, 3), np.uint8)
        b0 = server.batcher.n_batches
        with cf.ThreadPoolExecutor(max_workers=8) as pool:
            t0 = time.perf_counter()
            out = list(pool.map(server.upscale, small))
            t_small = time.perf_counter() - t0
        n_batches = server.batcher.n_batches - b0
        i1 = server.batcher.n_items
        tiled_bf16 = server.upscale(large)
        n_windows = server.batcher.n_items - i1
        lv_small = max(_levels(o, _direct(server, i))
                       for i, o in zip(small, out))
        halo = server.halo
    finally:
        server.close()
    exact = SRServer("auto", state_dict=state_dict, device="cuda",
                     dtype=torch.float32)
    try:
        with full_fp32():
            whole32 = _direct(exact, large)
            lv_tiled = _levels(exact.upscale(large), whole32)
    finally:
        exact.close()
    if not (all(o.shape == (256, 256, 3) and o.dtype == np.uint8
                for o in out) and tiled_bf16.shape == (4 * side, 4 * side, 3)):
        raise AssertionError(f"{arch} served shapes")
    if max(lv_small, lv_tiled) > LEVEL_TOL:
        raise AssertionError(f"{arch} serving: batched vs direct {lv_small}, "
                             f"tiled vs whole (f32) {lv_tiled} levels")
    if n_windows < 2:
        raise AssertionError(f"{arch}: the {side}^2 image was not tiled")
    return {"images_per_s": len(small) / t_small, "batches": n_batches,
            "halo": halo, "window": win, "tiled_side": side,
            "windows": n_windows,
            "levels_batched": lv_small, "levels_tiled_f32": lv_tiled,
            "levels_tiled_bf16_vs_f32": _levels(tiled_bf16, whole32)}


def _train_generator(arch: str) -> dict:
    """The generators phase's training part for registry ``arch`` (f32,
    channels-last, TF32 convs, NLPD, Adam 4e-4, batch TRAIN_BATCH of
    TRAIN_CROP px uint8 crops made on the device): raw gradients on
    GRAD_BATCH crops against the CPU; GEN_WARMUP + GEN_TIMED steps under
    CUDA events, the first timed one counting the kernels' launches; a
    profile of GEN_PROFILED steps for the busy share; the guard on a NaN
    loss."""
    from food101_sr_tpu_torch.losses import get_loss_function
    from food101_sr_tpu_torch.models import get_model, param_count
    from food101_sr_tpu_torch.ops import (blur_kernel, mean_nhwc_kernel,
                                          mean_plane_kernel)
    from food101_sr_tpu_torch.training import (FIRST_LAST, SRTrainState,
                                               make_adam, make_train_step)

    t0 = time.perf_counter()
    model = get_model(arch, device="cuda",
                      generator=torch.Generator().manual_seed(0)).train()
    worst = _grad_check(model, arch=arch)
    t_grad = time.perf_counter() - t0
    if not worst["either"][0] <= 1.0:
        raise AssertionError(f"{arch} gradients, card vs CPU plain: "
                             f"{worst['either'][1]} at {worst['either'][0]} "
                             f"of the limit")
    loss_fn = get_loss_function("nlpd")
    first, last = FIRST_LAST[arch]
    state = SRTrainState.create(model, make_adam(TRAIN_LR))
    step = make_train_step(model, loss_fn, 4, first, last)
    gen = torch.Generator(device="cuda").manual_seed(5)
    hr_u8 = torch.randint(0, 256, (TRAIN_BATCH, TRAIN_CROP, TRAIN_CROP, 3),
                          dtype=torch.uint8, device="cuda", generator=gen)
    losses = []
    for _ in range(GEN_WARMUP):
        state, m = step(state, hr_u8)
        losses.append(m["train_loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(GEN_TIMED + 1)]
    ev[0].record()
    for i in range(GEN_TIMED):
        if i == 0:  # ---- main path: one train step, counts from zero ----
            blur_kernel.launches = 0
            mean_nhwc_kernel.launches = mean_plane_kernel.launches = 0
        state, m = step(state, hr_u8)
        if i == 0:
            launches = (blur_kernel.launches, mean_nhwc_kernel.launches,
                        mean_plane_kernel.launches)
            # ---- end of main path ----
        losses.append(m["train_loss"])
        ev[i + 1].record()
    ev[-1].synchronize()
    peak = torch.cuda.max_memory_allocated()
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(GEN_TIMED)]
    mean_ms = float(np.mean(step_ms))
    losses = [float(v) for v in losses]
    if launches != (8, 0, 0):
        raise AssertionError(f"{arch}: one train step launched (K1, K2 nhwc, "
                             f"K2 plane) {launches}, expected (8, 0, 0)")
    if not (all(np.isfinite(losses)) and int(state.skipped) == 0):
        raise AssertionError(f"{arch}: train losses {losses}, skipped "
                             f"{int(state.skipped)}")
    # the groups and top kernels for the deepest net
    kernels, dev_ms = _profile(step, state, hr_u8, GEN_PROFILED, mean_ms,
                               verbose=arch == "RRDB",
                               label=f"generators {arch} profile")

    # the guard: a NaN loss keeps params, Adam's state and the buffers
    nan_step = make_train_step(model, lambda sr, hr: loss_fn(sr, hr) * np.nan,
                               4, first, last)
    before = _bits(state)
    state, m = nan_step(state, hr_u8)
    after = _bits(state)
    n_bufs = sum(1 for _ in model.buffers())
    if not (_bit_equal(before[:-1], after[:-1]) and int(state.skipped) == 1
            and float(m["nonfinite_steps"]) == 1.0):
        raise AssertionError(f"{arch} guard: state kept "
                             f"{_bit_equal(before[:-1], after[:-1])}, "
                             f"skipped {int(state.skipped)}")
    return {"params": param_count(model), "grad": worst,
            "state_dict": {k: v.detach().cpu().clone()
                           for k, v in model.state_dict().items()},
            "grad_s": t_grad, "step_ms": mean_ms, "step_ms_all": step_ms,
            "images_per_s": TRAIN_BATCH / mean_ms * 1e3, "peak_bytes": peak,
            "kernels_per_step": kernels, "device_ms_per_step": dev_ms,
            "busy_share": dev_ms / mean_ms, "losses": losses,
            "launches": {"K1": launches[0], "K2 nhwc": launches[1],
                         "K2 nchw": launches[2]},
            "guard_tensors": len(before) - 1, "guard_buffers": n_bufs}


def phase_generators() -> dict:
    """SRCNN, ResNetSR and RRDB at registry size on the card (module
    docstring, phase 11): each trained from seeded weights, then served.
    Returns per net the numbers the phase prints, K1's and K2's launches
    per step included."""
    rng = np.random.default_rng(10)
    out = {}
    for arch in GEN_ARCHS:
        t0 = time.perf_counter()
        tr = _train_generator(arch)
        torch.cuda.empty_cache()
        serve = _serve_generator(arch, tr["state_dict"], rng)
        torch.cuda.empty_cache()
        g = tr["grad"]
        print(f"generators: {arch} x4 ({tr['params']} params) | serve bf16 "
              f"(SRServer('auto') on the trained weights): "
              f"{GEN_REQUESTS} 64x64 req from 8 threads in {serve['batches']}"
              f" batches, {serve['images_per_s']:.1f} images/s, max "
              f"{serve['levels_batched']} level(s) from direct; "
              f"{serve['tiled_side']}^2 tiled (halo {serve['halo']}, "
              f"{serve['windows']} windows of {serve['window']} px): f32 "
              f"tiled vs whole "
              f"{serve['levels_tiled_f32']} level(s), bf16 vs f32 "
              f"{serve['levels_tiled_bf16_vs_f32']} | train f32 batch "
              f"{TRAIN_BATCH}x{TRAIN_CROP}^2 NLPD: {tr['step_ms']:.3f} ms/step "
              f"(CUDA events, {GEN_TIMED} steps; min "
              f"{min(tr['step_ms_all']):.3f}, max {max(tr['step_ms_all']):.3f})"
              f", {tr['images_per_s']:.1f} images/s, busy share "
              f"{tr['busy_share']:.3f} ({tr['device_ms_per_step']:.3f} ms "
              f"device, {tr['kernels_per_step']:.0f} kernels per step), peak "
              f"{tr['peak_bytes'] / 2**30:.3f} GiB | launches per step: K1 "
              f"{tr['launches']['K1']}, K2 nhwc {tr['launches']['K2 nhwc']}, "
              f"K2 nchw {tr['launches']['K2 nchw']} | gradients on "
              f"{GRAD_BATCH}x{TRAIN_CROP}^2 vs CPU (TF32 off): worst "
              f"{g['either'][1]} at {g['either'][0]:.3g} of the limit "
              f"(term sum: worst {g['term_sum'][0]:.3g} at {g['term_sum'][1]}"
              f", tol {GRAD_TOL}; max abs: worst {g['max_abs'][0]:.3g} at "
              f"{g['max_abs'][1]}, tol {G_GRAD_TOL}), {tr['grad_s']:.1f} s | "
              f"guard on a NaN loss: {tr['guard_tensors']} tensors "
              f"({tr['guard_buffers']} buffers) bit-equal, skipped 1 | "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        print(f"generators: {arch} step ms "
              + " ".join(f"{t:.3f}" for t in tr["step_ms_all"]) + " | loss "
              + " ".join(f"{v:.6f}" for v in tr["losses"]), flush=True)
        out[arch] = {
            "params": tr["params"], "served_images_per_s":
            serve["images_per_s"], "step_ms": tr["step_ms"],
            "images_per_s": tr["images_per_s"], "busy_share":
            tr["busy_share"], "device_ms_per_step": tr["device_ms_per_step"],
            "kernels_per_step": tr["kernels_per_step"],
            "peak_bytes": tr["peak_bytes"], "launches": tr["launches"],
            "grad_either": g["either"][0], "grad_term_sum": g["term_sum"][0],
            "grad_max_abs": g["max_abs"][0], "halo": serve["halo"],
            "levels_tiled_f32": serve["levels_tiled_f32"]}
    print("generators numbers: " + json.dumps(out), flush=True)
    return out



def _http(port: int, path: str, body: bytes | None = None,
          headers: dict | None = None) -> tuple:
    """(status, headers, body, client ms) of one request to 127.0.0.1;
    HTTP errors are returned, not raised."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method="POST" if body is not None else "GET",
                                 headers=headers or {})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            out = r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        out = e.code, e.headers, e.read()
    return (*out, (time.perf_counter() - t0) * 1e3)


def _raw_http(port: int, payload: bytes) -> bytes:
    """Raw bytes in (half-closed after), the whole response out."""
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(payload)
        s.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            b = s.recv(65536)
            if not b:
                return b"".join(chunks)
            chunks.append(b)


def _burst(port: int, path: str, bodies: list, threads: int):
    """POST every body from ``threads`` client threads: (responses, wall
    seconds); any status but 200 fails."""
    with cf.ThreadPoolExecutor(max_workers=threads) as pool:
        t0 = time.perf_counter()
        res = list(pool.map(lambda b: _http(port, path, b), bodies))
        wall = time.perf_counter() - t0
    bad = [r[0] for r in res if r[0] != 200]
    if bad:
        raise AssertionError(f"POST {path}: statuses {bad}")
    return res, wall


def _bucket(name: str, res: list, wall: float) -> dict:
    ms = [r[3] for r in res]
    return {"bucket": name, "requests": len(res),
            "images_per_s": len(res) / wall,
            "p50_ms": float(np.percentile(ms, 50)),
            "p95_ms": float(np.percentile(ms, 95))}


def _statz_delta(a: dict, b: dict) -> dict:
    """One bucket's attribution from two /statz readings around it: host
    ms per request (decode, encode) and batcher ms per device batch."""
    served = b["served"] - a["served"]
    batches = b["device_batches"] - a["device_batches"]
    out = {"served": served, "batches": batches}
    for k in ("t_decode_s", "t_encode_s"):
        out[f"{k[2:-2]}_ms_per_request"] = (b[k] - a[k]) / served * 1e3
    for k in ("t_collect_s", "t_h2d_s", "t_exec_fetch_s", "t_exec_s",
              "t_d2h_s"):
        out[f"{k[2:-2]}_ms_per_batch"] = (b[k] - a[k]) / batches * 1e3
    return out


def _hand_tta(server, img: np.ndarray) -> np.ndarray:
    """The x8 self-ensemble of one (unpadded-bucket) image done by hand:
    each dihedral transform (torch.rot90 and a flip, not the flips and
    transposes of ops/tta.py) forwarded alone in row 0 of a batch of
    4 * max_batch rows, the TTA forwards' shape (bf16 cuDNN picks its
    algorithm by shape), undone, averaged in float32 and rounded to the
    server's dtype as the server does."""
    rows = 4 * server.batcher.max_batch
    x = (torch.from_numpy(img).cuda().permute(2, 0, 1)[None].float()
         / 255.0).to(server.dtype)
    acc = 0
    with torch.inference_mode():
        for k in range(4):
            for flip in (False, True):
                t = torch.rot90(x, k, (2, 3))
                t = torch.flip(t, (3,)) if flip else t
                batch = t.new_zeros((rows, *t.shape[1:]))
                batch[0] = t[0]
                y = server.model(batch)[:1]
                y = torch.flip(y, (3,)) if flip else y
                acc = acc + torch.rot90(y, -k, (2, 3)).float()
    y = (acc / 8).to(server.dtype).float()
    y8 = (y.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    return y8[0].permute(1, 2, 0).cpu().numpy()


def _drain(server, imgs: list) -> tuple[list, float]:
    """A front end of its own over ``server``: every request of ``imgs``
    is inside its handler when ``shutdown()`` (what SIGTERM runs) is
    called; returns the responses and the seconds from shutdown to the
    last handler's end."""
    from food101_sr_tpu_torch import native
    from food101_sr_tpu_torch.serve import SRHTTPServer, make_handler

    entered = threading.Semaphore(0)

    class Counting(make_handler(server)):
        def do_POST(self):
            entered.release()
            super().do_POST()

    httpd = SRHTTPServer(("127.0.0.1", 0), Counting)
    port = httpd.server_address[1]
    loop = threading.Thread(target=httpd.serve_forever)
    loop.start()
    results = [None] * len(imgs)

    def client(i):
        results[i] = _http(port, "/sr", native.encode_png_rgb8(imgs[i]))

    clients = [threading.Thread(target=client, args=(i,))
               for i in range(len(imgs))]
    for c in clients:
        c.start()
    try:
        for _ in clients:
            if not entered.acquire(timeout=300):
                raise AssertionError("drain: a request never reached its "
                                     "handler")
    finally:
        t0 = time.perf_counter()
        httpd.shutdown()
        httpd.server_close()  # joins the handler threads
        drain_s = time.perf_counter() - t0
        for c in clients + [loop]:
            c.join(timeout=300)
    if any(c.is_alive() for c in clients + [loop]):
        raise AssertionError("drain: a thread outlived shutdown")
    return results, drain_s


def _k2_tta(rates, launches: int) -> dict:
    """K2 NHWC at the --tta forwards' SE shape, (4 * max_batch, 96, 64,
    64) channels-last, against its plain version (f32 relative, bf16 one
    ulp) and timed in bf16, the main path's dtype."""
    from food101_sr_tpu_torch.ops.spatial_mean import (mean_nhwc_kernel,
                                                       spatial_mean_plain)

    shape = (32, 96, 64, 64)
    gen = torch.Generator(device="cuda").manual_seed(12)
    base = torch.rand(shape, device="cuda", generator=gen) * 2.0 - 0.5
    abs_err = rel = ulp = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        x = base.to(dtype).contiguous(memory_format=torch.channels_last)
        got, want = mean_nhwc_kernel(x).float(), spatial_mean_plain(x).float()
        diff = (got - want).abs()
        abs_err = max(abs_err, diff.max().item())
        if dtype == torch.float32:
            rel = (diff / want.abs().clamp_min(1e-6)).max().item()
        else:
            ulp = (diff / _ulp_bf16(want)).max().item()
    if not (rel <= K2_RTOL and ulp <= 1.0):
        raise AssertionError(f"K2 nhwc at {shape} disagrees with its plain "
                             f"version: rel {rel} (f32), {ulp} ulp (bf16)")
    x = (torch.rand(shape, device="cuda", generator=gen)
         .to(torch.bfloat16).contiguous(memory_format=torch.channels_last))
    t = _timings(lambda: mean_nhwc_kernel(x), lambda: spatial_mean_plain(x),
                 lambda: x.mean((2, 3)), launches=1)
    n = x.numel()
    t["bound_ms"], t["bound_by"] = bound(2 * n + 2 * shape[0] * shape[1], n,
                                         rates)
    print(f"K2 spatial mean, nhwc, TTA shape 32x96x64x64: max_abs_err "
          f"{abs_err:.3g} (f32 rel {rel:.2g} <= {K2_RTOL}, bf16 {ulp:.2g} ulp "
          f"<= 1) | bf16: kernel {t['ms']:.4f} ms, device "
          f"{t['device_ms']:.4f}, host {t['host_us']:.1f} us, plain "
          f"{t['plain_ms']:.4f}, x.mean {t['library_ms']:.4f}, bound "
          f"{t['bound_ms']:.4f} ({t['bound_by']}) | {launches} launches "
          "in the http phase's --tta requests", flush=True)
    return {"name": "K2 spatial mean (SE squeeze), nhwc input, TTA shape",
            "route": "cuda", "source": "food101_sr_tpu_torch/csrc/kernels.cu",
            "replaces": "food101_sr_tpu/ops/spatial_mean.py:45",
            "wrapper": "food101_sr_tpu_torch/ops/spatial_mean.py:"
                       "mean_nhwc_kernel",
            "at": "1 launch: (32,96,64,64) bfloat16 channels-last, the SE "
                  "squeeze of the --tta forwards (4 x max_batch rows)",
            "launches": launches, "max_abs_err": abs_err, **t}


def _png_16bit() -> bytes:
    """An 8x8 16-bit RGB PNG (which the port refuses by name)."""
    from food101_sr_tpu_torch import native

    ihdr = struct.pack(">IIBBBBB", 8, 8, 16, 2, 0, 0, 0)
    return (native.PNG_SIGNATURE + native._chunk(b"IHDR", ihdr)
            + native._chunk(b"IDAT", zlib.compress(bytes(8 * 49)))
            + native._chunk(b"IEND", b""))


def phase_http(rates) -> tuple[dict, dict]:
    """The port's HTTP front end and offline CLI on the card (module
    docstring, phase 8). Returns the phase's launches by kernel and K2's
    record at the --tta shape."""
    from food101_sr_tpu_torch import native, predict
    from food101_sr_tpu_torch.ops import (blur_kernel, full_fp32,
                                          mean_nhwc_kernel, mean_plane_kernel)
    from food101_sr_tpu_torch.serve import (SRHTTPServer, device_name,
                                            make_handler)
    from food101_sr_tpu_torch.serving import SRServer

    t_phase = time.perf_counter()
    rng = np.random.default_rng(11)
    asset = os.path.join(ASSETS, "winner_srcnn.pth")
    goldens = np.load(os.path.join(ASSETS, "winner_srcnn_goldens.npz"))
    gold = [(goldens[f"lr_{i}"], goldens[f"sr_{i}"]) for i in range(4)]
    attn = SRServer("AttentionSR", device="cuda", dtype=torch.bfloat16,
                    generator=torch.Generator().manual_seed(0),
                    adaptive_window=True, instrument=True)
    srcnn = SRServer("auto", checkpoint=asset, device="cuda",
                     dtype=torch.float32)
    tta = SRServer("AttentionSR", device="cuda", dtype=torch.bfloat16,
                   generator=torch.Generator().manual_seed(0),
                   adaptive_window=True, tta=True)
    servers, httpds, bursts = [attn, srcnn, tta], [], []
    tmp = tempfile.TemporaryDirectory()

    def start(handler) -> int:
        httpd = SRHTTPServer(("127.0.0.1", 0), handler)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        httpds.append((httpd, thread))
        return httpd.server_address[1]

    try:
        n_blocks = attn.model.num_residuals
        t0 = time.perf_counter()
        attn.warmup()  # --warmup
        tta.warmup([(attn.tile, attn.tile)])
        srcnn.warmup()
        warm_s = time.perf_counter() - t0
        port = start(make_handler({"attn": attn, "srcnn": srcnn}))
        tport = start(make_handler(tta))
        cold = [rng.integers(0, 256, (64, 64, 3), np.uint8)
                for _ in range(HTTP_REQUESTS)]
        small = [rng.integers(0, 256, (64, 64, 3), np.uint8)
                 for _ in range(HTTP_REQUESTS)]
        tiled = [rng.integers(0, 256, (*HTTP_TILED_SHAPE, 3), np.uint8)
                 for _ in range(HTTP_TILED)]
        tta_imgs = [rng.integers(0, 256, (64, 64, 3), np.uint8)
                    for _ in range(TTA_REQUESTS)]
        pred_imgs = {f"p{i:02d}.png": rng.integers(0, 256, (64, 64, 3),
                                                   np.uint8)
                     for i in range(PREDICT_IMAGES)}
        pred_imgs["tiled.png"] = rng.integers(0, 256, (*HTTP_TILED_SHAPE, 3),
                                              np.uint8)
        pred_in = os.path.join(tmp.name, "in")
        pred_out = os.path.join(tmp.name, "out")
        os.makedirs(pred_in)
        for name, img in pred_imgs.items():
            with open(os.path.join(pred_in, name), "wb") as f:
                f.write(native.encode_png_rgb8(img))
        cold_b = [native.encode_png_rgb8(x) for x in cold]
        small_b = [native.encode_png_rgb8(x) for x in small]
        tiled_b = [native.encode_png_rgb8(x) for x in tiled]
        tta_b = [native.encode_png_rgb8(x) for x in tta_imgs]
        gold_b = [native.encode_png_rgb8(x) for x, _ in gold]
        if not native.jpeg_available():
            raise AssertionError("the JPEG codec did not build: "
                                 f"{native.build_error('fast_jpeg')}")
        jpeg_body = native.encode_jpeg_rgb8(small[0], 95)
        jpeg_imgs = [rng.integers(0, 256, (64, 64, 3), np.uint8)
                     for _ in range(JPEG_ROUND)]
        jpeg_b = [native.encode_jpeg_rgb8(x, 90) for x in jpeg_imgs]
        with open(os.path.join(JPEG_ASSETS, "streams", "cmyk.jpg"), "rb") as f:
            cmyk_body = f.read()
        torch.cuda.synchronize()

        # ---- main path: counts from zero -------------------------------
        blur_kernel.launches = 0
        mean_nhwc_kernel.launches = mean_plane_kernel.launches = 0
        b_attn, b_tta = attn.batcher.n_batches, tta.batcher.n_batches
        # the front end's first traffic (cold), then the same bucket warm,
        # then the tiled bucket; /statz read between them
        stats = [json.loads(_http(port, "/statz")[2])["attn"]]
        for path, bodies in (("/sr?model=attn", cold_b),
                             ("/sr?model=attn", small_b),
                             ("/sr?model=attn", tiled_b),
                             ("/sr?model=attn&format=jpeg", jpeg_b)):
            bursts.append(_burst(port, path, bodies, HTTP_THREADS))
            stats.append(json.loads(_http(port, "/statz")[2])["attn"])
        health = json.loads(_http(port, "/healthz")[2])
        r_jpeg_in = _http(port, "/sr?model=attn", jpeg_body)
        r_jpeg_out = _http(port, "/sr?model=attn&format=jpeg", small_b[0])
        r_cmyk = _http(port, "/sr?model=attn", cmyk_body)
        with full_fp32():  # float32 as the goldens' CPU run, TF32 off
            r_gold = [_http(port, "/sr?model=srcnn", b) for b in gold_b]
        k2_before = mean_nhwc_kernel.launches
        r_tta, wall_tta = _burst(tport, "/sr", tta_b, HTTP_THREADS)
        tta_launches = mean_nhwc_kernel.launches - k2_before
        b_tta = tta.batcher.n_batches - b_tta
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            predict.main([pred_in, "--out_dir", pred_out, "--warmup"])
        pred_line = buf.getvalue().strip().splitlines()[-1]
        r_drain, drain_s = _drain(attn, tiled[:DRAIN_REQUESTS])
        torch.cuda.synchronize()
        launches = {"K1": blur_kernel.launches,
                    "K2 nhwc": mean_nhwc_kernel.launches,
                    "K2 nchw": mean_plane_kernel.launches}
        b_attn = attn.batcher.n_batches - b_attn
        # ---- end of main path ------------------------------------------

        # the predict server (seeded alike) warms two buckets and serves;
        # what is not the zoo's or the TTA server's is its batches
        rest = launches["K2 nhwc"] - n_blocks * (b_attn + 2 * b_tta)
        if (launches["K1"] or launches["K2 nchw"] or rest <= 0
                or rest % n_blocks or tta_launches != 2 * n_blocks * b_tta):
            raise AssertionError(f"http launches {launches}: {b_attn} zoo "
                                 f"and {b_tta} --tta device batches, "
                                 f"{tta_launches} K2 in the --tta requests")
        if not (health["device"] == attn.device.type
                and health["device_name"] == device_name(attn.device)
                and health["jpeg"] is True
                and set(health["models"]) == {"attn", "srcnn"}):
            raise AssertionError(f"/healthz {health}")

        # every PNG response is the engine's result bit for bit
        for imgs, res in ((cold, bursts[0][0]), (small, bursts[1][0]),
                          (tiled, bursts[2][0]),
                          (tiled[:DRAIN_REQUESTS], r_drain)):
            for img, (code, hdrs, data, _) in zip(imgs, res):
                if not (code == 200 and hdrs["Content-Type"] == "image/png"
                        and np.array_equal(native.decode_image(data),
                                           attn.upscale(img))):
                    raise AssertionError(f"{img.shape} response ({code}) is "
                                         "not SRServer.upscale's result")
        want = attn.upscale(native.decode_image(jpeg_body))
        if not (r_jpeg_in[0] == 200 and np.array_equal(
                native.decode_image(r_jpeg_in[2]), want)
                and r_jpeg_out[0] == 200
                and r_jpeg_out[1]["Content-Type"] == "image/jpeg"
                and r_jpeg_out[2] == native.encode_jpeg_rgb8(
                    attn.upscale(small[0]), 90)):
            raise AssertionError("JPEG request or response failed")
        # the JPEG round: each response is the port's encode of the
        # engine's result for the decoded upload, byte for byte
        for body, (code, hdrs, data, _) in zip(jpeg_b, bursts[3][0]):
            if not (code == 200 and hdrs["Content-Type"] == "image/jpeg"
                    and data == native.encode_jpeg_rgb8(
                        attn.upscale(native.decode_image(body)), 90)):
                raise AssertionError(f"JPEG round response ({code}) is not "
                                     "encode_jpeg_rgb8(SRServer.upscale)")
        if not (r_cmyk[0] == 415 and b"CMYK" in r_cmyk[2]):
            raise AssertionError(f"CMYK upload: {r_cmyk[0]} {r_cmyk[2][:80]}")
        jpeg_note = (f"a JPEG request, a ?format=jpeg response and "
                     f"{JPEG_ROUND} 64x64 JPEG uploads answered as JPEG, "
                     "byte-equal to encode_jpeg_rgb8(SRServer.upscale); a "
                     "CMYK upload 415 naming it")
        print(f"http: jpeg: {jpeg_note}", flush=True)

        # the SRCNN asset in f32 against the JAX package's goldens
        lv_gold = []
        for (x, want), (code, _, data, _) in zip(gold, r_gold):
            if code != 200:
                raise AssertionError(f"srcnn asset: status {code}")
            lv_gold.append(_levels(native.decode_image(data), want))
        if max(lv_gold) > LEVEL_TOL:
            raise AssertionError(f"SRCNN asset vs JAX goldens: {lv_gold} "
                                 "levels")
        half = SRServer("auto", checkpoint=asset, device="cuda",
                        dtype=torch.bfloat16)
        try:
            lv_gold_bf16 = [_levels(half.upscale(x), want) for x, want in gold]
        finally:
            half.close()

        # --tta against the eight dihedral forwards averaged by hand
        lv_tta = max(_levels(native.decode_image(r_tta[i][2]),
                             _hand_tta(tta, tta_imgs[i]))
                     for i in range(TTA_CHECKED))
        if lv_tta > LEVEL_TOL:
            raise AssertionError(f"--tta vs the hand-made ensemble: {lv_tta} "
                                 "levels")

        # predict: every output is the engine's result
        pred = json.loads(pred_line)
        if not (pred["n_images"] == len(pred_imgs) and pred["failed"] == 0):
            raise AssertionError(f"predict: {pred_line}")
        for name, img in pred_imgs.items():
            path = os.path.join(pred_out, name[:-4] + "_x4.png")
            with open(path, "rb") as f:
                if not np.array_equal(native.decode_image(f.read()),
                                      attn.upscale(img)):
                    raise AssertionError(f"predict output {name} is not "
                                         "SRServer.upscale's result")

        # the error statuses of the JAX server
        errors = {
            "404 unknown model": _http(port, "/sr?model=nope", small_b[0]),
            "413": _raw_http(port, b"POST /sr HTTP/1.1\r\nHost: x\r\n"
                             b"Content-Length: 104857600\r\n\r\n"),
            "400 truncated": _raw_http(port, b"POST /sr HTTP/1.1\r\nHost: x"
                                       b"\r\nContent-Length: 5000\r\n\r\n"
                                       b"0123456789"),
            "415 16-bit PNG": _http(port, "/sr?model=attn", _png_16bit()),
        }
        codes = {"404 unknown model": errors["404 unknown model"][0],
                 "413": int(errors["413"][9:12] or 0),
                 "400 truncated": int(errors["400 truncated"][9:12] or 0),
                 "415 16-bit PNG": errors["415 16-bit PNG"][0]}
        if (codes != {"404 unknown model": 404, "413": 413,
                      "400 truncated": 400, "415 16-bit PNG": 415}
                or b"truncated" not in errors["400 truncated"]
                or b"16-bit" not in errors["415 16-bit PNG"][2]):
            raise AssertionError(f"error statuses {codes}")
    finally:
        for httpd, thread in httpds:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=60)
        for s in servers:
            s.close()
        tmp.cleanup()

    names = ("64x64 cold", "64x64",
             f"{HTTP_TILED_SHAPE[0]}x{HTTP_TILED_SHAPE[1]} tiled",
             "64x64 JPEG in and out")
    numbers = {
        "buckets": [{**_bucket(name, *burst), **_statz_delta(a, b)}
                    for name, burst, a, b in zip(names, bursts, stats,
                                                 stats[1:])],
        "tta": _bucket("64x64 --tta", r_tta, wall_tta),
        "predict": pred,
        "statz": stats[-1],
        "levels_srcnn_f32": lv_gold, "levels_srcnn_bf16": lv_gold_bf16,
        "levels_tta_vs_hand": lv_tta, "jpeg": True,
        "drain_s": drain_s, "warmup_s": warm_s, "launches": launches,
        "tta_launches": tta_launches, "error_codes": codes,
    }
    for b in numbers["buckets"] + [numbers["tta"]]:
        line = (f"http: {b['bucket']}: {b['requests']} requests from "
                f"{HTTP_THREADS} threads, {b['images_per_s']:.1f} images/s, "
                f"p50 {b['p50_ms']:.1f} ms, p95 {b['p95_ms']:.1f} ms (client "
                "side)")
        if "batches" in b:
            line += (f" | /statz (instrumented): {b['batches']} batches; "
                     f"decode {b['decode_ms_per_request']:.3f}, encode "
                     f"{b['encode_ms_per_request']:.3f} ms/request; per "
                     "batch collect {collect_ms_per_batch:.3f}, h2d "
                     "{h2d_ms_per_batch:.3f}, exec_fetch "
                     "{exec_fetch_ms_per_batch:.3f} (exec "
                     "{exec_ms_per_batch:.3f}, d2h {d2h_ms_per_batch:.3f}) "
                     "ms".format(**b))
        print(line, flush=True)
    print(f"http: every PNG response bit-equal to SRServer.upscale "
          f"({2 * HTTP_REQUESTS} 64x64, {HTTP_TILED} tiled, {DRAIN_REQUESTS} "
          f"drained) | --tta vs hand ensemble {lv_tta} level(s) | SRCNN "
          f"asset f32 vs JAX goldens {lv_gold} level(s), bf16 "
          f"{lv_gold_bf16} | errors {codes} | drain {drain_s:.2f} s | "
          f"predict: {pred_line} | launches {launches}, --tta "
          f"{tta_launches} = 2 x {n_blocks} x {b_tta} batches | "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    print("http numbers: " + json.dumps(numbers), flush=True)
    return launches, _k2_tta(rates, tta_launches)


def _deterministic() -> None:
    """The loop phase's determinism switches, set in its own process
    (cuBLAS reads CUBLAS_WORKSPACE_CONFIG when CUDA starts, so the parent
    passes it in the child's environment; the phases before keep theirs):
    PyTorch's deterministic algorithms (cuDNN picks deterministic
    convolutions), no cuDNN autotuning, and no NaN fill of new tensors
    (every tensor the loop reads is written first; the fill would only add
    a pass per allocation to the timed epochs)."""
    from torch.utils import deterministic

    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") != LOOP_CUBLAS:
        raise RuntimeError("the loop phase needs CUBLAS_WORKSPACE_CONFIG="
                           f"{LOOP_CUBLAS} before CUDA starts")
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.benchmark = False
    deterministic.fill_uninitialized_memory = False


def _flat(tree, path="") -> dict:
    """Leaves of nested dicts, lists and tuples by path."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {path: tree}
    return {k: v for key, sub in items for k, v in _flat(sub, f"{path}/{key}").items()}


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    return type(a) is type(b) and a == b


def _trace_busy(path: str) -> tuple[float, float]:
    """(device ms, wall ms) of a torch.profiler Chrome trace: the device's
    kernels, copies and fills, and the span of all its events."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if "dur" in e]
    busy = sum(e["dur"] for e in events
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    span = (max(float(e["ts"]) + e["dur"] for e in events)
            - min(float(e["ts"]) for e in events))
    return busy / 1e3, span / 1e3


def _loop_batches(n: int | None = None, n_test: int | None = None) -> dict:
    """Batch counts and sizes of the loop phase's loaders, from LOOP_CFG by
    train()'s own rules: a 10% val split of the n training images, a test
    source of n_test images (the synthetic source's n // 4 by default),
    and eval batches clamped to the split."""
    from food101_sr_tpu_torch.data import subset_indices, train_val_split

    seed, batch = LOOP_CFG["seed"], LOOP_CFG["batch_size"]
    n = LOOP_CFG["synthetic_size"] if n is None else n
    train_idx, val_idx = train_val_split(subset_indices(n, 1.0, seed), 0.1,
                                         seed + 1)
    n_test = max(n // 4, 8) if n_test is None else n_test
    val_b, test_b = min(batch, len(val_idx)), min(batch, n_test)
    return {"steps": len(train_idx) // batch, "val_batch": val_b,
            "val": len(val_idx) // val_b, "test_batch": test_b,
            "test": n_test // test_b}


def _loop_kernels(nb: dict, rates) -> dict:
    """K1 (forward and backward) and the NHWC K2 entry against their plain
    versions at every shape the loop gives them: NLPD pyramids of pred and
    target at the train, val and test batches, and the SE squeeze at those
    batches; both timed at the val batch (the train and test batches'
    shapes are the train phase's)."""
    crop, batch = LOOP_CFG["crop_size"], LOOP_CFG["batch_size"]
    batches = sorted({batch, nb["val_batch"], nb["test_batch"]})
    gen = torch.Generator(device="cuda").manual_seed(9)
    pyrs = {b: [torch.rand((2 * b, 3, crop >> i, crop >> i), device="cuda",
                           generator=gen) for i in range(4)] for b in batches}
    err1 = max(_k1_err(pyr, gen) for pyr in pyrs.values())
    rel2, err2, xs = 0.0, 0.0, {}
    for b in batches:
        r, e, xs[b] = _k2_nhwc_err((b, 96, crop // 4, crop // 4), gen)
        rel2, err2 = max(rel2, r), max(err2, e)
    if not (err1 <= K1_TOL and rel2 <= K2_RTOL):
        raise AssertionError(f"at the loop's shapes K1 is off by {err1}, "
                             f"K2 nhwc by {rel2} relative")
    vb = nb["val_batch"]
    t1, t2 = _k1_timings(pyrs[vb], rates), _k2_nhwc_timings(xs[vb], rates)
    sides = ",".join(str(crop >> i) for i in range(4))
    print(f"loop kernels: K1 fwd+bwd at ({','.join(str(2 * b) for b in batches)}"
          f",3,{{{sides}}}^2) f32: max_abs_err {err1:.3g} (tol {K1_TOL}) | "
          f"K2 nhwc at ({','.join(map(str, batches))},96,{crop // 4},"
          f"{crop // 4}) f32 channels-last: rel err {rel2:.2g} (tol "
          f"{K2_RTOL}) | val batch, K1 pyramid ({2 * vb},3,{{{sides}}}^2): "
          f"kernel {t1['ms']:.4f} ms, device {t1['device_ms']:.4f}, plain "
          f"{t1['plain_ms']:.4f}, conv2d {t1['library_ms']:.4f}, bound "
          f"{t1['bound_ms']:.4f} | K2 nhwc ({vb},96,{crop // 4},{crop // 4}): "
          f"kernel {t2['ms']:.4f} ms, device {t2['device_ms']:.4f}, plain "
          f"{t2['plain_ms']:.4f}, x.mean {t2['library_ms']:.4f}, bound "
          f"{t2['bound_ms']:.4f}", flush=True)
    t1["at"] = f"({2 * vb},3,{{{sides}}}^2) float32, deterministic mode"
    t2["at"] = f"({vb},96,{crop // 4},{crop // 4}) float32 channels-last"
    return {"max_abs_err": {"K1": err1, "K2 nhwc": err2},
            "at_val": {"K1": t1, "K2 nhwc": t2}}


def phase_loop(tmp: str) -> dict:
    """training.train() on the card (module docstring, phase 12), in the
    process that _deterministic() set up; run logs and weights go under
    ``tmp``. Returns the uninterrupted run's launch counts by entry point
    and the kernels' errors at the loop's shapes."""
    from food101_sr_tpu_torch.models import get_model
    from food101_sr_tpu_torch.ops import (blur_kernel, mean_nhwc_kernel,
                                          mean_plane_kernel)
    from food101_sr_tpu_torch.training import load_checkpoint, train

    t0 = time.perf_counter()
    _deterministic()
    nb = _loop_batches()
    kernels = _loop_kernels(nb, card_rates(torch.cuda.get_device_name(0)))
    os.environ["FOOD101_SR_RUN_DIR"] = runs = os.path.join(tmp, "runs")
    w = os.path.join(tmp, "weights")
    cfg = {**LOOP_CFG, "weights_dir": w}
    # ---- main path: one train() run, counts from zero ----
    blur_kernel.launches = 0
    mean_nhwc_kernel.launches = mean_plane_kernel.launches = 0
    final = train({**cfg, "save_name": "full", "run_name": "full"})
    total = (blur_kernel.launches, mean_nhwc_kernel.launches,
             mean_plane_kernel.launches)
    # ---- end of main path ----
    part = train({**cfg, "save_name": "part", "run_name": "part",
                  "preempt_after_updates": LOOP_PREEMPT,
                  "profile_steps": LOOP_PROFILED,
                  "profile_dir": os.path.join(tmp, "profile")})
    part_ckpt = load_checkpoint(os.path.join(w, "part_last.pth"))
    train({**cfg, "save_name": "part2", "run_name": "part2",
           "resume": os.path.join(w, "part_last.pth")})
    evald = train({**cfg, "epochs": 0, "save_name": "eval",
                   "run_name": "eval", "pretrained_weights":
                   os.path.join(w, "full_best.pth")})
    full_last = load_checkpoint(os.path.join(w, "full_last.pth"))
    part2_last = load_checkpoint(os.path.join(w, "part2_last.pth"))
    best = get_model("AttentionSR", device="cuda")
    best.load_state_dict(load_checkpoint(os.path.join(w, "full_best.pth"),
                                         "cuda"), strict=True)
    device_ms, trace_ms = _trace_busy(os.path.join(tmp, "profile",
                                                   "trace.json"))
    with open(os.path.join(runs, "full", "log.jsonl")) as f:
        epochs = [r for r in map(json.loads, f) if "epoch" in r]

    n_blocks, steps = best.num_residuals, nb["steps"]
    keys = ("psnr", "ssim", "lpips", "nlpd")
    if not (set(final) == {*keys, "val_psnr"}
            and all(np.isfinite(list(final.values())))):
        raise AssertionError(f"loop: final metrics {final}")
    n_ep = LOOP_CFG["epochs"]
    want = (n_ep * (8 * steps + 4 * nb["val"]) + 4 * nb["test"],
            n_blocks * (n_ep * (steps + nb["val"]) + nb["test"]), 0)
    if len(epochs) != n_ep or total != want:
        raise AssertionError(
            f"loop: {len(epochs)} epoch records; launches (K1, K2 nhwc, K2 "
            f"plane) {total}, expected {want}: K1 8 a step and 4 a val or "
            f"test batch, K2 nhwc {n_blocks} a step and a batch")
    host = part_ckpt["host"]
    if not (part.get("preempted")
            and (host["epoch"], host["batch"]) == (1, LOOP_PREEMPT - steps)):
        raise AssertionError(f"loop: preempted run {part}, host {host}")
    flat_full, flat_part2 = _flat(full_last), _flat(part2_last)
    diff = sorted(set(flat_full) ^ set(flat_part2)) or [
        k for k in flat_full if not _same(flat_full[k], flat_part2[k])]
    if diff:
        raise AssertionError(f"loop: resumed state differs from the "
                             f"uninterrupted one at {diff[:5]}")
    rel = max(abs(evald[k] - final[k]) / abs(final[k]) for k in keys)
    if not (rel <= LOOP_RTOL and evald["val_psnr"] == 0.0):
        raise AssertionError(f"loop: epochs-0 run {evald} vs {final}")
    n_tensors = sum(isinstance(t, torch.Tensor) for t in flat_full.values())
    gan = _loop_gan(w, runs, nb, n_blocks)
    rgan = _loop_gan(w, runs, nb, 0, RRDB_GAN_LOOP_CFG, "rgan")
    print(f"loop: train() AttentionSR x4 {n_blocks}x"
          f"{best.input_conv.out_channels} f32, synthetic "
          f"{LOOP_CFG['synthetic_size']} images, crop {LOOP_CFG['crop_size']}, "
          f"batch {LOOP_CFG['batch_size']} ({steps} steps, {nb['val']} val "
          f"batch of {nb['val_batch']}, {nb['test']} test batch of "
          f"{nb['test_batch']}), NLPD, EMA {LOOP_CFG['ema']}, {n_ep} epochs, "
          f"deterministic | final psnr {final['psnr']:.4f} ssim "
          f"{final['ssim']:.5f} lpips {final['lpips']:.6f} nlpd "
          f"{final['nlpd']:.6f} val_psnr {final['val_psnr']:.4f} | launches "
          f"(K1, K2 nhwc, K2 plane) {total} | best loads strict | preempted "
          f"after {LOOP_PREEMPT} updates (epoch 1 batch {host['batch']}) and "
          f"resumed: {n_tensors} tensors and the host state bit-equal | "
          f"epochs 0 from best: max rel {rel:.2g} | "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    numbers = {"epochs": [
        {"epoch": int(r["epoch"]), "images_per_s": r["time/images_per_s"],
         "train_s": r["time/train_s"], "step_ms": r["time/step_ms"],
         "loader_wait_ms": r["time/loader_wait_ms"],
         "loader_produce_ms": r["time/loader_produce_ms"],
         "wall_ms_per_step": r["time/train_s"] / steps * 1e3}
        for r in epochs],
        # one window of the preempted run (epoch 0, the profiler on): the
        # device's busy time over the trace's span
        "profiled_steps": LOOP_PROFILED,
        "profile_device_ms_per_step": device_ms / LOOP_PROFILED,
        "profile_wall_ms_per_step": trace_ms / LOOP_PROFILED,
        "busy_share": device_ms / trace_ms,
        "gan_epoch": gan["epoch"], "rrdb_gan_epoch": rgan["epoch"]}
    print("loop numbers: " + json.dumps(numbers), flush=True)
    return {"launches": {"K1": total[0], "K2 nhwc": total[1],
                         "K2 nchw": total[2]},
            "gan_launches": gan["launches"],
            "rrdb_gan_launches": rgan["launches"],
            "images_per_s": [r["time/images_per_s"] for r in epochs],
            "n_blocks": n_blocks,
            **kernels}


def _loop_gan(w: str, runs: str, nb: dict, n_blocks: int,
              base: dict = GAN_LOOP_CFG, tag: str = "gan") -> dict:
    """A GAN run of the loop phase (``base``: GAN_LOOP_CFG, or
    RRDB_GAN_LOOP_CFG with ``n_blocks`` 0, the SE squeezes of its G):
    train() uninterrupted, its launches counted from zero; then preempted
    after GAN_LOOP_PREEMPT updates and resumed, whose full-state
    checkpoint (G, D and the host state) must equal the uninterrupted
    run's bit for bit. Run names and checkpoints start with ``tag``."""
    from food101_sr_tpu_torch.ops import (blur_kernel, mean_nhwc_kernel,
                                          mean_plane_kernel)
    from food101_sr_tpu_torch.training import load_checkpoint, train

    t0 = time.perf_counter()
    cfg = {**base, "weights_dir": w}
    # ---- main path: one GAN train() run, counts from zero ----
    blur_kernel.launches = 0
    mean_nhwc_kernel.launches = mean_plane_kernel.launches = 0
    final = train({**cfg, "save_name": tag, "run_name": tag})
    total = (blur_kernel.launches, mean_nhwc_kernel.launches,
             mean_plane_kernel.launches)
    # ---- end of main path ----
    part = train({**cfg, "save_name": f"{tag}part", "run_name": f"{tag}part",
                  "preempt_after_updates": GAN_LOOP_PREEMPT})
    train({**cfg, "save_name": f"{tag}part2", "run_name": f"{tag}part2",
           "resume": os.path.join(w, f"{tag}part_last.pth")})
    full = _flat(load_checkpoint(os.path.join(w, f"{tag}_last.pth")))
    resumed = _flat(load_checkpoint(os.path.join(w, f"{tag}part2_last.pth")))
    with open(os.path.join(runs, tag, "log.jsonl")) as f:
        (epoch,) = [r for r in map(json.loads, f) if "epoch" in r]

    steps = nb["steps"]
    d_steps = len(range(0, steps, cfg["d_update_every"]))
    # K1 only in the test NLPD (a GAN run validates on the MAE); K2 in
    # every G forward: G steps, D steps (the fake), val and test batches
    want = (4 * nb["test"],
            n_blocks * (steps + d_steps + nb["val"] + nb["test"]), 0)
    if total != want:
        raise AssertionError(f"loop {tag}: launches (K1, K2 nhwc, K2 plane) "
                             f"{total}, expected {want}")
    if not (set(final) == {"psnr", "ssim", "lpips", "nlpd", "val_psnr"}
            and all(np.isfinite(list(final.values())))):
        raise AssertionError(f"loop {tag}: final metrics {final}")
    diff = sorted(set(full) ^ set(resumed)) or [
        k for k in full if not _same(full[k], resumed[k])]
    if not part.get("preempted") or diff or not any(
            k.startswith("/d/") for k in full):
        raise AssertionError(f"loop {tag}: preempted {part}, resumed state "
                             f"differs at {diff[:5]}")
    n_tensors = sum(isinstance(t, torch.Tensor) for t in full.values())
    print(f"loop {tag}: train() {cfg['architecture']} x4, loss gan, D nf=64 "
          f"every "
          f"{cfg['d_update_every']} batches ({d_steps} D steps), VGG19, "
          f"{cfg['epochs']} epoch of {steps} steps | final psnr "
          f"{final['psnr']:.4f} ssim {final['ssim']:.5f} lpips "
          f"{final['lpips']:.6f} nlpd {final['nlpd']:.6f} | launches (K1, "
          f"K2 nhwc, K2 plane) {total} | {epoch['time/images_per_s']:.1f} "
          f"images/s with the loader, step {epoch['time/step_ms']:.3f} ms "
          f"(D and G) | preempted after {GAN_LOOP_PREEMPT} updates and "
          f"resumed: {n_tensors} tensors (g, d) and the host state bit-equal"
          f" | {time.perf_counter() - t0:.1f} s", flush=True)
    return {"launches": {"K1": total[0], "K2 nhwc": total[1],
                         "K2 nchw": total[2]},
            "epoch": {"images_per_s": epoch["time/images_per_s"],
                      "train_s": epoch["time/train_s"],
                      "step_ms": epoch["time/step_ms"],
                      "loader_wait_ms": epoch["time/loader_wait_ms"],
                      "loader_produce_ms": epoch["time/loader_produce_ms"]}}


def _write_food_tree(root: str) -> None:
    """A Food-101-layout tree under root: FOOD_TRAIN + FOOD_TEST seeded
    images at FOOD_SHAPES, encoded by the port at FOOD_QUALITY."""
    from food101_sr_tpu_torch import native

    base = os.path.join(root, "food-101")
    os.makedirs(os.path.join(base, "meta"))
    rel = {"train": [], "test": []}
    for n in range(FOOD_TRAIN + FOOD_TEST):
        cls = ("pizza", "sushi", "ramen", "tacos")[n % 4]
        os.makedirs(os.path.join(base, "images", cls), exist_ok=True)
        h, w = FOOD_SHAPES[n % len(FOOD_SHAPES)]
        data = native.encode_jpeg_rgb8(
            jpeg_test_image(h, w, 1000 + n, noise=6), FOOD_QUALITY)
        name = f"{cls}/{2000000 + n}"
        with open(os.path.join(base, "images", name + ".jpg"), "wb") as f:
            f.write(data)
        rel["train" if n < FOOD_TRAIN else "test"].append(name)
    for split, names in rel.items():
        with open(os.path.join(base, "meta", f"{split}.txt"), "w") as f:
            f.write("\n".join(names) + "\n")


def _jpeg_fixtures() -> dict:
    """Part 1 of the food101 phase: the committed streams against the JAX
    package's decode digests, the CMYK refusal, both encode digests, and
    random region decodes against full-decode-then-crop."""
    from food101_sr_tpu_torch import native

    with open(os.path.join(JPEG_ASSETS, "goldens.json")) as f:
        goldens = json.load(f)
    checked = 0
    for name, g in goldens["streams"].items():
        with open(os.path.join(JPEG_ASSETS, g["file"]), "rb") as f:
            data = f.read()
        if "refused" in g:
            try:
                native.decode_image(data)
            except native.UnsupportedImage as e:
                if g["refused"] not in str(e):
                    raise AssertionError(f"{name}: refused as {e}")
                continue
            raise AssertionError(f"{name} decoded; expected a refusal "
                                 f"naming {g['refused']}")
        px = native.decode_image(data)
        if list(px.shape) != g["shape"] or sha256(px) != g["sha256"]:
            raise AssertionError(f"stream {name}: {px.shape} decode differs "
                                 "from the JAX package's")
        checked += 1
    for g in goldens["encode"]:
        img = jpeg_test_image(g["h"], g["w"], g["seed"])
        if sha256(native.encode_jpeg_rgb8(img, g["quality"])) != g["sha256"]:
            raise AssertionError(f"encode {g['w']}x{g['h']} q{g['quality']} "
                                 "differs from the JAX package's bytes")
    rng = np.random.default_rng(21)
    tree = os.path.join(JPEG_ASSETS, "food-101", "images")
    files = sorted(os.path.join(d, f) for d, _, fs in os.walk(tree)
                   for f in fs)
    files += [os.path.join(JPEG_ASSETS, g["file"])
              for g in goldens["streams"].values() if "refused" not in g]
    crops = 0
    for path in files:
        with open(path, "rb") as f:
            data = f.read()
        full = native.decode_jpeg_rgb8(data)
        h, w = full.shape[:2]
        for _ in range(max(1, FOOD_CROPS // len(files) + 1)):
            ch, cw = int(rng.integers(1, h + 1)), int(rng.integers(1, w + 1))
            y0 = int(rng.integers(0, h - ch + 1))
            x0 = int(rng.integers(0, w - cw + 1))
            got = native.decode_jpeg_crop_rgb8(data, x0, y0, cw, ch)
            if not np.array_equal(got, full[y0:y0 + ch, x0:x0 + cw]):
                raise AssertionError(f"{path}: region ({x0},{y0},{cw},{ch}) "
                                     "differs from full-decode-then-crop")
            crops += 1
    return {"goldens": goldens, "streams": checked,
            "encodes": len(goldens["encode"]), "crops": crops}


def phase_food101(tmp: str, loop: dict) -> dict:
    """The food101 phase (module docstring), in the loop phase's process
    after phase_loop: fixtures against the JAX package's goldens, the
    loader over the committed mini tree against JAX's batch digests,
    train() on a tree made here (the main path: launches counted from
    zero just around it), the train CLI with no --dataset, and the codec
    and loader numbers. ``loop`` is phase_loop's result (its synthetic
    images/s, for the same-process comparison)."""
    from food101_sr_tpu_torch import native
    from food101_sr_tpu_torch import train as cli
    from food101_sr_tpu_torch.data import Food101Source, SRDataLoader
    from food101_sr_tpu_torch.ops import (blur_kernel, mean_nhwc_kernel,
                                          mean_plane_kernel)
    from food101_sr_tpu_torch.training import train

    t0 = time.perf_counter()
    fx = _jpeg_fixtures()
    lg = fx["goldens"]["loader"]
    mini = Food101Source(JPEG_ASSETS, lg["split"])
    for mode, is_train in (("train", True), ("eval", False)):
        loader = SRDataLoader(mini, crop_size=lg["crop_size"],
                              batch_size=lg["batch_size"], train=is_train,
                              seed=lg["seed"], device="cuda",
                              num_workers=LOADER_THREADS)
        loader.set_epoch(0)
        got = [sha256(b.cpu().numpy()) for b in loader][:lg["batches"]]
        if got != lg[mode]:
            raise AssertionError(f"loader {mode} batches over the mini tree "
                                 "differ from the JAX package's")

    root = os.path.join(tmp, "food")
    _write_food_tree(root)
    src = Food101Source(root, "train")
    sample = src.bytes_at(0)
    (h, w), crop = FOOD_SHAPES[0], LOOP_CFG["crop_size"]
    if native.jpeg_dims(sample) != (w, h):
        raise AssertionError("the on-card tree's first image is not "
                             f"{w}x{h}")
    offs = itertools.cycle(np.random.default_rng(3).integers(
        0, min(h, w) - crop, (64, 2)).tolist())
    enc = {f"{g['w']}x{g['h']}": jpeg_test_image(g["h"], g["w"], g["seed"])
           for g in fx["goldens"]["encode"]}
    # host_us is host wall time per call; the codec runs on the host
    numbers = {
        "decode_full_ms": host_us(lambda: native.decode_jpeg_rgb8(sample),
                                  1, 50) / 1e3,
        "decode_crop_ms": host_us(lambda: native.decode_jpeg_crop_rgb8(
            sample, *next(offs), crop, crop), 1, 50) / 1e3,
        "encode_ms": {k: host_us(lambda img=img: native.encode_jpeg_rgb8(
            img, 90), 1, 20) / 1e3 for k, img in enc.items()},
        "jpeg_bytes": os.path.getsize(src.paths[0]),
    }
    loader = SRDataLoader(src, crop_size=crop, batch_size=LOOP_CFG["batch_size"],
                          train=True, seed=0, device="cuda",
                          num_workers=LOADER_THREADS)
    n_batches, t_load = 0, time.perf_counter()
    for epoch in range(3):
        loader.set_epoch(epoch)
        n_batches += sum(1 for _ in loader)
    torch.cuda.synchronize()
    numbers["loader_batches_per_s"] = n_batches / (time.perf_counter() - t_load)
    numbers["loader_threads"] = LOADER_THREADS

    nb = _loop_batches(FOOD_TRAIN, FOOD_TEST)
    os.environ["FOOD101_SR_RUN_DIR"] = runs = os.path.join(tmp, "runs")
    w_dir = os.path.join(tmp, "weights")
    cfg = {**LOOP_CFG, "dataset": "food101", "data_root": root,
           "weights_dir": w_dir, "save_name": "food", "run_name": "food"}
    # ---- main path: train() on Food-101 JPEGs, counts from zero ----
    blur_kernel.launches = 0
    mean_nhwc_kernel.launches = mean_plane_kernel.launches = 0
    final = train(cfg)
    total = (blur_kernel.launches, mean_nhwc_kernel.launches,
             mean_plane_kernel.launches)
    # ---- end of main path ----
    n_blocks, n_ep = loop["n_blocks"], cfg["epochs"]
    want = (n_ep * (8 * nb["steps"] + 4 * nb["val"]) + 4 * nb["test"],
            n_blocks * (n_ep * (nb["steps"] + nb["val"]) + nb["test"]), 0)
    if total != want:
        raise AssertionError(f"food101: launches (K1, K2 nhwc, K2 plane) "
                             f"{total}, expected {want}: K1 8 a step and 4 a "
                             f"val or test batch, K2 nhwc {n_blocks} a step "
                             "and a batch")
    if not (set(final) == {"psnr", "ssim", "lpips", "nlpd", "val_psnr"}
            and all(np.isfinite(list(final.values())))):
        raise AssertionError(f"food101: final metrics {final}")
    with open(os.path.join(runs, "food", "log.jsonl")) as f:
        epochs = [r for r in map(json.loads, f) if "epoch" in r]
    if len(epochs) != n_ep:
        raise AssertionError(f"food101: {len(epochs)} epoch records")

    if cli.build_parser().parse_args([]).dataset != "food101":
        raise AssertionError("the train CLI's default dataset is not food101")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_out = cli.main(["--data_root", root, "--subset",
                            str(FOOD_CLI_SUBSET), "--epochs", "1",
                            "--weights_dir", w_dir, "--save_name", "cli",
                            "--run_name", "cli", "--use_wandb", "false"])
    if not (set(cli_out) == {"psnr", "ssim", "lpips", "nlpd", "val_psnr"}
            and all(np.isfinite(list(cli_out.values())))):
        raise AssertionError(f"food101 CLI: {cli_out}")

    numbers.update(
        train_images_per_s=[r["time/images_per_s"] for r in epochs],
        synthetic_images_per_s=loop["images_per_s"],
        train_step_ms=[r["time/step_ms"] for r in epochs],
        loader_wait_ms=[r["time/loader_wait_ms"] for r in epochs],
        loader_produce_ms=[r["time/loader_produce_ms"] for r in epochs],
        final=final, cli=cli_out, launches=list(total))
    print(f"food101: {fx['streams']} streams decode to the JAX package's "
          f"digests, CMYK refused by name, {fx['encodes']} encodes byte-equal, "
          f"{fx['crops']} region decodes equal full-then-crop | loader over "
          f"the mini tree: {lg['batches']} train and {lg['batches']} eval "
          f"batches equal JAX's | train() AttentionSR x4 on {FOOD_TRAIN} + "
          f"{FOOD_TEST} JPEGs ({nb['steps']} steps of "
          f"{LOOP_CFG['batch_size']}, crop {crop}, {n_ep} epochs): launches "
          f"(K1, K2 nhwc, K2 plane) {total}, final psnr {final['psnr']:.4f} "
          f"| images/s with the loader {numbers['train_images_per_s']} "
          f"(synthetic, same process: {loop['images_per_s']}) | decode "
          f"{w}x{h} 4:2:0 {numbers['decode_full_ms']:.3f} ms, 200^2 crop "
          f"{numbers['decode_crop_ms']:.3f} ms | encode q90 "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in
                      numbers["encode_ms"].items())
          + f" | loader alone {numbers['loader_batches_per_s']:.2f} batches/s "
          f"({LOADER_THREADS} threads) | CLI (no --dataset, SRCNN, subset "
          f"{FOOD_CLI_SUBSET}) psnr {cli_out['psnr']:.4f} | "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print("food101 numbers: " + json.dumps(numbers), flush=True)
    return {"K1": total[0], "K2 nhwc": total[1], "K2 nchw": total[2]}


def run_loop_phase() -> dict:
    """Phases 12 and 13 in a child process of its own, which alone gets the
    determinism environment; its results come back through a file in a
    temporary directory that also holds its runs and weights."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_loop_") as tmp:
        env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": LOOP_CUBLAS}
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--loop", tmp], env=env, timeout=900).returncode
        if rc != 0:
            raise RuntimeError(f"the loop phase exited with {rc}")
        with open(os.path.join(tmp, "loop.json")) as f:
            return json.load(f)


def loop_main(tmp: str) -> int:
    """Entry of the loop phase's child process (see run_loop_phase)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    out = phase_loop(tmp)
    out["food101_launches"] = phase_food101(tmp, out)
    with open(os.path.join(tmp, "loop.json"), "w") as f:
        json.dump(out, f)
    return 0


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
        server.warmup()  # cuDNN picks its algorithms per bucket (tile, win)
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
    http_launches, k2_tta = phase_http(rates)
    for d, key in ((k1, "K1"), (k2_nhwc, "K2 nhwc"), (k2_nchw, "K2 nchw")):
        d["http_launches"] = http_launches[key]
    k1_train, k2_train = phase_train(rates)
    k2_gan = phase_gan(rates)
    gens = phase_generators()
    for d, key in ((k1_train, "K1"), (k2_train, "K2 nhwc"),
                   (k2_nchw, "K2 nchw")):
        d["generator_launches"] = {a: g["launches"][key]
                                   for a, g in gens.items()}
    loop = run_loop_phase()
    for d, key in ((k1, "K1"), (k2_nhwc, "K2 nhwc"), (k2_nchw, "K2 nchw")):
        d["loop_launches"] = loop["launches"][key]
        d["gan_loop_launches"] = loop["gan_launches"][key]
        d["rrdb_gan_loop_launches"] = loop["rrdb_gan_launches"][key]
        d["food101_loop_launches"] = loop["food101_launches"][key]
    for d, key in ((k1, "K1"), (k2_nhwc, "K2 nhwc")):
        d["loop_max_abs_err"] = loop["max_abs_err"][key]
        d["at_loop_val"] = loop["at_val"][key]
    keys = ("name", "route", "source", "replaces", "launches",
            "http_launches", "loop_launches", "gan_loop_launches", "generator_launches",
            "rrdb_gan_loop_launches", "food101_loop_launches", "max_abs_err",
            "loop_max_abs_err", "ms", "device_ms", "host_us", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "wrapper", "at", "at_64",
            "at_loop_val", "half_device_ms", "nchw_copy_ms",
            "nchw_copy_device_ms", "step_ms", "g_step_ms", "d_step_ms",
            "images_per_s", "peak_bytes", "device_split_ms")
    kernels = [{k: d[k] for k in keys if k in d}
               for d in (k1, k2_nhwc, k2_nchw, k2_tta, k1_train, k2_train,
                         k2_gan)]
    print(f"done: elapsed_s {time.perf_counter() - t_start:.1f} | {smi}",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--loop"]:
        sys.exit(loop_main(sys.argv[2]))
    sys.exit(main())
