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
          weights, bf16, channels-last, the phase-space upsample tail:
          SRServer's default, as in the JAX server) serves 64x64 requests from 16
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
          request and response; one upload of each decoder the JAX
          server has and the port once answered 415 (arithmetic-coded
          baseline and progressive, CMYK, YCCK and lossless JPEG, 16-bit
          and Adam7-interlaced PNG, GIF, BMP, and WebP: lossy with the
          simple filter, 8 partitions, 4 segments, lossless with and
          without a palette, alpha raw and coded, ICC and EXIF, an
          animation; TIFF: LZW with predictor 2, tiled Deflate, JPEG
          YCbCr 4:2:0 with JPEGTables and PIL's RGB JPEG, PackBits
          palette, G4, G3 2-D, Modified Huffman, 16-bit RGB big-endian,
          separate planes, BigTIFF, CMYK, LZMA, a float with predictor
          3, YCbCr LZW through libtiff's RGBA reader, Orientation 6;
          binary and plain PPM, 16-bit PGM, PFM, ICO with PNG and with
          BMP entries, CUR, QOI: assets/jpeg/streams/), each 200, one device batch
          (K2 NHWC launched once per block), decoded to the JAX server's
          digest and answered with the PNG of SRServer.upscale byte for
          byte, with each class's decode ms on the host ("codec
          numbers:" line); /healthz
          "jpeg": true; the SRCNN asset's responses (TF32 off) within 1 level of the
          JAX package's goldens, and its bf16 distance; a --tta server's
          responses within 1 level of the eight dihedral forwards averaged
          by hand; predict.main on 16 64x64 PNGs, a tiled one and a
          WebP, every output equal to upscale's; a shutdown with 4
          requests inside their handlers answers each; 404, 413, 400
          (truncated body), 400 (truncated JPEG, broken WebP and cut
          TIFF, which PIL refuses, and JBIG2 and HEIC headers, which no
          PIL plugin takes) and 415 (a ZSTD TIFF, which PIL
          decodes, and a PSD, each named); then K2 NHWC at the
          --tta forwards' shape
          (32,96,64,64) bf16 against its plain version, with its times
8b. winner  the trained AttentionSR x4 winner, the committed asset
          (food101_sr_tpu_torch/assets/winner_attentionsr.pth, 5,842,630
          parameters) held against the JAX package's goldens for it
          (tools/export_port_assets.py --what attentionsr): the handler of
          ``serve --architecture auto --checkpoint <asset> --warmup
          --dtype float32`` in this process, TF32 off, answers the five
          golden LR inputs as PNG uploads (four small: the mini tree's
          test images; one 200x152, tiled), each within 1 level of JAX's
          float32 output; the four scored on the card (their HRs rebuilt
          from the committed JPEGs by the port's decoder): PSNR, SSIM,
          LPIPS and NLPD against JAX's, and LPIPS and NLPD against the CPU
          calculator's; a bf16 server and a bf16 --quantize int8 server:
          their PSNR costs against the port's own float32 PSNR beside
          JAX's, and the int8 SNR; predict on the five PNGs byte-equal to
          the server's responses; export_serving of the asset at 64x64
          (bf16, --check), its program from load_bucket byte-equal to the
          eager bf16 forward on the small inputs' tiles; the README's GAN
          fine-tune and the RUNBOOK's QAT fine-tune (train
          --pretrained_weights <asset> on the mini tree, one epoch each):
          the generator before the first step equal to the asset bit for
          bit, every logged loss finite, nothing skipped; visualize's
          default table (the SRCNN, ResNetSR and AttentionSR assets; the
          absent winners' rows skipped); K2 NHWC on the trained net's bf16 SE
          inputs and K1 on the scoring pyramids against their plain
          versions, with times ("winner numbers:" line). Then the same
          serve, score and cost checks on the trained ResNetSR x4 winner
          and its QAT fine-tune (assets/winner_resnet.pth and
          winner_resnet_qat.pth, 1,549,462 parameters, BatchNorm running
          stats included; tools/export_port_assets.py --what resnet), the
          int8 cost within WINNER_RESNET_INT8_DB of JAX's and both nets'
          int8 costs printed side by side; predict and the exported
          64x64 program for the plain one; the README's QAT fine-tune
          from it (train --architecture RESNET --quantize qat, NLPD, lr
          1e-5), K1 launches as the closed form; K2 0 on every ResNetSR
          batch; visualize's default table with its RESNET row; K1 on
          the ResNetSR scoring pyramids against its plain version
9. train  the supervised step on the registry AttentionSR x4 (float32,
          channels-last, the phase-space tail as train() runs it, train
          mode), NLPD loss, Adam 4e-4, batch 16 of
          seeded 200x200 uint8 crops made on the device: one step's raw
          gradients on 2 crops against the CPU's plain path (TF32 off),
          with the phase tail and with the materialized one;
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
11b. bf16 bf16 training with float32 master weights: K1 on a bf16
          prediction's own pyramid (cast to float32 around the kernel) and
          the NHWC K2 entry at the bf16 step's SE input (16,96,50,50) bf16
          channels-last, forward and through its backward, against their
          plain versions, with times; then SRCNN, ResNetSR, AttentionSR and
          RRDB at registry size (phase tail, channels-last, NLPD, Adam 4e-4,
          batch 16 of 200 px crops on the device): one bf16 step's raw
          gradients on 2 crops against the card's float32 step with TF32
          off (BF16_GRAD_TOL of each leaf's term sum), then the float32 and
          the bf16 step each timed (2 + 5 steps under CUDA events, the
          loss falling on one batch), the first timed step's launches
          against the closed form (a float32 step K1 8; a bf16 step K1 12:
          pred's own pyramid; K2 nhwc 32 for AttentionSR), a profile of 2
          steps for the busy share, peak memory, the parameters and Adam's
          moments float32; then one bf16 GAN D step and G step (AttentionSR,
          D nf=64, VGG19 seeded) against their float32 twins on the card,
          as run (BF16_GAN_TOL; the activation elements on the other
          branch counted) and with the float32 steps' branches applied
          (BF16_GRAD_TOL)
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
          decode to the JAX package's digests (decode_jpeg_rgb8 to its
          binding's, arithmetic-coded, CMYK/YCCK, block-smoothed,
          truncated and lossless JPEG included; decode_image to its
          server's, PNG, GIF, BMP and every WebP included, each lossy
          WebP's Y/U/V planes to libwebp's), the truncated, 12-bit,
          hierarchical and past-64-KiB arithmetic uploads are refused as
          it refuses them (a JPEG cut before its EOI decodes where PIL's
          does), committed regions equal
          its region decodes, two encodes hash to JAX's bytes, random
          region decodes equal full-decode-then-crop, and SRDataLoader's
          first two train and eval batches over the committed mini
          Food-101 tree (an arithmetic-coded and a CMYK image among its
          train images) hash to JAX's; then a Food-101-layout tree of 96 + 24
          seeded 512x384 and 384x512 images, encoded by the port at q92,
          is written to a temporary directory and train() runs on it with
          the loop phase's settings (K1 8 per step and 4 per val or test
          batch, K2 NHWC 32 per step and batch: the main path, counts
          from zero around it); the train CLI runs once with no --dataset
          (SRCNN, --subset 0.25). Prints decode ms (full 512x384, 200^2
          crop, a 512x384 lossy WebP), encode ms (256^2, 800x608), the
          loader's batches/s alone
          (8 threads) and train()'s images/s beside the synthetic run's
13b. caches in the loop phase's process after phase 13: train(dtype=
          "bfloat16") for one epoch of the loop's settings (K1 12 a step, 8
          a val batch, 4 a test batch; its best checkpoint float32, loading
          strictly into the float32 registry model); each cache's eval
          batches byte-equal to SRDataLoader's on the on-card JPEG tree, and
          train crops windows of their canvases; then train() on that tree
          with cache_device, cache_host (twice: the second run opens the
          store; the setup ms of both), cache_host with cache_host_reuse 4,
          and cache_device in bf16, each with its launches against the
          closed form and its images/s and loader wait beside the
          SRDataLoader run of phase 13; the cache_device and the window runs
          preempted after 3 updates and resumed, bit-equal to the
          uninterrupted runs' full-state checkpoints
14. tail  the phase-space upsample tail: ResNetSR, AttentionSR and RRDB
          x4 at registry size (seeded, channels-last) with phase_tail on
          and off on the same weights, batch 8 at 64^2 and 224^2, in
          float32 (TF32 off; within 1 level of each other) and bf16: the
          levels between the two, each forward's ms and the tail's alone
          (CUDA events); the bf16 AttentionSR's channels-last against its
          NCHW twin with either tail (ROADMAP fault 2)
15. quant int8 serving and QAT: the int8 GEMM's int32 accumulators on the
          card bit-equal to the CPU's at every body
          conv shape of the three nets; SRServer(arch, quantize="int8")
          for each net in bf16, 16 64x64 requests from 8 threads within
          1 level of a direct int8 forward, and its int8-vs-bf16 SNR on 8
          seeded HR images; ``serve --quantize int8`` over HTTP (32 64x64
          PNGs, images/s and p50/p95, each response equal to upscale);
          ``predict --quantize int8`` on 4 PNGs; forward ms at 8 x 224^2
          in int8, int8_dot and bf16; one QAT step against the float
          step (AttentionSR, phase tail, batch 16 of 200^2): raw
          gradients on 2 crops against the CPU's plain path, once with
          the CPU's int8 levels and PReLU branches made in the card's
          forward (float rounding alone) and once without (the choices
          that differ are counted), ms, K1 8 and
          K2 nhwc 32 a step, the loss falling on one batch; then
          train(quantize="qat") for one epoch of the loop's settings, its
          launches against the closed form and its losses finite
16. dp    multi-GPU paths, after the quant phase: the one-process step
          of registry AttentionSR x4 and ResNetSR on 2 crops (TF32 off,
          term sums on the card) is saved; two child processes
          (``chip_smoke.py --dp RANK PORT DIR``) form a group from the
          explicit flags on the one card (gloo: NCCL refuses two ranks on
          one device) and each holds K1 and K2 at its shapes against their
          plain versions, steps on its crop, averages the gradients and
          holds them against the one-process step (and ResNetSR's global
          BatchNorm running stats), times its step at a global batch of
          16 of 200^2 (8 a rank: step ms, the gradient all-reduce alone,
          peak memory, K1 8 and K2 32 a step); then train() of AttentionSR
          on both ranks (crop 96, global batch 4, 18 updates an epoch),
          uninterrupted (counted from zero), preempted on rank 0 alone at
          update 10 (both ranks stop after update 16, the first
          agreement) and resumed bit-equal, one checkpoint writer and one
          log; a third child (``--dp-one PORT DIR``) runs the same train()
          alone and from the flags of a group of one under NCCL, bit-equal,
          and gives the one-rank images/s; here, halo_sharded_apply and
          tiled_forward_for of the registry AttentionSR over a mesh of
          cuda:0 four times, float32 with TF32 off, within 1 level of the
          whole image, K2 at the halo windows' shape, and
          SRServer(use_mesh=True) bit-equal to the plain server
17. bench the port's bench: ``python -m food101_sr_tpu_torch.bench`` in a
          child at its defaults (AttentionSR x4 bf16 inference, batch 256
          of 50^2, the standard tail's provisional line, then the phase
          tail's result line, which must name
          attentionsr_x4_inference_throughput with a positive value and
          vs_baseline null); K1 at the bf16 train step's pyramids
          (128,3,{200,100,50,25}^2) and K2 NHWC at the bench's SE inputs,
          (256,96,50,50), (128,96,50,50) and (32,96,48,48) bf16
          channels-last, against their plain versions, with times; then,
          in this process and counted from zero, the bench's legs at its
          full batches and shapes with fewer calls: inference, --train,
          --gan and --input of AttentionSR, and --train of RRDB in the
          split and concat dense layouts in turns (ms per step, peak
          memory); every leg's launches per call against BENCH_PER_CALL;
          how many host syncs one bench train step makes; and the remat
          leg in a child of its own (``chip_smoke.py --remat DIR``, the
          loop phase's determinism): AttentionSR's float32 step with
          remat on and off, gradients, step ms, peak memory and launches
          (K2 64 a step with remat: each block's forward runs again)
18. aot   the AOT serving artifact and the offline tools:
          ``export_serving.main`` (``--check``) writes the registry
          AttentionSR x4 (seeded, bf16, phase tail) as torch.export
          programs at the server's two buckets (64^2 and the tiled path's
          224^2 window) with 8 rows, and at 64^2 under --tta; the manifest
          has JAX's keys (torch_version, ops_module); a child
          (``chip_smoke.py --aot DIR``) loads each program through
          ``load_bucket`` without any model, server or training module,
          holds it byte-equal to this process's live forward_u8 on seeded
          inputs, with the K2 op 32 times in its graph (64 under --tta)
          and K2 NHWC launched as often by one call; exported and eager
          forward ms per bucket in turns; K2 through its registered op at
          the three programs' SE shapes against its plain version, with
          times; nlpd_loss_train on 16 pairs of 200^2 against its CPU run
          (value, input gradient), K1 8 launches (forward and backward),
          K1 at its pyramid (32,3,{200..25}^2) with times; visualize on 8
          synthetic images (the SRCNN asset, a seeded AttentionSR .pth):
          the report's PNGs, the latency table, K2 32 per AttentionSR
          forward; sweep of 2 trials of 1 epoch of AttentionSR on
          synthetic data with loss_function "nlpd" (launches against the
          closed form); generate_model_vis of AttentionSR (32 K2 op nodes
          in its graph, its FLOPs, K2 32 launches) and analyze_models
19. done  the kernels' JSON line and the elapsed time

Kernel launch counts (one per entry point) are zeroed just before each
main path and read just after it: serving (the serve and score phases:
K2 32 per device batch, all through the NHWC entry, and K1 4 for the one
NLPD call), the http phase (K2 NHWC 32 per device batch of the zoo and
of predict's server, 64 per --tta device batch, K1 0: ``http_launches``;
the --tta requests' alone on K2's TTA-shape row), the winner phase's
runs (``winner_launches``: the float32 server's HTTP round with its
scoring, K2 NHWC 32 per device batch and K1 4 per NLPD call; the bf16
and int8 servers; predict; one exported program call; the two
fine-tunes; visualize; per run in ``winner numbers:``), one train step (K1 4
forward and 4 backward, K2 NHWC 32, K2 plane 0), one GAN D step and one G step (K2 NHWC 32 each, K1 0), one
train step of each of the other generators (K1 8, K2 0:
``generator_launches``), the uninterrupted train() runs of the loop
phase, NLPD (``loop_launches``), GAN (``gan_loop_launches``) and RRDB GAN
(``rrdb_gan_loop_launches``), train() on Food-101 JPEGs
(``food101_loop_launches``), the tail phase's forwards (K2 nhwc 32 per
AttentionSR forward: ``tail_launches``), int8 serving (the three int8
servers, the HTTP round and predict: ``quant_serve_launches``) and
train(quantize="qat") (``qat_loop_launches``), one bf16 train step of
each generator (``bf16_launches``) and the loop child's bf16 and cache
runs (``bf16_loop_launches``, ``cache_device_loop_launches``,
``cache_host_loop_launches``, ``cache_host_reopened_loop_launches``,
``cache_host_reuse_loop_launches``, ``bf16_cache_device_loop_launches``),
each dp rank's uninterrupted train() (``dp_launches``), the halo-sharded
forward (K2 NHWC 32 per window: ``halo_launches``) and the bench phase's
legs in this process (``bench_launches``; per shape on its own rows) and
the aot phase's runs (``aot_launches``: each exported program's one call
in the child, nlpd_loss_train with its backward, visualize, the sweep's
trials, generate_model_vis; the programs' K2 and K1 under
nlpd_loss_train on rows of their own).
The last line is the JSON device record;
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
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import warnings

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
# utils/term_sums.py says why not of the gradient's own max abs)
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
# the bf16 phase: each registry generator's bf16 step (float32 master
# weights) beside its float32 step, BF16_WARMUP + BF16_TIMED steps each and
# a profile of BF16_PROFILED; one bf16 step's raw gradients on GRAD_BATCH
# crops held against the card's own float32 step (TF32 off), per leaf over
# its largest sum of absolute terms (utils/term_sums.py, from the float32
# pass), within BF16_GRAD_TOL; the GAN steps as they run within
# BF16_GAN_TOL. Both bounds live in utils/term_sums.py, which says how
# tests/test_torch_bf16.py calibrates them
BF16_ARCHS = ("SRCNN", "RESNET", "AttentionSR", "RRDB")
BF16_WARMUP, BF16_TIMED, BF16_PROFILED = 2, 5, 2
# the loop child's bf16 and cache runs (phase_caches): the cache_device
# and window runs preempted after CACHE_PREEMPT updates and resumed; the
# keys of the runs' launches in the kernels line
CACHE_PREEMPT = 3
CACHE_LAUNCH_KEYS = {"bf16": "bf16_loop_launches",
                     "cdev": "cache_device_loop_launches",
                     "chost": "cache_host_loop_launches",
                     "chost2": "cache_host_reopened_loop_launches",
                     "cwin": "cache_host_reuse_loop_launches",
                     "bf16cdev": "bf16_cache_device_loop_launches"}
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
# the winner phase: the trained AttentionSR x4 winner (the committed asset
# and the JAX package's goldens for it, tools/export_port_assets.py --what
# attentionsr): WINNER_SMALL small inputs (the mini tree's test images,
# their HRs rebuilt here) and one tiled one. The port's float32 server
# within LEVEL_TOL of JAX's float32 outputs on all five; on the small ones
# its scores within WINNER_PSNR_DB (dB) and WINNER_SSIM of JAX's, LPIPS
# and NLPD within WINNER_RTOL relative, and the PSNR costs of its bf16 and
# its int8 server (each the mean of the per-image gaps to the port's own
# float32 PSNR) within WINNER_BF16_DB and WINNER_INT8_DB of JAX's costs.
# The port's CPU servers against the same goldens measured: PSNR 2.7e-5
# dB, SSIM 1.5e-5, LPIPS 2.8e-5 and NLPD 1.2e-5 relative; the bf16 cost
# 0.0427 dB against JAX's 0.0363 (0.0064 apart), int8 0.1325 against
# 0.1213 (0.0112 apart); int8 SNR 42.68 dB against JAX's 42.02
WINNER_SMALL = 4
WINNER_PSNR_DB, WINNER_SSIM, WINNER_RTOL = 0.01, 1e-4, 1e-3
WINNER_BF16_DB, WINNER_INT8_DB = 0.05, 0.02
# the ResNetSR winners' int8 cost against JAX's: the bound
# tests/test_torch_phase_tail.py holds the QAT winner's int8 forward to
# (its trained weights put rounding ties on the int8 grid, which float32
# sums in another order resolve differently)
WINNER_RESNET_INT8_DB = 0.05
# the README's GAN fine-tune and the RUNBOOK's QAT fine-tune from the
# AttentionSR winner, and the README's QAT fine-tune from the ResNetSR one
# (NLPD, the default loss), one epoch of the mini tree each (16 train
# images: 14 train, 2 val; 4 test) at WINNER_BATCH crops of WINNER_CROP
# px; visualize on WINNER_VIS synthetic images
WINNER_TUNES = {"gan": ["--loss_function", "gan", "--lr", "1e-4"],
                "qat": ["--loss_function", "mae", "--quantize", "qat",
                        "--lr", "1e-4"],
                "resnet_qat": ["--quantize", "qat", "--lr", "1e-5"]}
WINNER_BATCH, WINNER_CROP, WINNER_VIS = 4, 200, 4
# the winners, each the asset winner_<name>.pth: its architecture, its
# goldens (file and key prefix; every winner's LR inputs are the
# AttentionSR goldens'), its int8 cost bound, its fine-tunes and whether
# its 64x64 program is exported
WINNERS = {
    "attentionsr": {"arch": "AttentionSR",
                    "goldens": ("winner_attentionsr_goldens.npz", ""),
                    "int8_db": WINNER_INT8_DB, "tunes": ("gan", "qat"),
                    "export": True},
    "resnet": {"arch": "RESNET",
               "goldens": ("winner_resnet_goldens.npz", "resnet_"),
               "int8_db": WINNER_RESNET_INT8_DB, "tunes": ("resnet_qat",),
               "export": True},
    "resnet_qat": {"arch": "RESNET",
                   "goldens": ("winner_resnet_goldens.npz", "resnet_qat_"),
                   "int8_db": WINNER_RESNET_INT8_DB, "tunes": (),
                   "export": False},
}

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

# the tail phase: the three post-upsampling nets at registry size with the
# phase-space tail on and off (the same seeded weights), TAIL_BATCH images
# at each of TAIL_SIDES LR px, float32 with TF32 off and bf16; forwards and
# the tail alone timed over TAIL_ITERS calls; the phase tail's float32
# output within TAIL_F32_RTOL of the materialized one's peak (sums in
# another order; uint8 levels say little here: the seeded ResNetSR's
# BatchNorms at running stats 0 and 1 give outputs in the thousands)
TAIL_ARCHS = ("AttentionSR", "RESNET", "RRDB")
TAIL_SIDES, TAIL_BATCH, TAIL_ITERS, TAIL_F32_RTOL = (64, 224), 8, 5, 1e-5
# the quant phase: the int8 GEMM's accumulators on the card against the
# CPU's at every body conv shape of the three nets (cin -> cout at
# QUANT_BATCH x 64^2); each net served in int8 (QUANT_REQUESTS 64x64
# requests from HTTP_THREADS threads, within LEVEL_TOL of a direct int8
# forward) and its int8-vs-bf16 SNR on QUANT_HR seeded HR images; one
# HTTP round of HTTP_REQUESTS through ``serve --quantize int8``;
# predict --quantize int8 on QUANT_PREDICT PNGs; forwards at QUANT_BATCH
# x QUANT_SIDE^2 in int8, int8_dot and bf16; train(quantize="qat") at the
# loop's settings for one epoch; one QAT step and one float step, timed
# over GEN_WARMUP + GEN_TIMED steps
QUANT_SHAPES = {"AttentionSR": ((96, 96),), "RESNET": ((64, 64),),
                "RRDB": ((64, 32), (96, 32), (128, 32), (160, 32),
                         (192, 64))}
QUANT_BATCH, QUANT_SIDE, QUANT_REQUESTS, QUANT_HR = 8, 224, 16, 8
QUANT_PREDICT = 4
QAT_LOOP_CFG = {**LOOP_CFG, "quantize": "qat", "epochs": 1}
# the QAT step's raw gradients on GRAD_BATCH crops, card against CPU, per
# leaf over its largest sum of absolute terms (term_sums, on the
# fake-quantized inputs), twice. First with the CPU's discrete choices
# made in the card's forward (_decisions: each activation's int8 levels
# and each PReLU element's branch): the two sides then differ by float
# rounding alone and are held to GRAD_TOL, as the float step is; a
# backward left to TF32 or a fake-quant the card skipped fails there.
# Then each side on its own choices: fake-quant rounds every body conv's
# input to a grid of 255 levels per sample, so a float32 difference of an
# ulp moves a value that sits on a rounding boundary by a whole step
# (1/127 of the sample's range), a PReLU input near 0 can take the other
# branch, and the steps spread through the later layers. That run is held
# to QAT_GRAD_TOL, and beyond GRAD_TOL only where some of the card's
# choices differ from the CPU's (counted). Runs on an H100 80GB HBM3
# measured 3.6e-6 of a term sum with the choices shared and 3.6e-3
# without (and 2.4e-2 to 3.8e-2 of a leaf's max abs, at PReLU slopes: g*x
# summed over every negative activation of a layer cancels far below its
# terms)
QAT_GRAD_TOL = 2e-2
# the dp phase: data-parallel training in DP_RANKS processes of their own
# on the one card (two ranks share it, so the backend is gloo: NCCL refuses
# two ranks on one device). The step check: DP_ARCHS at registry size, one
# step's raw gradients on GRAD_BATCH crops (one per rank), averaged over the
# ranks, against the one-process step on the same crops (TF32 off), with
# the one-process forward's activation branches (ReLU, PReLU: each input's
# sign) applied, within GRAD_TOL of each leaf's term sum (ResNetSR:
# GRAD_TOL of the term sum or G_GRAD_TOL of the max abs, as the
# generators phase); as run, within GRAD_TOL of a term sum, or
# DP_AS_RUN_TOL where some input next to 0 took the other branch at the
# other batch split (runs on an H100 80GB HBM3 read 1.0e-4, AttentionSR,
# and 8.5e-4, ResNetSR, with 5-6 elements flipped per rank); K1 and K2
# at the shapes of each rank's step and train(); ResNetSR's running stats
# within BUF_TOL; then each rank's step at a global batch of
# DP_STEP_BATCH crops of TRAIN_CROP (DP_WARMUP + DP_TIMED steps under CUDA
# events), its gradient all-reduce alone, its peak memory and launches.
# train() on the ranks: DP_LOOP_CFG (80 images: 72 train, 18 updates of a
# global 4 an epoch, at least the agreement's 16; 8 val images, 2 batches;
# 20 test images, 5 batches), uninterrupted, then preempted on rank 0 alone
# after DP_PREEMPT updates (both ranks stop after update 16, the first
# agreement), then resumed
DP_RANKS, DP_ARCHS = 2, ("AttentionSR", "RESNET")
DP_AS_RUN_TOL = 4e-3
DP_STEP_BATCH, DP_WARMUP, DP_TIMED, DP_ALLREDUCE = 16, 2, 5, 5
DP_LOOP_CFG = dict(dataset="synthetic", architecture="AttentionSR",
                   synthetic_size=80, crop_size=96, batch_size=4,
                   loss_function="nlpd", lr=4e-4, ema=0.999, epochs=1, seed=0,
                   log_every=1, use_wandb=False)
DP_PREEMPT, DP_SYNC = 10, 16
# the spatial paths over a local mesh of the card DP_MESH times (JAX's
# tests pass virtual CPU devices the same way): halo_sharded_apply of the
# registry AttentionSR on a DP_HALO_SHAPE LR image (slabs of 160 x 160, 2 *
# its halo of 80 rows), tiled_forward_for at DP_TILED_SHAPE (tile DP_TILE,
# the largest that divides both sides), float32 with TF32 off, each within
# LEVEL_TOL of the whole-image forward; SRServer(use_mesh=True) at
# max_batch DP_MESH * 2 against the plain server at 2 rows, bit for bit.
# AttentionSR's SE blocks squeeze each window's mean, so a window's output
# depends on the window, the less the more pixels it holds: on the CPU
# (seeded registry weights) 640 x 160 reads 1 level from the whole image,
# 640 x 32 reads 2; the narrow image's levels are printed, not held
DP_MESH, DP_TILED_SHAPE, DP_TILE = 4, (200, 152), 8
DP_HALO_SHAPE, DP_HALO_NARROW = (640, 160), (640, 32)
DP_SERVE_REQUESTS = 16
# the bench phase: ``python -m food101_sr_tpu_torch.bench`` once at its
# defaults in a child (BENCH_CLI_TIMEOUT s), then the bench's legs in this
# process at its full batches and shapes with BENCH_N calls (short, long)
# and BENCH_REPEATS run each; RRDB's train leg in both dense layouts, in
# the turns of RRDB_TURNS, at each batch of RRDB_AB_BATCHES (the bench's
# and the loop's); BENCH_PER_CALL the launches (K1, K2 nhwc, K2 nchw) of
# one call of each leg. The remat leg (a child of its own, under
# the loop phase's determinism): the registry AttentionSR's float32 step
# at TRAIN_BATCH crops of TRAIN_CROP with remat on and off on the same
# weights and crops, its gradients bit-equal or within GRAD_TOL of each
# leaf's term sum, REMAT_WARMUP + REMAT_TIMED steps each under CUDA events
BENCH_N, BENCH_REPEATS, BENCH_CLI_TIMEOUT = (2, 6), 1, 420
RRDB_TURNS = ("split", "concat", "concat", "split", "split", "concat")
RRDB_AB_BATCHES = (128, TRAIN_BATCH)
BENCH_PER_CALL = {"infer": (0, 32, 0), "train": (12, 32, 0),
                  "gan G": (0, 32, 0), "gan D": (0, 32, 0),
                  "input": (0, 0, 0), "rrdb": (12, 0, 0)}
REMAT_WARMUP, REMAT_TIMED = 2, 5
# the aot phase: export_serving of the registry AttentionSR x4 (seeded,
# bf16, phase tail) at the server's two buckets (its tile and the tiled
# path's window) with AOT_BATCH rows, and at the tile under --tta, each
# checked by the CLI's --check; a child (``chip_smoke.py --aot DIR``)
# loads every program without the model code and holds it byte-equal to
# this process's live forward_u8 on seeded inputs; exported and eager
# forwards timed per bucket over AOT_ITERS calls, in turns. Then
# nlpd_loss_train on TRAIN_BATCH pairs of TRAIN_CROP against its CPU run,
# within tests/test_torch_tools.py's bounds against JAX (NLPD_TRAIN_*: the
# value relative, the input gradient's cosine and norm ratio; bf16 levels
# whose pred-target difference sits near 0 take the other sign when a
# blur rounds one ulp the other way); visualize on VIS_IMAGES synthetic
# images with the SRCNN asset and a seeded AttentionSR; SWEEP_TRIALS
# sweep trials of SWEEP_CFG (the YAML's space, the overrides of its
# --set); generate_model_vis and analyze_models
AOT_BATCH, AOT_ITERS, AOT_CHILD_TIMEOUT = 8, 10, 300
NLPD_TRAIN_RTOL, NLPD_TRAIN_COS, NLPD_TRAIN_NORM = 2.0**-10, 0.995, 0.01
VIS_IMAGES, SWEEP_TRIALS = 8, 2
SWEEP_CFG = dict(dataset="synthetic", epochs=1, loss_function="nlpd",
                 subset=1.0, synthetic_size=40, crop_size=96, batch_size=8,
                 seed=0, log_every=1, use_wandb=False)
K2_OP_NODE = "f101.spatial_mean"


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


@contextlib.contextmanager
def _branches(models: dict, rec: dict, mode: str, stats: dict,
              kinds: tuple = ()):
    """Within the block, the branch each element of an activation's input
    takes (its sign) in the forwards of ``models`` (name -> module): every
    ReLU, LeakyReLU and PReLU module (or those of ``kinds``), per module
    and call, in call order. By ``mode``: "record" keeps the masks in
    ``rec``; "compare" counts in ``stats`` the elements whose branch
    differs from the recorded one ("kinks" of "branches"; per module in
    "by_module"); "replay" applies each activation on its recorded
    branches, in its input's dtype."""
    from torch import nn

    kinds = kinds or (nn.ReLU, nn.LeakyReLU, nn.PReLU)
    masks = rec.setdefault("masks", {})
    stats.setdefault("branches", 0)
    stats.setdefault("kinks", 0)
    by_module = stats.setdefault("by_module", {})
    calls: dict = {}

    def hook(mod, inp, out, name):
        x, i = inp[0], calls.get(name, 0)
        calls[name] = i + 1
        if mode == "record":
            masks.setdefault(name, []).append(x > 0)
            return None
        m = masks[name][i].to(x.device)
        if mode == "compare":
            k = int(((x > 0) != m).sum())
            stats["kinks"] += k
            stats["branches"] += m.numel()
            by_module[name] = by_module.get(name, 0) + k
            return None
        if isinstance(mod, nn.PReLU):
            a = mod.weight.view(1, -1, 1, 1) if mod.weight.numel() > 1 \
                else mod.weight
            neg = a.to(x.dtype) * x
        elif isinstance(mod, nn.LeakyReLU):
            neg = x * torch.tensor(mod.negative_slope, dtype=x.dtype,
                                   device=x.device)
        else:
            neg = torch.zeros_like(x)
        return torch.where(m, x, neg)

    hooks = [m.register_forward_hook(
        lambda mod, inp, out, n=f"{key}.{n}": hook(mod, inp, out, n))
        for key, model in models.items()
        for n, m in model.named_modules() if isinstance(m, kinds)]
    try:
        yield stats
    finally:
        for h in hooks:
            h.remove()
    if mode != "record" and calls != {n: len(v) for n, v in masks.items()}:
        raise AssertionError(f"{mode}: activation calls {calls} differ "
                             "from the recorded ones")


@contextlib.contextmanager
def _decisions(model, rec: dict, mode: str):
    """Within the block, the discrete choices of ``model``'s forward: the
    int8 level of each fake-quantized activation (QAT nets;
    ``ops.quantize.fake_quant_act``, in call order) and the branch of each
    PReLU input element (its sign; per module, in call order). By
    ``mode``: "record" keeps them in ``rec`` (on the CPU, with the
    fake-quantized values); "compare" counts this forward's choices that
    differ from the recorded ones (the yielded dict: fake-quant levels and
    the largest difference, PReLU branches); "replay" makes the recorded
    choices, each activation's recorded fake-quantized values taken
    through the straight-through estimator, each PReLU applied on its
    recorded branches."""
    from torch import nn

    from food101_sr_tpu_torch.ops import quantize as q

    own = q.fake_quant_act
    acts = rec.setdefault("acts", [])
    stats = {"calls": 0, "elements": 0, "flips": 0, "max_levels": 0}
    it = iter(acts)

    def record(x):
        y = own(x)
        acts.append((q.quantize_per_sample(x)[0].cpu(), y.detach().cpu()))
        return y

    def compare(x):
        levels = next(it)[0]
        diff = (q.quantize_per_sample(x)[0].cpu().int() - levels.int()).abs()
        stats["flips"] += int((diff > 0).sum())
        stats["elements"] += diff.numel()
        stats["max_levels"] = max(stats["max_levels"], int(diff.max()))
        stats["calls"] += 1
        return own(x)

    def replay(x):
        xf = x.float()
        stats["calls"] += 1
        return q._ste(xf, next(it)[1].to(xf.device)).to(x.dtype)

    q.fake_quant_act = {"record": record, "compare": compare,
                        "replay": replay}[mode]
    try:
        with _branches({"": model}, rec, mode, stats, (nn.PReLU,)):
            yield stats
    finally:
        q.fake_quant_act = own
    if mode != "record" and stats["calls"] != len(acts):
        raise AssertionError(f"{mode}: {stats['calls']} fake-quantized "
                             f"activations, {len(acts)} recorded")


def _grad_check(model, batch: int = GRAD_BATCH, crop: int = TRAIN_CROP,
                arch: str = "AttentionSR") -> dict:
    """One step's raw gradients of ``model`` (registry ``arch``, its
    ``quantize`` and ``phase_tail``) on ``batch`` seeded crops: on the
    card (K1, K2) and on a CPU copy (their plain versions), TF32 off.
    Per leaf, the largest difference over the leaf's scale: its largest
    sum of absolute terms (``term_sums``; asserted) and, for the record,
    its max abs. For a QAT net also ``choices`` (the card's fake-quant
    levels and PReLU branches that differ from the CPU's, ``_decisions``)
    and ``shared``: the card's gradients again with the CPU's choices
    made in its forward, so that the two sides differ by float rounding
    alone."""
    from food101_sr_tpu_torch.losses import nlpd_loss
    from food101_sr_tpu_torch.models import get_model
    from food101_sr_tpu_torch.ops import full_fp32
    from food101_sr_tpu_torch.training import loss_and_grads
    from food101_sr_tpu_torch.utils.term_sums import term_sums

    cpu = get_model(arch, device="cpu",
                    quantize=getattr(model, "quantize", ""),
                    phase_tail=getattr(model, "phase_tail", False))
    cpu.load_state_dict(model.state_dict())
    hr = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (batch, crop, crop, 3), np.uint8))
    qat = getattr(model, "quantize", "") == "qat"
    rec: dict = {}
    with term_sums(cpu, {}) as sums, contextlib.ExitStack() as stack:
        if qat:
            stack.enter_context(_decisions(cpu, rec, "record"))
        _, on_cpu = loss_and_grads(cpu, nlpd_loss, 4, hr)
    with full_fp32(), contextlib.ExitStack() as stack:
        choices = stack.enter_context(_decisions(model, rec, "compare")) \
            if qat else None
        _, on_card = loss_and_grads(model, nlpd_loss, 4, hr.cuda())
    names = [k for k, _ in cpu.named_parameters()]
    out = _worst(names, on_card, on_cpu, sums)
    if qat:
        with full_fp32(), _decisions(model, rec, "replay"):
            _, shared = loss_and_grads(model, nlpd_loss, 4, hr.cuda())
        out["shared"] = _worst(names, shared, on_cpu, sums)
        out["choices"] = choices
    return out


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

    # both tails' gradients (train --no_phase_tail runs the materialized
    # one); the steps below train the default, the phase tail
    t_phase = time.perf_counter()
    for phase_tail in (False, True):
        t0 = time.perf_counter()
        model = get_model("AttentionSR", device="cuda", phase_tail=phase_tail,
                          generator=torch.Generator().manual_seed(0)).train()
        arch = (f"AttentionSR x4 {model.num_residuals}x"
                f"{model.input_conv.out_channels} f32 channels-last, "
                f"{'phase' if phase_tail else 'materialized'} tail")
        worst = _grad_check(model)
        (err, leaf), (err_peak, leaf_peak) = (worst["term_sum"],
                                              worst["max_abs"])
        if not err <= GRAD_TOL:
            raise AssertionError(f"train gradients ({arch}), card vs CPU "
                                 f"plain: {leaf} off by {err} of its "
                                 "largest term sum")
        print(f"train: {arch} | raw gradients on {GRAD_BATCH}x{TRAIN_CROP}^2"
              f", card (K1, K2, TF32 off) vs CPU plain: worst leaf {leaf} "
              f"{err:.3g} of its largest sum of absolute terms (tol "
              f"{GRAD_TOL}); worst over the max abs: {leaf_peak} "
              f"{err_peak:.3g} (its term sum is "
              f"{worst['ratio'][leaf_peak]:.0f}x its size; largest ratio "
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
          f"({k2['bound_by']}) | train phase "
          f"{time.perf_counter() - t_phase:.1f} s",
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
    from food101_sr_tpu_torch.utils.term_sums import term_sums

    sgd0 = Transform(lambda params, lr: torch.optim.SGD(params, lr=lr,
                                                        fused=True), 0.0)
    g_cpu = get_model("AttentionSR", device="cpu", phase_tail=g.phase_tail)
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
            with (term_sums(dm, sums_d) if dev == "cpu"
                  else contextlib.nullcontext()):
                d_step(gs, ds, hr.to(dev), [n.to(dev) for n in noise])
            d_grads = [p.grad.clone() for p in ds.params]
            d_bufs = [b.clone() for b in dm.buffers()]
            with (term_sums(gm, sums_g) if dev == "cpu"
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
    g = get_model("AttentionSR", device="cuda", phase_tail=True,
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
    model = get_model(arch, device="cuda", phase_tail=True,
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


def _bf16_grad_check(f32_model, arch: str) -> dict:
    """One bf16 step's raw gradients of registry ``arch`` on GRAD_BATCH
    seeded crops against the card's own float32 step on the same weights
    with TF32 off: per leaf, the largest difference over the leaf's
    largest sum of absolute terms (``term_sums``, from the float32 pass),
    and for the record over its max abs. The bf16 gradients must come back
    float32."""
    from food101_sr_tpu_torch.losses import nlpd_loss
    from food101_sr_tpu_torch.models import get_model
    from food101_sr_tpu_torch.ops import full_fp32
    from food101_sr_tpu_torch.training import loss_and_grads
    from food101_sr_tpu_torch.utils.term_sums import term_sums

    bf = get_model(arch, device="cuda", phase_tail=True,
                   compute_dtype=torch.bfloat16)
    bf.load_state_dict(f32_model.state_dict())
    hr = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (GRAD_BATCH, TRAIN_CROP, TRAIN_CROP, 3), np.uint8)).cuda()
    with full_fp32(), term_sums(f32_model, {}) as sums:
        _, ref = loss_and_grads(f32_model, nlpd_loss, 4, hr)
    _, got = loss_and_grads(bf, nlpd_loss, 4, hr)
    names = [k for k, _ in bf.named_parameters()]
    if any(g.dtype != torch.float32 for g in got):
        raise AssertionError(f"bf16 {arch}: gradients not float32")
    out = {"term_sum": (0.0, ""), "max_abs": (0.0, "")}
    for name, a, b in zip(names, got, ref, strict=True):
        diff, peak = (a - b).abs().max().item(), b.abs().max().item()
        if sums[name] < peak * (1 - 1e-5):
            raise AssertionError(f"{name}: term sum {sums[name]} below the "
                                 f"gradient's max abs {peak}")
        for key, scale in (("term_sum", sums[name]),
                           ("max_abs", peak or sums[name])):
            if diff / (scale + 1e-30) >= out[key][0]:
                out[key] = (diff / (scale + 1e-30), name)
    del bf
    return out


def _bf16_steps(arch: str) -> dict:
    """The bf16 phase for registry ``arch`` (module docstring, phase 11b):
    the float32 and the bf16 step from the same seeded weights, each
    BF16_WARMUP + BF16_TIMED steps under CUDA events on one batch, the
    first timed step counting the kernels' launches, a profile of
    BF16_PROFILED steps for the busy share, peak memory, the loss lower
    after the timed steps than before them; the bf16 step's gradients
    against the float32 one first."""
    from food101_sr_tpu_torch.losses import get_loss_function
    from food101_sr_tpu_torch.models import get_model
    from food101_sr_tpu_torch.training import (FIRST_LAST, SRTrainState,
                                               make_adam, make_train_step)

    gen = torch.Generator(device="cuda").manual_seed(16)
    hr_u8 = torch.randint(0, 256, (TRAIN_BATCH, TRAIN_CROP, TRAIN_CROP, 3),
                          dtype=torch.uint8, device="cuda", generator=gen)
    loss_fn = get_loss_function("nlpd")
    first, last = FIRST_LAST[arch]
    out = {}
    for key, cd in (("f32", None), ("bf16", torch.bfloat16)):
        model = get_model(arch, device="cuda", phase_tail=True,
                          compute_dtype=cd,
                          generator=torch.Generator().manual_seed(0)).train()
        if cd is None:
            out["grad"] = _bf16_grad_check(model, arch)
        state = SRTrainState.create(model, make_adam(TRAIN_LR))
        step = make_train_step(model, loss_fn, 4, first, last)
        losses = []
        for _ in range(BF16_WARMUP):
            state, m = step(state, hr_u8)
            losses.append(m["train_loss"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(BF16_TIMED + 1)]
        ev[0].record()
        for i in range(BF16_TIMED):
            if i == 0:  # ---- main path: one train step, counts from zero
                _zero_counts()
            state, m = step(state, hr_u8)
            if i == 0:
                launches = _counts()  # ---- end of main path ----
            losses.append(m["train_loss"])
            ev[i + 1].record()
        ev[-1].synchronize()
        peak = torch.cuda.max_memory_allocated()
        ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(BF16_TIMED)]
        losses = [float(v) for v in losses]
        # falling over the timed steps: RRDB's first Adam steps at 4e-4
        # throw its loss up (0.88 -> 16.6 on the card) before it falls
        if not (all(np.isfinite(losses))
                and losses[-1] < losses[BF16_WARMUP]
                and int(state.skipped) == 0):
            raise AssertionError(f"bf16 phase {arch} {key}: losses {losses} "
                                 f"on one batch, skipped {int(state.skipped)}")
        moments = [t for s in state.optimizer.state.values()
                   for k, t in s.items() if k != "step"]
        if not (all(p.dtype == torch.float32 for p in state.params)
                and moments and all(t.dtype == torch.float32
                                    for t in moments)):
            raise AssertionError(f"bf16 phase {arch} {key}: parameters or "
                                 "Adam's moments not float32")
        n_blocks = model.num_residuals if arch == "AttentionSR" else 0
        # NLPD: a float32 step blurs pred and target in one pyramid (4
        # forward, 4 backward); a bf16 pred gets a pyramid of its own (8
        # forward, 4 backward: the target's needs no gradient)
        want = (12 if cd is not None else 8, n_blocks, 0)
        if launches != want:
            raise AssertionError(f"bf16 phase {arch} {key}: one step "
                                 f"launched (K1, K2 nhwc, K2 plane) "
                                 f"{launches}, expected {want}")
        mean_ms = float(np.mean(ms))
        _, dev_ms = _profile(step, state, hr_u8, BF16_PROFILED, mean_ms,
                             verbose=False, label=f"bf16 {arch} {key}")
        out[key] = {"step_ms": mean_ms, "step_ms_all": ms,
                    "images_per_s": TRAIN_BATCH / mean_ms * 1e3,
                    "busy_share": dev_ms / mean_ms,
                    "device_ms_per_step": dev_ms, "peak_bytes": peak,
                    "losses": losses,
                    "launches": {"K1": launches[0], "K2 nhwc": launches[1],
                                 "K2 nchw": launches[2]}}
        del model, state, step
        torch.cuda.empty_cache()
    return out


def _bf16_kernels(rates) -> tuple[dict, dict]:
    """K1 as the bf16 loss launches it (pred's own pyramid: TRAIN_BATCH
    planes a level, float32, cast from bf16 around the kernel) and the
    NHWC K2 entry on the bf16 train step's SE input (TRAIN_BATCH, 96,
    TRAIN_CROP/4, TRAIN_CROP/4) bf16 channels-last, forward and through
    its autograd backward, each against its plain version, with times."""
    from food101_sr_tpu_torch.ops.spatial_mean import (mean_nhwc_kernel,
                                                       spatial_mean,
                                                       spatial_mean_plain)

    gen = torch.Generator(device="cuda").manual_seed(17)
    pyr = [torch.rand((TRAIN_BATCH, 3, TRAIN_CROP >> i, TRAIN_CROP >> i),
                      device="cuda", generator=gen)
           .to(torch.bfloat16).float() for i in range(4)]
    err1 = _k1_err(pyr, gen)
    shape = (TRAIN_BATCH, 96, TRAIN_CROP // 4, TRAIN_CROP // 4)
    x = (torch.rand(shape, device="cuda", generator=gen) * 2 - 0.5).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    got, want = mean_nhwc_kernel(x).float(), spatial_mean_plain(x).float()
    ulp = ((got - want).abs() / _ulp_bf16(want)).max().item()
    gy = torch.rand(shape[:2], device="cuda", generator=gen).to(
        torch.bfloat16)
    xa, xb = (x.clone().requires_grad_(True) for _ in range(2))
    (spatial_mean(xa) * gy).sum().backward()
    (spatial_mean_plain(xb) * gy).sum().backward()
    gb = xb.grad.float()
    bwd_ulp = ((xa.grad.float() - gb).abs() / _ulp_bf16(gb)).max().item()
    if not (err1 <= K1_TOL and ulp <= 1.0 and bwd_ulp <= 1.0
            and xa.grad.dtype == torch.bfloat16):
        raise AssertionError(f"bf16 kernels: K1 {err1}, K2 forward {ulp} "
                             f"ulp, backward {bwd_ulp} ulp, grad "
                             f"{xa.grad.dtype}")
    t1 = _k1_timings(pyr, rates)
    t1["max_abs_err"] = err1
    t2 = _timings(lambda: mean_nhwc_kernel(x), lambda: spatial_mean_plain(x),
                  lambda: x.mean((2, 3)), launches=1)
    t2["bound_ms"], t2["bound_by"] = bound(
        2 * x.numel() + 2 * shape[0] * shape[1], x.numel(), rates)

    def fwd_bwd(fn):
        xg = x.detach().requires_grad_(True)
        (fn(xg) * gy).sum().backward()

    t2["fwd_bwd_ms"] = cuda_ms(lambda: fwd_bwd(spatial_mean))
    t2["plain_fwd_bwd_ms"] = cuda_ms(lambda: fwd_bwd(spatial_mean_plain))
    t2["max_abs_err"] = (got - want).abs().max().item()
    t2["ulp"], t2["backward_ulp"] = ulp, bwd_ulp
    return t1, t2


def phase_bf16(rates) -> tuple[dict, dict, dict]:
    """bf16 training on the card (module docstring, phase 11b): the four
    generators' bf16 steps beside their float32 ones, the kernels at the
    bf16 step's shapes, and the bf16 GAN steps. Returns the K1 and K2
    records of the bf16 train step, launches per step included, and the
    plane K2 entry's launches in each net's bf16 step."""
    from food101_sr_tpu_torch.utils.term_sums import BF16_GRAD_TOL

    t0 = time.perf_counter()
    k1, k2 = _bf16_kernels(rates)
    print(f"bf16 kernels: K1 on bf16 pred's pyramid "
          f"({TRAIN_BATCH},3,{{{','.join(str(TRAIN_CROP >> i) for i in range(4))}}}^2)"
          f" f32: max_abs_err {k1['max_abs_err']:.3g}, kernel "
          f"{k1['ms']:.4f} ms, device {k1['device_ms']:.4f}, host "
          f"{k1['host_us']:.1f} us, plain {k1['plain_ms']:.4f}, conv2d "
          f"{k1['library_ms']:.4f}, bound {k1['bound_ms']:.4f} "
          f"({k1['bound_by']}) | K2 nhwc ({TRAIN_BATCH},96,{TRAIN_CROP // 4},"
          f"{TRAIN_CROP // 4}) bf16 channels-last: forward {k2['ulp']:.2g} "
          f"ulp, backward {k2['backward_ulp']:.2g} ulp; kernel "
          f"{k2['ms']:.4f} ms, device {k2['device_ms']:.4f}, host "
          f"{k2['host_us']:.1f} us, plain {k2['plain_ms']:.4f}, x.mean "
          f"{k2['library_ms']:.4f}, bound {k2['bound_ms']:.4f} "
          f"({k2['bound_by']}); forward+backward {k2['fwd_bwd_ms']:.4f} ms, "
          f"plain {k2['plain_fwd_bwd_ms']:.4f}", flush=True)
    nets = {}
    for arch in BF16_ARCHS:
        t = time.perf_counter()
        r = nets[arch] = _bf16_steps(arch)
        err, leaf = r["grad"]["term_sum"]
        if not err <= BF16_GRAD_TOL:
            raise AssertionError(f"bf16 {arch}: gradients against the "
                                 f"float32 step: {leaf} off by {err} of its "
                                 f"largest term sum (tol {BF16_GRAD_TOL})")
        f, b = r["f32"], r["bf16"]
        print(f"bf16: {arch} x4 batch {TRAIN_BATCH}x{TRAIN_CROP}^2 NLPD | "
              f"step f32 {f['step_ms']:.3f} ms, bf16 {b['step_ms']:.3f} ms "
              f"(x{f['step_ms'] / b['step_ms']:.2f}) | images/s "
              f"{f['images_per_s']:.1f} -> {b['images_per_s']:.1f} | busy "
              f"share {f['busy_share']:.3f} -> {b['busy_share']:.3f} | peak "
              f"{f['peak_bytes'] / 2**30:.3f} -> {b['peak_bytes'] / 2**30:.3f}"
              f" GiB | launches per bf16 step {b['launches']} | gradients on "
              f"{GRAD_BATCH}x{TRAIN_CROP}^2 vs the f32 step (TF32 off): worst "
              f"{err:.3g} of a term sum at {leaf} (tol {BF16_GRAD_TOL}), "
              f"{r['grad']['max_abs'][0]:.3g} of a max abs at "
              f"{r['grad']['max_abs'][1]} | params and Adam float32, bf16 "
              f"loss {b['losses'][0]:.5f} -> {b['losses'][-1]:.5f} | "
              f"{time.perf_counter() - t:.1f} s", flush=True)
    gan = _bf16_gan()
    numbers = {a: {k: {kk: vv for kk, vv in v.items() if kk != "losses"}
                   if isinstance(v, dict) else v for k, v in r.items()}
               for a, r in nets.items()}
    numbers["gan"] = gan
    print("bf16 numbers: " + json.dumps(numbers), flush=True)
    print(f"bf16 phase: {time.perf_counter() - t0:.1f} s", flush=True)
    att = nets["AttentionSR"]["bf16"]
    k1.update({
        "name": "K1 depthwise Gaussian blur 5x5, bf16 train step",
        "route": "cuda", "source": "food101_sr_tpu_torch/csrc/kernels.cu",
        "replaces": "food101_sr_tpu/ops/pallas_blur.py:65",
        "wrapper": "food101_sr_tpu_torch/ops/pallas_blur.py:blur_kernel",
        "launches": att["launches"]["K1"],
        "bf16_launches": {a: r["bf16"]["launches"]["K1"]
                          for a, r in nets.items()},
        "at": f"one bf16 train step: 8 launches forward (pred's pyramid, "
              f"cast from bf16, and the target's) and 4 backward; timed: "
              f"pred's pyramid ({TRAIN_BATCH},3,{{200,100,50,25}}^2) float32",
        "step_ms": att["step_ms"], "images_per_s": att["images_per_s"],
        "peak_bytes": att["peak_bytes"]})
    k2.update({
        "name": "K2 spatial mean (SE squeeze), nhwc input, bf16 train step",
        "route": "cuda", "source": "food101_sr_tpu_torch/csrc/kernels.cu",
        "replaces": "food101_sr_tpu/ops/spatial_mean.py:45",
        "wrapper": "food101_sr_tpu_torch/ops/spatial_mean.py:"
                   "mean_nhwc_kernel",
        "launches": att["launches"]["K2 nhwc"],
        "bf16_launches": {a: r["bf16"]["launches"]["K2 nhwc"]
                          for a, r in nets.items()},
        "at": f"one bf16 train step of AttentionSR: 32 launches, each "
              f"({TRAIN_BATCH},96,{TRAIN_CROP // 4},{TRAIN_CROP // 4}) "
              "bfloat16 channels-last, backward plain",
        "step_ms": att["step_ms"], "images_per_s": att["images_per_s"],
        "peak_bytes": att["peak_bytes"]})
    return k1, k2, {a: r["bf16"]["launches"]["K2 nchw"]
                    for a, r in nets.items()}


def _next_activation(names, leaf: str) -> str:
    """The activation right after ``leaf``'s layer in its Sequential
    (``classifier.2.bias`` -> ``classifier.3``) when ``names`` holds it,
    else ""."""
    parent, _, idx = leaf.rsplit(".", 1)[0].rpartition(".")
    name = f"{parent}.{int(idx) + 1}" if idx.isdigit() else ""
    return name if name in names else ""


def _bf16_gan() -> dict:
    """One bf16 D step and one bf16 G step of the GAN on the registry
    AttentionSR (phase tail) and Discriminator(nf=GAN_NF), VGG19 seeded,
    on GRAD_BATCH seeded crops and noise tensors, against the same steps
    in float32 on the card with TF32 off: raw gradients per leaf over
    their term sums (from the float32 steps; fused SGD at lr 0 leaves them
    in .grad), the parameters float32. Twice: as the steps run, within
    BF16_GAN_TOL, with the activation elements of G and D that take the
    other branch than in the float32 steps counted (``_branches``), also
    at the activation after each worst leaf's layer; then with the float32
    steps' branches applied in the bf16 steps, within BF16_GRAD_TOL."""
    from food101_sr_tpu_torch.utils.term_sums import (BF16_GAN_TOL,
                                                      BF16_GRAD_TOL)

    from food101_sr_tpu_torch.losses import PerceptualLoss
    from food101_sr_tpu_torch.models import (Discriminator, build_model,
                                             get_model)
    from food101_sr_tpu_torch.ops import full_fp32
    from food101_sr_tpu_torch.training import (FIRST_LAST, SRTrainState,
                                               Transform, make_gan_d_step,
                                               make_gan_g_step)
    from food101_sr_tpu_torch.utils.term_sums import term_sums

    t0 = time.perf_counter()
    sgd0 = Transform(lambda params, lr: torch.optim.SGD(params, lr=lr,
                                                        fused=True), 0.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        percep = PerceptualLoss(device="cuda")
    rng = np.random.default_rng(5)
    hr = torch.from_numpy(rng.integers(0, 256, (GRAD_BATCH, TRAIN_CROP,
                                                TRAIN_CROP, 3), np.uint8))
    noise = [torch.from_numpy(rng.standard_normal(
        (GRAD_BATCH, 3, TRAIN_CROP, TRAIN_CROP), np.float32)).cuda()
        for _ in range(2)]
    first, last = FIRST_LAST["AttentionSR"]
    runs, recs, kinks = {}, ({}, {}), {}
    for key, cd, mode in (("f32", None, "record"),
                          ("bf16", torch.bfloat16, "compare"),
                          ("replay", torch.bfloat16, "replay")):
        g = get_model("AttentionSR", device="cuda", phase_tail=True,
                      compute_dtype=cd,
                      generator=torch.Generator().manual_seed(0))
        d = build_model(lambda: Discriminator(nf=GAN_NF, compute_dtype=cd),
                        device="cuda",
                        generator=torch.Generator().manual_seed(2))
        gs, ds = SRTrainState(g, sgd0), SRTrainState(d, sgd0)
        d_step = make_gan_d_step(g, d, 4)
        g_step = make_gan_g_step(g, d, percep, 4, first, last)
        sums_d, sums_g, st_d, st_g = {}, {}, {}, {}
        # the float32 reference with TF32 off; its term sums scale both
        ctx = full_fp32 if cd is None else contextlib.nullcontext
        n = [t if cd is None else t.to(cd) for t in noise]
        nets = {"G": g, "D": d}
        with ctx():
            with (term_sums(d, sums_d) if cd is None
                  else contextlib.nullcontext()), \
                    _branches(nets, recs[0], mode, st_d):
                d_step(gs, ds, hr.cuda(), [n[0].float(), n[1]])
            d_grads = [p.grad.clone() for p in ds.params]
            with (term_sums(g, sums_g) if cd is None
                  else contextlib.nullcontext()), \
                    _branches(nets, recs[1], mode, st_g):
                g_step(gs, ds, hr.cuda())
            g_grads = [p.grad.clone() for p in gs.params]
        if not all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
                   for p in [*gs.params, *ds.params]):
            raise AssertionError(f"bf16 gan {key}: a parameter or gradient "
                                 "is not float32")
        runs[key] = (d_grads, g_grads, sums_d, sums_g, ds.names, gs.names)
        if mode == "compare":
            kinks = {"D": st_d, "G": st_g}
        del g, d, gs, ds
    out = {}
    for key, tol in (("bf16", BF16_GAN_TOL), ("replay", BF16_GRAD_TOL)):
        for i, net in ((0, "D"), (1, "G")):
            worst = (0.0, "")
            names, sums = runs["f32"][4 + i], runs["f32"][2 + i]
            for name, a, b in zip(names, runs[key][i], runs["f32"][i],
                                  strict=True):
                err = (a - b).abs().max().item() / (sums[name] + 1e-30)
                if err >= worst[0]:
                    worst = (err, name)
            if not worst[0] <= tol:
                raise AssertionError(f"bf16 gan {net} step ({key}): "
                                     f"{worst[1]} off by {worst[0]} of its "
                                     f"largest term sum (tol {tol})")
            out[f"{net}_{key}"] = worst
    # the activation elements on the other branch than in the float32
    # steps: all of G's and D's, and those of the activation right after
    # each worst leaf's layer (in the step of the worst leaf's net)
    at = {}
    for i, net in ((0, "D"), (1, "G")):
        masks = recs[i]["masks"]
        act = _next_activation(masks, f"{net}.{out[net + '_bf16'][1]}")
        at[net] = (act, kinks[net]["by_module"].get(act, 0),
                   sum(m.numel() for m in masks.get(act, [])))
    print(f"bf16 gan: D (nf={GAN_NF}) and G (AttentionSR) steps on "
          f"{GRAD_BATCH}x{TRAIN_CROP}^2 in bf16 vs float32 (TF32 off) | as "
          f"run: D worst {out['D_bf16'][0]:.3g} of a term sum at "
          f"{out['D_bf16'][1]}, G worst {out['G_bf16'][0]:.3g} at "
          f"{out['G_bf16'][1]} (tol {BF16_GAN_TOL}); activation elements on "
          f"the other branch: D step {kinks['D']['kinks']} of "
          f"{kinks['D']['branches']}, G step {kinks['G']['kinks']} of "
          f"{kinks['G']['branches']}; after D's worst leaf ({at['D'][0]}) "
          f"{at['D'][1]} of {at['D'][2]}, after G's ({at['G'][0]}) "
          f"{at['G'][1]} of {at['G'][2]} | float32 branches applied: D "
          f"worst {out['D_replay'][0]:.3g} at {out['D_replay'][1]}, G worst "
          f"{out['G_replay'][0]:.3g} at {out['G_replay'][1]} (tol "
          f"{BF16_GRAD_TOL}) | params float32 | "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {"D_grad_term_sum": out["D_bf16"][0],
            "G_grad_term_sum": out["G_bf16"][0],
            "D_grad_term_sum_branches_shared": out["D_replay"][0],
            "G_grad_term_sum_branches_shared": out["G_replay"][0],
            "D_step_kinks": kinks["D"]["kinks"],
            "G_step_kinks": kinks["G"]["kinks"],
            "D_step_branches": kinks["D"]["branches"],
            "G_step_branches": kinks["G"]["branches"],
            "kinks_after_worst_leaf": at}


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
    y = (acc / 8).to(server.dtype)  # quantized in it, as the server does
    y8 = (y.clamp(0.0, 1.0) * 255.0 + 0.5).clamp(max=255.0).to(torch.uint8)
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


# the upload classes the port once answered 415 and the JAX server
# decodes (PIL): name -> committed stream (assets/jpeg/streams/)
CODEC_UPLOADS = {"arithmetic JPEG": "arith.jpg",
                 "arithmetic progressive JPEG": "arith_progressive.jpg",
                 "CMYK JPEG": "cmyk.jpg", "YCCK JPEG": "ycck.jpg",
                 "lossless JPEG": "lossless.jpg", "16-bit PNG": "rgb16.png",
                 "interlaced PNG": "interlaced.png", "GIF": "gif.gif",
                 "BMP": "bmp24.bmp", "lossy WebP": "webp_q50.webp",
                 "lossy WebP, simple filter": "webp_simple_filter.webp",
                 "lossy WebP, 8 partitions": "webp_partitions8.webp",
                 "lossy WebP, 4 segments": "webp_segments4.webp",
                 "lossless WebP": "webp_lossless.webp",
                 "lossless WebP, palette": "webp_lossless_palette.webp",
                 "WebP with alpha": "webp_rgba.webp",
                 "WebP, raw gradient-filtered alpha":
                     "webp_alpha_raw_f3.webp",
                 "WebP, coded vertical-filtered alpha":
                     "webp_alpha_vp8l_f2.webp",
                 "WebP with ICC and EXIF": "webp_icc_exif.webp",
                 "animated WebP": "webp_animation.webp",
                 "TIFF LZW, predictor 2": "tiff_lzw_pred2.tif",
                 "TIFF tiled Deflate": "tiff_deflate_tiled.tif",
                 "TIFF JPEG YCbCr 4:2:0, JPEGTables":
                     "tiff_jpeg_ycbcr420.tif",
                 "TIFF JPEG RGB (PIL)": "tiff_jpeg_rgb.tif",
                 "TIFF PackBits 4-bit palette": "tiff_packbits_palette.tif",
                 "TIFF G4": "tiff_g4.tif", "TIFF G3 2-D": "tiff_g3_2d.tif",
                 "TIFF Modified Huffman": "tiff_mh.tif",
                 "TIFF 16-bit RGB big-endian": "tiff_rgb16_be.tif",
                 "TIFF separate planes": "tiff_planar.tif",
                 "BigTIFF": "tiff_bigtiff.tif", "TIFF CMYK": "tiff_cmyk.tif",
                 "TIFF LZMA": "tiff_lzma.tif",
                 "TIFF float, predictor 3": "tiff_float_pred3.tif",
                 "TIFF YCbCr LZW (RGBA reader)": "tiff_ycbcr_lzw.tif",
                 "TIFF Orientation 6": "tiff_orientation6.tif",
                 "binary PPM": "ppm_binary.ppm", "plain PPM": "ppm_plain.ppm",
                 "16-bit PGM": "pgm16.pgm", "PFM": "pfm.pfm",
                 "ICO with a PNG": "ico_png.ico",
                 "ICO with BMPs": "ico_bmp.ico",
                 "CUR with a BMP": "cur_bmp.cur", "QOI RGBA": "qoi_rgba.qoi"}


def _codec_uploads() -> dict:
    """name -> (bytes, the JAX server's decode digest) of CODEC_UPLOADS."""
    with open(os.path.join(JPEG_ASSETS, "goldens.json")) as f:
        streams = json.load(f)["streams"]
    out = {}
    for name, fname in CODEC_UPLOADS.items():
        g = streams[os.path.splitext(fname)[0]]
        with open(os.path.join(JPEG_ASSETS, g["file"]), "rb") as f:
            out[name] = (f.read(), g["served_sha256"])
    return out


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
        # and a WebP (its decode is held to the JAX server's below)
        with open(os.path.join(JPEG_ASSETS, "streams", "webp_q50.webp"),
                  "rb") as f:
            pred_webp = f.read()
        pred_imgs["photo.webp"] = native.decode_image(pred_webp)
        pred_in = os.path.join(tmp.name, "in")
        pred_out = os.path.join(tmp.name, "out")
        os.makedirs(pred_in)
        for name, img in pred_imgs.items():
            with open(os.path.join(pred_in, name), "wb") as f:
                f.write(pred_webp if name.endswith(".webp")
                        else native.encode_png_rgb8(img))
        cold_b = [native.encode_png_rgb8(x) for x in cold]
        small_b = [native.encode_png_rgb8(x) for x in small]
        tiled_b = [native.encode_png_rgb8(x) for x in tiled]
        tta_b = [native.encode_png_rgb8(x) for x in tta_imgs]
        gold_b = [native.encode_png_rgb8(x) for x, _ in gold]
        if not native.jpeg_available():
            raise AssertionError("the JPEG codec did not build: "
                                 f"{native.build_error('fast_jpeg')}")
        native._gifbmp_lib()  # raises, naming the compiler's error
        native._webp_lib()
        native.tiff_lib()
        jpeg_body = native.encode_jpeg_rgb8(small[0], 95)
        jpeg_imgs = [rng.integers(0, 256, (64, 64, 3), np.uint8)
                     for _ in range(JPEG_ROUND)]
        jpeg_b = [native.encode_jpeg_rgb8(x, 90) for x in jpeg_imgs]
        uploads = _codec_uploads()
        with open(os.path.join(JPEG_ASSETS, "streams", "webp.webp"),
                  "rb") as f:
            webp_body = f.read()
        with open(os.path.join(JPEG_ASSETS, "goldens.json")) as f:
            zstd = json.load(f)["port_refused"]["tiff_zstd"]
        with open(os.path.join(JPEG_ASSETS, zstd["file"]), "rb") as f:
            zstd_body = f.read()
        truncated_body = jpeg_body[:len(jpeg_body) * 2 // 3]
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
        # each decoder the JAX server has and the port once lacked, one
        # upload at a time: each is one device batch of the zoo's net
        r_codec, k2_codec = {}, {}
        for name, (body, _) in uploads.items():
            k2, nb = mean_nhwc_kernel.launches, attn.batcher.n_batches
            r_codec[name] = _http(port, "/sr?model=attn", body)
            k2_codec[name] = (mean_nhwc_kernel.launches - k2,
                              attn.batcher.n_batches - nb)
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
        jpeg_note = (f"a JPEG request, a ?format=jpeg response and "
                     f"{JPEG_ROUND} 64x64 JPEG uploads answered as JPEG, "
                     "byte-equal to encode_jpeg_rgb8(SRServer.upscale)")
        print(f"http: jpeg: {jpeg_note}", flush=True)
        # the new decoders: 200, the JAX server's pixels, and the PNG of
        # SRServer.upscale of them byte for byte
        codec_ms = {}
        for name, (body, digest) in uploads.items():
            code, hdrs, data, _ = r_codec[name]
            px = native.decode_image(body)
            if code != 200 or sha256(px) != digest:
                raise AssertionError(f"{name} upload: {code}, decode "
                                     "differs from the JAX server's")
            if k2_codec[name] != (n_blocks, 1):
                raise AssertionError(f"{name} upload: (K2 nhwc launches, "
                                     f"device batches) {k2_codec[name]}, "
                                     f"expected ({n_blocks}, 1)")
            if data != native.encode_png_rgb8(attn.upscale(px),
                                              attn.png_level):
                raise AssertionError(f"{name} upload: the response is not "
                                     "the PNG of SRServer.upscale")
            codec_ms[name] = host_us(lambda b=body: native.decode_image(b),
                                     1, 20) / 1e3
        shapes = {n: list(native.decode_image(b).shape[:2])
                  for n, (b, _) in uploads.items()}
        print("codec numbers: " + json.dumps(
            {"decode_ms": codec_ms, "shape": shapes,
             "bytes": {n: len(b) for n, (b, _) in uploads.items()}}),
              flush=True)

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
            rule_bf16 = _u8_rule_diff(half, [x for x, _ in gold])
        finally:
            half.close()
        if rule_bf16:
            raise AssertionError(f"SRCNN asset bf16: {rule_bf16} output "
                                 "bytes off the JAX server's uint8 rule")

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
            path = os.path.join(pred_out, os.path.splitext(name)[0]
                                + "_x4.png")
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
            "400 truncated JPEG": _http(port, "/sr?model=attn",
                                        truncated_body),
            "400 broken WebP": _http(port, "/sr?model=attn",
                                     webp_body[:len(webp_body) // 2]),
            "400 cut TIFF": _http(port, "/sr?model=attn",
                                  uploads["TIFF LZW, predictor 2"][0][:600]),
            "400 JBIG2": _http(port, "/sr?model=attn",
                               b"\x97JB2\r\n\x1a\n\x01" + bytes(64)),
            "400 HEIC": _http(port, "/sr?model=attn",
                              b"\x00\x00\x00\x1cftypheic" + bytes(64)),
            "415 ZSTD TIFF": _http(port, "/sr?model=attn", zstd_body),
            "415 PSD": _http(port, "/sr?model=attn", b"8BPS" + bytes(64)),
        }
        codes = {name: (int(r[9:12] or 0) if isinstance(r, bytes) else r[0])
                 for name, r in errors.items()}
        if (codes != {"404 unknown model": 404, "413": 413,
                      "400 truncated": 400, "400 truncated JPEG": 400,
                      "400 broken WebP": 400, "400 cut TIFF": 400,
                      "400 JBIG2": 400, "400 HEIC": 400,
                      "415 ZSTD TIFF": 415, "415 PSD": 415}
                or b"truncated" not in errors["400 truncated"]
                or zstd["refusal"].encode() not in errors["415 ZSTD TIFF"][2]
                or b"PSD" not in errors["415 PSD"][2]):
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
        "srcnn_bf16_bytes_off_jax_rule": rule_bf16,
        "levels_tta_vs_hand": lv_tta, "jpeg": True,
        "drain_s": drain_s, "warmup_s": warm_s, "launches": launches,
        "codec_decode_ms": codec_ms,
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
          f"drained; {len(CODEC_UPLOADS)} uploads of the new decoders, "
          f"decoded to the JAX server's digests: "
          f"{', '.join(CODEC_UPLOADS)}) | --tta vs hand ensemble {lv_tta} level(s) | SRCNN "
          f"asset f32 vs JAX goldens {lv_gold} level(s), bf16 "
          f"{lv_gold_bf16} (uint8 rule: {rule_bf16} bytes off JAX's) | "
          f"errors {codes} | drain {drain_s:.2f} s | "
          f"predict: {pred_line} | launches {launches}, --tta "
          f"{tta_launches} = 2 x {n_blocks} x {b_tta} batches | "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    print("http numbers: " + json.dumps(numbers), flush=True)
    return launches, _k2_tta(rates, tta_launches)


def _psnr_u8(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR in dB of two uint8 images (data range 1 on the /255 values)."""
    d = a.astype(np.float64) / 255 - b.astype(np.float64) / 255
    return float(10 * np.log10(1.0 / np.mean(d * d)))


def _winner_goldens(spec: dict) -> tuple[list, list, list, dict]:
    """A winner's goldens (module docstring, phase 8b): the LR inputs (the
    AttentionSR goldens'), JAX's float32 outputs (PNG streams in the
    file), the small inputs' HRs rebuilt from the committed JPEGs by the
    port's decoder, centre-cropped to a multiple of 4 as the tool crops
    them, and JAX's scores."""
    from food101_sr_tpu_torch import native

    lr_file = np.load(os.path.join(ASSETS, "winner_attentionsr_goldens.npz"))
    name, prefix = spec["goldens"]
    g = np.load(os.path.join(ASSETS, name))
    lrs = [native.decode_image(lr_file[f"lr_{i}"].tobytes())
           for i in range(WINNER_SMALL + 1)]
    srs = [native.decode_image(g[f"{prefix}sr_{i}"].tobytes())
           for i in range(WINNER_SMALL + 1)]
    base = os.path.join(JPEG_ASSETS, "food-101")
    with open(os.path.join(base, "meta", "test.txt")) as f:
        names = f.read().split()
    hrs = []
    for name in names:
        with open(os.path.join(base, "images", name + ".jpg"), "rb") as f:
            img = native.decode_jpeg_rgb8(f.read())
        h, w = img.shape[:2]
        y0, x0 = (h % 4) // 2, (w % 4) // 2
        hrs.append(img[y0:y0 + h - h % 4, x0:x0 + w - w % 4])
    if [h.shape for h in hrs] != [s.shape for s in srs[:WINNER_SMALL]]:
        raise AssertionError("winner: the rebuilt HRs do not match the "
                             "goldens' outputs in shape")
    return lrs, srs, hrs, {k: np.asarray(g[prefix + k]) for k in (
        "psnr", "ssim", "lpips", "nlpd", "psnr_bf16", "psnr_int8",
        "snr_int8")}


def _tile(x: np.ndarray, tile: int) -> np.ndarray:
    """``x`` edge-padded to a multiple of ``tile``, as the server pads it."""
    return np.pad(x, ((0, -x.shape[0] % tile), (0, -x.shape[1] % tile),
                      (0, 0)), mode="edge")


def _u8_rule_diff(srv, lrs) -> int:
    """The elements where ``srv.forward_u8`` on one device batch of
    ``lrs``' first tiles differs from the JAX server's rule applied to the
    same net output: clip to [0, 1], then x255 and +0.5 each rounded to
    the output's dtype, then truncated and saturated at 255 (XLA's
    conversion to uint8). 0 expected."""
    rows = srv.batcher.max_batch
    tiles = [_tile(x, srv.tile)[:srv.tile, :srv.tile] for x in lrs]
    x8 = torch.from_numpy(np.stack((tiles * rows)[:rows])).cuda()
    seen, net = [], srv._net
    srv._net = lambda m, x: seen.append(net(m, x)) or seen[-1]
    try:
        with torch.inference_mode():
            got = srv.forward_u8(x8)
    finally:
        del srv._net  # the class's method again
    y = seen[0]
    t = (y.float().clamp(0.0, 1.0) * 255.0).to(y.dtype)
    t = (t.float() + 0.5).to(y.dtype)
    want = t.float().trunc().clamp(0.0, 255.0).to(torch.uint8)
    return int((got != want.permute(0, 2, 3, 1)).sum())


def _winner_serve(asset: str, lrs, hrs, tmp: str) -> dict:
    """``serve --architecture auto --checkpoint asset --warmup --dtype
    float32`` in this process, TF32 off: the five LR PNGs over HTTP and
    the small ones scored on the card, counted from zero; then predict on
    the same PNGs. Returns the responses, outputs, scores and launches."""
    from food101_sr_tpu_torch import native, predict, serve
    from food101_sr_tpu_torch.metrics import MetricsCalculator
    from food101_sr_tpu_torch.ops import full_fp32

    a = serve.parse_args(["--architecture", "auto", "--checkpoint", asset,
                          "--warmup", "--dtype", "float32"])
    bodies = [native.encode_png_rgb8(x) for x in lrs]
    pred_in, pred_out = os.path.join(tmp, "in"), os.path.join(tmp, "out")
    os.makedirs(pred_in)
    for i, b in enumerate(bodies):
        with open(os.path.join(pred_in, f"w{i}.png"), "wb") as f:
            f.write(b)
    metrics = MetricsCalculator(device="cuda")
    out = {}
    with full_fp32():
        srv, default = serve.build_servers(a)
        httpd = None
        try:
            t0 = time.perf_counter()
            srv.warmup()
            out["warmup_s"] = time.perf_counter() - t0
            httpd = serve.SRHTTPServer(("127.0.0.1", 0),
                                       serve.make_handler(srv, default))
            thread = threading.Thread(target=httpd.serve_forever, daemon=True)
            thread.start()
            torch.cuda.synchronize()
            # ---- main path: counts from zero -----------------------------
            _zero_counts()
            b0 = srv.batcher.n_batches
            res, out["wall_s"] = _burst(httpd.server_address[1], "/sr",
                                        bodies, HTTP_THREADS)
            out["batches"] = srv.batcher.n_batches - b0
            sr = [native.decode_image(r[2]) for r in res]
            out["scores"] = [metrics.compute(
                sr[i][None].astype(np.float32) / 255,
                hrs[i][None].astype(np.float32) / 255)
                for i in range(WINNER_SMALL)]
            torch.cuda.synchronize()
            out["launches"] = _counts()
            # ---- end of main path ----------------------------------------
            out["n_blocks"] = srv.model.num_residuals
            out["architecture"] = srv.architecture
        finally:
            if httpd is not None:
                httpd.shutdown()
                httpd.server_close()
                thread.join(timeout=60)
            srv.close()
        # ---- main path: predict on the same PNGs, counts from zero -------
        _zero_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            predict.main([pred_in, "--out_dir", pred_out, "--architecture",
                          "auto", "--checkpoint", asset, "--dtype",
                          "float32"])
        torch.cuda.synchronize()
        out["predict_launches"] = _counts()
        out["predict_s"] = time.perf_counter() - t0
        # ---- end of main path --------------------------------------------
    out["predict"] = json.loads(buf.getvalue().strip().splitlines()[-1])
    out["predict_bytes"] = []
    for i in range(len(lrs)):
        with open(os.path.join(pred_out, f"w{i}_x4.png"), "rb") as f:
            out["predict_bytes"].append(f.read())
    out["responses"], out["sr"] = res, sr
    return out


def _winner_dtypes(asset: str, lrs) -> dict:
    """The production servers on the winner: bf16, and bf16 with
    ``--quantize int8``, on the small inputs, each counted from zero; and
    the bf16 net's SE inputs on one device batch of the small inputs'
    tiles (a forward hook on every SE block; none in a net without
    them), for K2."""
    from food101_sr_tpu_torch.serving import SRServer

    out = {"sr": {}, "launches": {}, "batches": {}}
    for mode in ("", "int8"):
        srv = SRServer("auto", checkpoint=asset, device="cuda",
                       dtype=torch.bfloat16, quantize=mode)
        try:
            srv.warmup([(srv.tile, srv.tile)])
            torch.cuda.synchronize()
            # ---- main path: counts from zero -----------------------------
            _zero_counts()
            b0 = srv.batcher.n_batches
            with cf.ThreadPoolExecutor(WINNER_SMALL) as pool:
                out["sr"][mode] = list(pool.map(srv.upscale,
                                                lrs[:WINNER_SMALL]))
            torch.cuda.synchronize()
            out["launches"][mode] = _counts()
            out["batches"][mode] = srv.batcher.n_batches - b0
            # ---- end of main path ----------------------------------------
            out.setdefault("rule_diff", {})[mode] = _u8_rule_diff(
                srv, lrs[:WINNER_SMALL])
            if mode:
                continue
            out["se_inputs"] = se_in = []
            blocks = [m for n, m in srv.model.named_modules()
                      if n.endswith(".se")]
            if not blocks:
                continue
            tiles = [_tile(x, srv.tile) for x in lrs[:WINNER_SMALL]]
            x8 = torch.from_numpy(np.stack(
                (tiles * srv.batcher.max_batch)[:srv.batcher.max_batch])).cuda()
            hooks = [m.register_forward_hook(
                lambda mod, inp, o: se_in.append(inp[0].detach().clone()))
                for m in blocks]
            try:
                srv.forward_u8(x8)
            finally:
                for h in hooks:
                    h.remove()
        finally:
            srv.close()
    return out


def _winner_export(asset: str, arch: str, lrs, tmp: str) -> dict:
    """``export_serving --architecture auto --checkpoint asset --shapes
    64x64 --check`` (bf16, batch AOT_BATCH), then the program from
    ``load_bucket`` on the small inputs' tiles (the first one's in row 0),
    counted from zero, against the eager bf16 forward: byte-equal, as the
    aot phase holds the seeded net's."""
    from food101_sr_tpu_torch import export_serving
    from food101_sr_tpu_torch.serving import SRServer

    out_dir = os.path.join(tmp, "aot")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        summary = export_serving.main([
            "--architecture", "auto", "--checkpoint", asset, "--out",
            out_dir, "--shapes", "64x64", "--batch", str(AOT_BATCH),
            "--check"])
    export_s = time.perf_counter() - t0
    with open(os.path.join(out_dir, "manifest.json")) as f:
        man = json.load(f)
    if not (summary["checked"] == 1 and len(man["buckets"]) == 1
            and man["architecture"] == arch
            and man["dtype"] == "bfloat16"):
        raise AssertionError(f"winner: export manifest {man}")
    prog = export_serving.load_bucket(
        os.path.join(out_dir, man["buckets"][0]["file"]), "cuda")
    live = SRServer("auto", checkpoint=asset, device="cuda",
                    dtype=torch.bfloat16, max_batch=AOT_BATCH)
    try:
        tiles = [_tile(x, live.tile) for x in lrs[:WINNER_SMALL]]
        x = torch.from_numpy(np.stack(
            (tiles * AOT_BATCH)[:AOT_BATCH])).cuda()
        eager = live.forward_u8(x)
        torch.cuda.synchronize()
        # ---- main path: one program call, counts from zero ---------------
        _zero_counts()
        got = prog(x)
        torch.cuda.synchronize()
        launches = _counts()
        # ---- end of main path --------------------------------------------
        equal = bool(torch.equal(got, eager))
    finally:
        live.close()
    return {"export_s": export_s, "mb": man["buckets"][0]["bytes"] / 1e6,
            "equal": equal, "launches": launches}


def _winner_tune(asset: str, arch: str, tag: str, tmp: str,
                 se_blocks: int) -> dict:
    """``train --architecture arch --pretrained_weights asset`` with
    WINNER_TUNES[tag] on the mini tree for one epoch, counted from zero:
    the generator handed to its train state before any step equals the
    asset bit for bit (a recording subclass of the loop's SRTrainState;
    BatchNorm running stats included), every logged loss is finite, the
    guard skipped nothing, launches as the closed form (``se_blocks`` SE
    squeezes a forward)."""
    from food101_sr_tpu_torch import train as train_cli
    from food101_sr_tpu_torch.training import loop

    seen = {}

    class Recording(loop.SRTrainState):
        @classmethod
        def create(cls, model, *args, **kw):
            seen.setdefault("g", {k: v.detach().cpu().clone()
                                  for k, v in model.state_dict().items()})
            return super().create(model, *args, **kw)

    runs, w = os.path.join(tmp, "runs"), os.path.join(tmp, f"w_{tag}")
    old_env, old_state = os.environ.get("FOOD101_SR_RUN_DIR"), loop.SRTrainState
    os.environ["FOOD101_SR_RUN_DIR"] = runs
    loop.SRTrainState = Recording
    t0 = time.perf_counter()
    try:
        # ---- main path: one fine-tune, counts from zero ------------------
        _zero_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            final = train_cli.main([
                "--dataset", "food101", "--data_root", JPEG_ASSETS,
                "--architecture", arch, *WINNER_TUNES[tag],
                "--epochs", "1", "--batch_size", str(WINNER_BATCH),
                "--crop_size", str(WINNER_CROP), "--pretrained_weights",
                asset, "--save_name", f"winner_{tag}", "--weights_dir", w,
                "--log_every", "1", "--run_name", f"winner_{tag}",
                "--use_wandb", "false"])
        torch.cuda.synchronize()
        launches = _counts()
        # ---- end of main path --------------------------------------------
    finally:
        loop.SRTrainState = old_state
        if old_env is None:
            os.environ.pop("FOOD101_SR_RUN_DIR", None)
        else:
            os.environ["FOOD101_SR_RUN_DIR"] = old_env
    wall = time.perf_counter() - t0
    sd = torch.load(asset, weights_only=True)
    if not (seen.get("g", {}).keys() >= sd.keys() and all(
            torch.equal(seen["g"][k], v) for k, v in sd.items())):
        raise AssertionError(f"winner {tag}: the generator before the first "
                             "step is not the asset")
    with open(os.path.join(runs, f"winner_{tag}", "log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    steps = [r for r in recs if "train_loss" in r]
    (epoch,) = [r for r in recs if "epoch" in r]
    nb = _loop_batches(16, 4, {"seed": 0, "batch_size": WINNER_BATCH})
    args = WINNER_TUNES[tag]
    loss = (args[args.index("--loss_function") + 1]
            if "--loss_function" in args else "nlpd")
    d_steps = (len(range(0, nb["steps"], loop.DEFAULTS["d_update_every"]))
               if loss == "gan" else 0)
    # the test metrics' NLPD; an NLPD loss adds 4 forward and 4 backward
    # blurs a step and 4 a val batch
    want = ((8 * nb["steps"] + 4 * nb["val"] if loss == "nlpd" else 0)
            + 4 * nb["test"],
            se_blocks * (nb["steps"] + d_steps + nb["val"] + nb["test"]), 0)
    losses = [v for r in steps for k, v in r.items() if "loss" in k]
    if not (launches == want and len(steps) == nb["steps"]
            and all(np.isfinite(losses))
            and all(r.get(k, 0) == 0 for r in steps
                    for k in ("nonfinite_steps", "nonfinite_steps_D"))
            and epoch["nonfinite_total"] == 0
            and all(np.isfinite(list(final.values())))):
        raise AssertionError(f"winner {tag}: launches {launches} (expected "
                             f"{want}), {len(steps)} logged steps, losses "
                             f"{losses}, epoch {epoch}, final {final}")
    return {"launches": launches, "steps": nb["steps"], "d_steps": d_steps,
            "step_ms": epoch["time/step_ms"], "train_loss": [
                r["train_loss"] for r in steps], "final": final,
            "wall_s": wall}


def _winner_k2(rates, se_inputs) -> dict:
    """K2 NHWC on the trained net's bf16 SE inputs (every block's, one
    device batch) within one bf16 ulp of its plain version, timed on the
    first."""
    from food101_sr_tpu_torch.ops.spatial_mean import (mean_nhwc_kernel,
                                                       spatial_mean_plain)

    ulp = err2 = 0.0
    for x in se_inputs:
        if not (x.dtype == torch.bfloat16
                and x.is_contiguous(memory_format=torch.channels_last)):
            raise AssertionError(f"winner: SE input {x.dtype} {x.shape}")
        got, want = mean_nhwc_kernel(x).float(), spatial_mean_plain(x).float()
        ulp = max(ulp, ((got - want).abs() / _ulp_bf16(want)).max().item())
        err2 = max(err2, (got - want).abs().max().item())
    if not ulp <= 1.0:
        raise AssertionError(f"winner: K2 on the SE inputs, {ulp} ulp")
    x = se_inputs[0]
    k2 = _timings(lambda: mean_nhwc_kernel(x), lambda: spatial_mean_plain(x),
                  lambda: x.mean((2, 3)), launches=1)
    k2["bound_ms"], k2["bound_by"] = bound(
        2 * x.numel() + 2 * x.shape[0] * x.shape[1], x.numel(), rates)
    k2.update(ulp=ulp, max_abs_err=err2, at=f"{tuple(x.shape)} bfloat16 channels-last, the "
              f"trained winner's SE inputs ({len(se_inputs)} blocks, one "
              "device batch of the small inputs' tiles)")
    return k2


def _winner_k1(rates, sr, hrs, what: str) -> dict:
    """K1 forward and backward on the scoring pyramids of the served
    outputs ``sr`` against their HRs (pred and target of one image, 4
    levels) within K1_TOL, timed on the first image's."""
    from food101_sr_tpu_torch.ops.gaussian import depthwise_blur

    gen = torch.Generator(device="cuda").manual_seed(43)
    pyrs = []
    for s, h in zip(sr, hrs, strict=True):
        lv = torch.from_numpy(np.stack([s, h])).cuda().permute(
            0, 3, 1, 2).float().contiguous() / 255
        pyr = []
        for _ in range(4):
            pyr.append(lv)
            lv = depthwise_blur(lv)[:, :, ::2, ::2].contiguous()
        pyrs.append(pyr)
    err = max(_k1_err(p, gen) for p in pyrs)
    if not err <= K1_TOL:
        raise AssertionError(f"winner: K1 on the scoring pyramids, {err}")
    k1 = _k1_timings(pyrs[0], rates)
    sides = ",".join(f"{p.shape[2]}x{p.shape[3]}" for p in pyrs[0])
    k1.update(max_abs_err=err, at=f"(2,3,{{{sides}}}) float32, the scoring "
              f"pyramid of one served output and its HR; checked at {what}")
    return k1


def _winner_leg(name: str, spec: dict, tmp: str) -> dict:
    """One winner through the port's entry points (module docstring,
    phase 8b), each run counted from zero: serve and predict, the bf16 and
    int8 servers, the export, the fine-tunes. Checks every result against
    JAX's goldens and prints the winner's lines; returns its outputs,
    launches by run and numbers."""
    from food101_sr_tpu_torch.metrics import MetricsCalculator

    t_leg = time.perf_counter()
    asset = os.path.join(ASSETS, f"winner_{name}.pth")
    arch = spec["arch"]
    lrs, srs, hrs, gold = _winner_goldens(spec)
    small = range(WINNER_SMALL)
    tmp = os.path.join(tmp, name)
    os.makedirs(tmp)
    runs = {}
    serve = _winner_serve(asset, lrs, hrs, tmp)
    n_blocks = serve["n_blocks"]
    se = n_blocks if arch == "AttentionSR" else 0  # SE squeezes a forward
    runs["serve"] = serve["launches"]
    runs["predict"] = serve["predict_launches"]
    prod = _winner_dtypes(asset, lrs)
    runs.update({f"bf16{m and '_' + m}": c
                 for m, c in prod["launches"].items()})
    aot = None
    if spec["export"]:
        aot = _winner_export(asset, arch, lrs, tmp)
        runs["aot"] = aot["launches"]
    tunes = {tag: _winner_tune(asset, arch, tag, tmp, se)
             for tag in spec["tunes"]}
    runs.update({f"tune_{t}": r["launches"] for t, r in tunes.items()})

    # the served outputs against JAX's float32 goldens, the tiled one too
    sr = serve["sr"]
    levels = [_levels(s, g) for s, g in zip(sr, srs)]
    if not (serve["architecture"] == arch
            and all(r[1]["Content-Type"] == "image/png"
                    for r in serve["responses"])
            and max(levels) <= LEVEL_TOL):
        raise AssertionError(f"winner {name}: served vs JAX goldens "
                             f"{levels} levels ({serve['architecture']})")
    if serve["launches"] != (4 * WINNER_SMALL, se * serve["batches"], 0):
        raise AssertionError(f"winner {name}: serve launches "
                             f"{serve['launches']} for {serve['batches']} "
                             f"device batches and {WINNER_SMALL} NLPD calls")
    # the port's scores against JAX's, and against the CPU calculator's
    cpu = MetricsCalculator(device="cpu")
    plain = [cpu.compute(sr[i][None].astype(np.float32) / 255,
                         hrs[i][None].astype(np.float32) / 255)
             for i in small]
    got = {k: np.array([s[k] for s in serve["scores"]])
           for k in ("psnr", "ssim", "lpips", "nlpd")}
    dist = {"psnr_db": float(np.abs(got["psnr"] - gold["psnr"]).max()),
            "ssim": float(np.abs(got["ssim"] - gold["ssim"]).max()),
            **{f"{k}_rel": float((np.abs(got[k] - gold[k])
                                  / np.abs(gold[k])).max())
               for k in ("lpips", "nlpd")}}
    card_cpu = {k: max(abs(s[k] - p[k]) / abs(p[k])
                       for s, p in zip(serve["scores"], plain))
                for k in ("lpips", "nlpd")}
    if not (dist["psnr_db"] <= WINNER_PSNR_DB and dist["ssim"] <= WINNER_SSIM
            and dist["lpips_rel"] <= WINNER_RTOL
            and dist["nlpd_rel"] <= WINNER_RTOL
            and card_cpu["nlpd"] <= NLPD_RTOL
            and card_cpu["lpips"] <= LPIPS_RTOL):
        raise AssertionError(f"winner {name}: scores {got} against JAX's "
                             f"{gold} ({dist}), card vs CPU {card_cpu}")
    # the production dtypes' PSNR costs against the port's own float32
    f32 = np.array([_psnr_u8(sr[i], hrs[i]) for i in small])
    jax_f32 = np.array([_psnr_u8(srs[i], hrs[i]) for i in small])
    costs = {}
    for mode, key, tol in (("", "bf16", WINNER_BF16_DB),
                           ("int8", "int8", spec["int8_db"])):
        p = np.array([_psnr_u8(y, hrs[i])
                      for i, y in enumerate(prod["sr"][mode])])
        port, jax = float(np.mean(f32 - p)), float(
            np.mean(jax_f32 - gold[f"psnr_{key}"]))
        costs[key] = {"port_db": port, "jax_db": jax, "psnr": p.tolist(),
                      "rule_diff": prod["rule_diff"][mode]}
        if prod["rule_diff"][mode]:
            raise AssertionError(f"winner {name}: the {key} server's output "
                                 f"has {prod['rule_diff'][mode]} bytes off "
                                 "the JAX server's uint8 rule")
        if not abs(port - jax) <= tol:
            raise AssertionError(f"winner {name}: the {key} PSNR cost "
                                 f"{port:.4f} dB against JAX's {jax:.4f}")
        if prod["launches"][mode] != (0, se * prod["batches"][mode], 0):
            raise AssertionError(f"winner {name}: {key} server launches "
                                 f"{prod['launches'][mode]} for "
                                 f"{prod['batches'][mode]} device batches")
    ref = np.concatenate([x.ravel() for x in sr[:WINNER_SMALL]]).astype(
        np.float64)
    q8 = np.concatenate([x.ravel() for x in prod["sr"]["int8"]]).astype(
        np.float64)
    costs["int8"]["snr_db"] = float(10 * np.log10(
        np.mean(ref * ref) / np.mean((q8 - ref) ** 2)))
    costs["int8"]["jax_snr_db"] = float(gold["snr_int8"])
    # predict: byte-equal to the server's responses
    pred_launches = runs["predict"]
    if not (serve["predict"]["n_images"] == len(lrs)
            and serve["predict"]["failed"] == 0
            and serve["predict_bytes"] == [r[2] for r in serve["responses"]]
            and pred_launches[0] == pred_launches[2] == 0
            and ((pred_launches[1] % se == 0 and pred_launches[1] > 0)
                 if se else pred_launches[1] == 0)):
        raise AssertionError(f"winner {name}: predict {serve['predict']}, "
                             f"launches {pred_launches}, outputs byte-equal "
                             f"{[a == r[2] for a, r in zip(serve['predict_bytes'], serve['responses'])]}")
    # the exported program against the eager bf16 forward
    if aot is not None and not (aot["equal"]
                                and aot["launches"] == (0, se, 0)):
        raise AssertionError(f"winner {name}: exported program {aot}")
    numbers = {
        "winner": name, "architecture": arch,
        "levels_f32_vs_jax": levels, "batches": serve["batches"],
        "http_images_per_s": len(lrs) / serve["wall_s"],
        "warmup_s": serve["warmup_s"],
        "scores": {k: v.tolist() for k, v in got.items()},
        "jax_scores": {k: gold[k].tolist() for k in
                       ("psnr", "ssim", "lpips", "nlpd")},
        "distance_to_jax": dist, "card_vs_cpu_rel": card_cpu,
        "psnr_f32": f32.tolist(), "costs": costs,
        "predict": {**serve["predict"], "s": serve["predict_s"]},
        "export": aot and {k: aot[k] for k in ("export_s", "mb", "equal")},
        "tunes": {t: {k: r[k] for k in ("steps", "d_steps", "step_ms",
                                        "train_loss", "final", "wall_s")}
                  for t, r in tunes.items()},
        "launches": runs, "leg_s": time.perf_counter() - t_leg}
    print(f"winner: {arch} x4 asset winner_{name}.pth, f32 over HTTP (TF32 "
          f"off) vs JAX goldens {levels} level(s) ({serve['batches']} device"
          f" batches, the 200x152 one tiled) | psnr "
          f"{np.round(got['psnr'], 4).tolist()} vs JAX: "
          f"{dist['psnr_db']:.2g} dB, ssim {dist['ssim']:.2g}, lpips rel "
          f"{dist['lpips_rel']:.2g}, nlpd rel {dist['nlpd_rel']:.2g} | card "
          f"vs CPU calculator: lpips {card_cpu['lpips']:.2g}, nlpd "
          f"{card_cpu['nlpd']:.2g} | PSNR cost bf16 "
          f"{costs['bf16']['port_db']:.4f} dB (JAX "
          f"{costs['bf16']['jax_db']:.4f}), int8 "
          f"{costs['int8']['port_db']:.4f} (JAX {costs['int8']['jax_db']:.4f})"
          f", int8 SNR {costs['int8']['snr_db']:.2f} dB (JAX "
          f"{costs['int8']['jax_snr_db']:.2f}) | uint8 rule: bf16 "
          f"{costs['bf16']['rule_diff']}, int8 {costs['int8']['rule_diff']} "
          "bytes off JAX's", flush=True)
    print(f"winner: {name}: predict byte-equal to the server ({len(lrs)} "
          f"images, {serve['predict_s']:.1f} s)"
          + (f" | export 64x64 bf16 in {aot['export_s']:.1f} s "
             f"({aot['mb']:.1f} MB), the program byte-equal to eager, K2 "
             f"{aot['launches'][1]}" if aot else "")
          + "".join(f" | {t}: {r['steps']} steps from the asset (bit-equal),"
                    f" step {r['step_ms']:.1f} ms, losses "
                    f"{np.round(r['train_loss'], 5).tolist()}, launches "
                    f"{r['launches']}" for t, r in tunes.items())
          + f" | launches {runs} | {numbers['leg_s']:.1f} s", flush=True)
    print("winner numbers: " + json.dumps(numbers), flush=True)
    return {"runs": runs, "sr": sr[:WINNER_SMALL], "hrs": hrs,
            "se_inputs": prod["se_inputs"], "n_blocks": n_blocks,
            "costs": costs}


def phase_winner(rates, k1: dict, k2: dict) -> dict:
    """The trained winners through the port's entry points (module
    docstring, phase 8b), then visualize's default table. Returns the
    launches of the counted runs by kernel and winner, and the kernels
    line's new rows."""
    from food101_sr_tpu_torch import visualize

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_winner_") as tmp:
        legs = {name: _winner_leg(name, spec, tmp)
                for name, spec in WINNERS.items()}
        # ---- main path: visualize's default table, counts from zero -----
        _zero_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the absent winners' rows
            times = visualize.run_comparison(
                dataset="synthetic", num_examples=WINNER_VIS, seed=0,
                out_dir=os.path.join(tmp, "report"))
        torch.cuda.synchronize()
        vis = _counts()
        # ---- end of main path -------------------------------------------

    # visualize: the SRCNN, ResNetSR and AttentionSR rows on the assets
    want_vis = (0, legs["attentionsr"]["n_blocks"] * _vis_forwards(WINNER_VIS),
                0)
    if not (set(times) == {"SRCNN", "RESNET", "AttentionSR"}
            and vis == want_vis):
        raise AssertionError(f"winner: visualize models {set(times)}, "
                             f"launches {vis} (expected {want_vis})")
    vis_ms = {n: float(np.mean(t) * 1e3) for n, t in times.items()}
    by_winner = {name: [sum(c[j] for c in leg["runs"].values())
                        for j in range(3)] for name, leg in legs.items()}
    by_winner["visualize"] = list(vis)
    resnet = [n for n, spec in WINNERS.items() if spec["arch"] == "RESNET"]
    if any(by_winner[n][1] or by_winner[n][2] for n in resnet):
        raise AssertionError(f"winner: K2 launched on a ResNetSR batch "
                             f"{by_winner}")

    attn = legs["attentionsr"]
    k2_row = _winner_k2(rates, attn["se_inputs"])
    k1_row = _winner_k1(rates, attn["sr"], attn["hrs"],
                        f"the {WINNER_SMALL} small inputs' sizes")
    k1_resnet = _winner_k1(
        rates, [s for n in resnet for s in legs[n]["sr"]],
        [h for n in resnet for h in legs[n]["hrs"]],
        f"both ResNetSR winners' {WINNER_SMALL} small outputs")
    for row, d in ((k1_row, k1), (k2_row, k2), (k1_resnet, k1)):
        row.update({key: d[key] for key in ("route", "source", "replaces",
                                            "wrapper")})
    k1_row.update(name="K1 depthwise Gaussian blur 5x5, the winner's "
                       "scoring pyramids",
                  launches=by_winner["attentionsr"][0] + vis[0])
    k2_row.update(name="K2 spatial mean (SE squeeze), nhwc input, the "
                       "trained winner",
                  launches=by_winner["attentionsr"][1] + vis[1])
    k1_resnet.update(name="K1 depthwise Gaussian blur 5x5, the ResNetSR "
                          "winners' scoring pyramids",
                     launches=sum(by_winner[n][0] for n in resnet))
    costs = {n: legs[n]["costs"]["int8"] for n in resnet}
    print("winner: ResNetSR int8 PSNR cost on the card (bf16 server with "
          "--quantize int8 against the port's float32, mean of the "
          f"{WINNER_SMALL} small inputs): "
          + ", ".join(f"{n} {c['port_db']:.4f} dB (JAX {c['jax_db']:.4f})"
                      for n, c in costs.items())
          + f" | visualize ms/image {vis_ms} | K2 on the SE inputs "
          f"{k2_row['ulp']:.2g} ulp, K1 on the scoring pyramids "
          f"{k1_row['max_abs_err']:.2g} (AttentionSR), "
          f"{k1_resnet['max_abs_err']:.2g} (ResNetSR) | launches by winner "
          f"{by_winner} | {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"by_winner": {key: {n: c[j] for n, c in by_winner.items()}
                          for j, key in enumerate(
                              ("K1", "K2 nhwc", "K2 nchw"))},
            "rows": [k1_row, k2_row, k1_resnet]}


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


def _loop_batches(n: int | None = None, n_test: int | None = None,
                  cfg: dict = LOOP_CFG) -> dict:
    """Batch counts and sizes of a loop's loaders, from ``cfg`` (the loop
    phase's by default) by train()'s own rules: a 10% val split of the n
    training images, a test source of n_test images (the synthetic
    source's n // 4 by default), and eval batches clamped to the split."""
    from food101_sr_tpu_torch.data import subset_indices, train_val_split

    seed, batch = cfg["seed"], cfg["batch_size"]
    n = cfg["synthetic_size"] if n is None else n
    train_idx, val_idx = train_val_split(subset_indices(n, 1.0, seed), 0.1,
                                         seed + 1)
    n_test = max(n // 4, 8) if n_test is None else n_test
    val_b, test_b = min(batch, len(val_idx)), min(batch, n_test)
    return {"steps": len(train_idx) // batch, "val_batch": val_b,
            "val": len(val_idx) // val_b, "test_batch": test_b,
            "test": n_test // test_b}


def _kernels_at(crop: int, batches, where: str, seed: int = 9) -> tuple:
    """K1 (forward and backward) on the NLPD pyramids of pred and target
    at each batch of ``batches`` (2b, 3, {crop .. crop/8}^2) and the NHWC
    K2 entry on the SE squeeze (b, 96, crop/4, crop/4), against their
    plain versions; raises past K1_TOL or K2_RTOL. Returns the largest
    errors (K1 abs, K2 abs, K2 relative) and the inputs by batch."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pyrs = {b: [torch.rand((2 * b, 3, crop >> i, crop >> i), device="cuda",
                           generator=gen) for i in range(4)] for b in batches}
    err1 = max(_k1_err(pyr, gen) for pyr in pyrs.values())
    rel2, err2, xs = 0.0, 0.0, {}
    for b in batches:
        r, e, xs[b] = _k2_nhwc_err((b, 96, crop // 4, crop // 4), gen)
        rel2, err2 = max(rel2, r), max(err2, e)
    if not (err1 <= K1_TOL and rel2 <= K2_RTOL):
        raise AssertionError(f"at {where} shapes K1 is off by {err1}, "
                             f"K2 nhwc by {rel2} relative")
    return err1, err2, rel2, pyrs, xs


def _loop_kernels(nb: dict, rates) -> dict:
    """K1 (forward and backward) and the NHWC K2 entry against their plain
    versions at every shape the loop gives them: NLPD pyramids of pred and
    target at the train, val and test batches, and the SE squeeze at those
    batches; both timed at the val batch (the train and test batches'
    shapes are the train phase's)."""
    crop, batch = LOOP_CFG["crop_size"], LOOP_CFG["batch_size"]
    batches = sorted({batch, nb["val_batch"], nb["test_batch"]})
    err1, err2, rel2, pyrs, xs = _kernels_at(crop, batches, "the loop's")
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
    package's digests (each JPEG's decode_jpeg_rgb8 against its
    binding's, or refused where it refuses; every stream's decode_image
    against its server's PIL decode, or refused as it refuses; each lossy
    WebP's Y/U/V planes against libwebp's),
    its region digests at the committed regions, both encode digests,
    and random region decodes of the mini tree (an arithmetic-coded and a
    CMYK image among them) against full-decode-then-crop."""
    from food101_sr_tpu_torch import native

    with open(os.path.join(JPEG_ASSETS, "goldens.json")) as f:
        goldens = json.load(f)
    checked = 0
    streams = {}
    for name, g in goldens["streams"].items():
        with open(os.path.join(JPEG_ASSETS, g["file"]), "rb") as f:
            data = streams[name] = f.read()
        if g.get("served_refused"):
            try:
                native.decode_image(data)
            except native.UnsupportedImage:
                raise AssertionError(f"{name}: 415, the JAX server 400s")
            except ValueError:
                pass
            else:
                raise AssertionError(f"{name} served; the JAX server "
                                     "refuses it")
        elif sha256(native.decode_image(data)) != g["served_sha256"]:
            raise AssertionError(f"stream {name}: decode_image differs from "
                                 "the JAX server's")
        if "yuv_sha256" in g and sha256(np.concatenate(
                [p.ravel() for p in native.decode_webp_yuv(data)])) != \
                g["yuv_sha256"]:
            raise AssertionError(f"stream {name}: Y/U/V planes differ from "
                                 "libwebp's")
        if g.get("binding_refused"):
            try:
                native.decode_jpeg_rgb8(data)
            except native.UnsupportedImage:
                checked += 1
                continue
            raise AssertionError(f"{name} decoded; the JAX package's "
                                 "binding refuses it")
        px = (native.decode_jpeg_rgb8(data) if g["file"].endswith(".jpg")
              else native.decode_image(data))
        if list(px.shape) != g["shape"] or sha256(px) != g["sha256"]:
            raise AssertionError(f"stream {name}: {px.shape} decode differs "
                                 "from the JAX package's")
        checked += 1
    # streams the JAX server decodes and the port refuses by name (415)
    for name, g in goldens.get("port_refused", {}).items():
        with open(os.path.join(JPEG_ASSETS, g["file"]), "rb") as f:
            data = f.read()
        try:
            native.decode_image(data)
        except native.UnsupportedImage as e:
            if g["refusal"] not in str(e):
                raise AssertionError(f"{name}: 415 without naming "
                                     f"{g['refusal']}: {e}")
        else:
            raise AssertionError(f"{name} decoded; the port has no decoder "
                                 f"for {g['refusal']}")
    for c in goldens["crops"]:
        got = native.decode_jpeg_crop_rgb8(streams[c["stream"]], c["x0"],
                                           c["y0"], c["cw"], c["ch"])
        if sha256(got) != c["sha256"]:
            raise AssertionError(f"{c['stream']}: region {c} differs from "
                                 "the JAX package's")
    for g in goldens["encode"]:
        img = jpeg_test_image(g["h"], g["w"], g["seed"])
        if sha256(native.encode_jpeg_rgb8(img, g["quality"])) != g["sha256"]:
            raise AssertionError(f"encode {g['w']}x{g['h']} q{g['quality']} "
                                 "differs from the JAX package's bytes")
    rng = np.random.default_rng(21)
    tree = os.path.join(JPEG_ASSETS, "food-101", "images")
    files = sorted(os.path.join(d, f) for d, _, fs in os.walk(tree)
                   for f in fs)
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
            "webp_512x384": streams["webp_512x384"],
            "refused": sum(bool(g.get("served_refused"))
                           for g in goldens["streams"].values()),
            "region_goldens": len(goldens["crops"]),
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
        # the same size as a lossy WebP upload (q60, 7.8 KB)
        "decode_webp_512x384_ms": host_us(
            lambda: native.decode_image(fx["webp_512x384"]), 1, 50) / 1e3,
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
    print(f"food101: {fx['streams']} streams (JPEG, PNG, GIF, BMP, WebP) "
          f"decode to the JAX package's digests, {fx['refused']} refused "
          f"as it refuses them, {fx['region_goldens']} regions equal its region "
          f"decodes, {fx['encodes']} encodes byte-equal, {fx['crops']} region "
          f"decodes equal full-then-crop | loader over the mini tree (one "
          f"arithmetic-coded and one CMYK image): {lg['batches']} train and "
          f"{lg['batches']} eval batches equal JAX's | train() AttentionSR x4 on {FOOD_TRAIN} + "
          f"{FOOD_TEST} JPEGs ({nb['steps']} steps of "
          f"{LOOP_CFG['batch_size']}, crop {crop}, {n_ep} epochs): launches "
          f"(K1, K2 nhwc, K2 plane) {total}, final psnr {final['psnr']:.4f} "
          f"| images/s with the loader {numbers['train_images_per_s']} "
          f"(synthetic, same process: {loop['images_per_s']}) | decode "
          f"{w}x{h} 4:2:0 {numbers['decode_full_ms']:.3f} ms, 200^2 crop "
          f"{numbers['decode_crop_ms']:.3f} ms, {w}x{h} lossy WebP "
          f"{numbers['decode_webp_512x384_ms']:.3f} ms | encode q90 "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in
                      numbers["encode_ms"].items())
          + f" | loader alone {numbers['loader_batches_per_s']:.2f} batches/s "
          f"({LOADER_THREADS} threads) | CLI (no --dataset, SRCNN, subset "
          f"{FOOD_CLI_SUBSET}) psnr {cli_out['psnr']:.4f} | "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print("food101 numbers: " + json.dumps(numbers), flush=True)
    return {"K1": total[0], "K2 nhwc": total[1], "K2 nchw": total[2],
            "images_per_s": numbers["train_images_per_s"],
            "loader_wait_ms": numbers["loader_wait_ms"]}


def _window_of(crop: np.ndarray, canvas: np.ndarray) -> bool:
    """Whether uint8 HWC ``crop`` is a window of ``canvas`` or of its
    mirror image: candidate offsets from the crop's first row, then the
    whole window compared."""
    k = crop.shape[0]
    for c in (canvas, canvas[:, ::-1]):
        rows = np.lib.stride_tricks.sliding_window_view(c, k, axis=1)
        # rows[t, l] is c[t, l:l + k] as (3, k)
        hits = np.argwhere((rows[:c.shape[0] - k + 1]
                            == crop[0].T[None, None]).all(axis=(2, 3)))
        if any(np.array_equal(c[t:t + k, l:l + k], crop) for t, l in hits):
            return True
    return False


def _cache_loaders(root: str) -> dict:
    """On the food tree: each cache's eval batches (val split) byte-equal
    to SRDataLoader's, and the first train batch of the device cache and
    of the host canvas loader made of windows of its canvases (flipped or
    not). Returns the counts checked."""
    from food101_sr_tpu_torch.data import (DeviceCacheLoader, Food101Source,
                                           HostCanvasLoader, SRDataLoader,
                                           subset_indices, train_val_split)

    seed, batch, crop = LOOP_CFG["seed"], LOOP_CFG["batch_size"], \
        LOOP_CFG["crop_size"]
    src = Food101Source(root, "train")
    train_idx, val_idx = train_val_split(subset_indices(len(src), 1.0, seed),
                                         0.1, seed + 1)
    vb = min(batch, len(val_idx))
    kw = dict(crop_size=crop, batch_size=vb, train=False, seed=seed,
              device="cuda")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_store_") as store:
        want = [b.cpu() for b in SRDataLoader(src, val_idx, **kw)]
        for loader in (DeviceCacheLoader(src, val_idx, **kw),
                       HostCanvasLoader(src, val_idx, cache_dir=store, **kw)):
            got = [b.cpu() for b in loader]
            if not (len(got) == len(want) and all(
                    torch.equal(a, b) for a, b in zip(got, want))):
                raise AssertionError(f"{type(loader).__name__} eval batches "
                                     "differ from SRDataLoader's")
        kw.update(batch_size=batch, train=True)
        dev = DeviceCacheLoader(src, train_idx, **kw)
        host = HostCanvasLoader(src, train_idx, cache_dir=store, **kw)
        order = np.random.default_rng((seed, 0, 7)).permutation(
            len(train_idx))[:batch]
        n = 0
        for loader, canv in ((dev, dev._cache[torch.from_numpy(order).cuda()]
                              .cpu().numpy()),
                             (host, np.stack([host.store.canvases[
                                 host.store.row_for(i)]
                                 for i in train_idx[order]]))):
            loader.set_epoch(0)
            first = next(iter(loader)).cpu().numpy()
            if not all(_window_of(c, v) for c, v in zip(first, canv)):
                raise AssertionError(f"{type(loader).__name__}: a train crop "
                                     "is no window of its canvas")
            n += len(first)
    return {"eval_batches": len(want), "crops": n}


def phase_caches(tmp: str, loop: dict, food: dict) -> dict:
    """bf16 training and the dataset caches through train() (module
    docstring, phase 13b), in the loop phase's process after the food101
    phase: each run's main path counted from zero around it. ``loop`` is
    phase_loop's result, ``food`` phase_food101's (its SRDataLoader run
    on the same tree, for the same-process comparison)."""
    from food101_sr_tpu_torch.models import get_model
    from food101_sr_tpu_torch.training import load_checkpoint, train

    t0 = time.perf_counter()
    root = os.path.join(tmp, "food")
    runs = os.environ["FOOD101_SR_RUN_DIR"]
    w = os.path.join(tmp, "weights")
    store = os.path.join(tmp, "store")
    n_blocks, n_ep = loop["n_blocks"], LOOP_CFG["epochs"]
    syn, nb = _loop_batches(), _loop_batches(FOOD_TRAIN, FOOD_TEST)

    def closed_form(nb, n_ep, bf16):
        # a bf16 pred gets its own pyramid: 8 K1 forward and 4 backward a
        # step, 8 a val batch; the test metrics' NLPD casts to float32 (4)
        step, val = (12, 8) if bf16 else (8, 4)
        return (n_ep * (step * nb["steps"] + val * nb["val"])
                + 4 * nb["test"],
                n_blocks * (n_ep * (nb["steps"] + nb["val"]) + nb["test"]), 0)

    def run(name, cfg):
        _zero_counts()  # ---- main path: one train() run ----
        final = train({**cfg, "save_name": name, "run_name": name})
        total = _counts()  # ---- end of main path ----
        if not (set(final) == {"psnr", "ssim", "lpips", "nlpd", "val_psnr"}
                and all(np.isfinite(list(final.values())))):
            raise AssertionError(f"caches {name}: final metrics {final}")
        with open(os.path.join(runs, name, "log.jsonl")) as f:
            epochs = [r for r in map(json.loads, f) if "epoch" in r]
        return final, total, epochs

    def resumed_equal(name, cfg):
        part = train({**cfg, "save_name": f"{name}p", "run_name": f"{name}p",
                      "preempt_after_updates": CACHE_PREEMPT})
        train({**cfg, "save_name": f"{name}r", "run_name": f"{name}r",
               "resume": os.path.join(w, f"{name}p_last.pth")})
        full = _flat(load_checkpoint(os.path.join(w, f"{name}_last.pth")))
        res = _flat(load_checkpoint(os.path.join(w, f"{name}r_last.pth")))
        diff = sorted(set(full) ^ set(res)) or [
            k for k in full if not _same(full[k], res[k])]
        if not part.get("preempted") or diff:
            raise AssertionError(f"caches {name}: preempted {part}, resumed "
                                 f"state differs at {diff[:5]}")
        return sum(isinstance(t, torch.Tensor) for t in full.values())

    out, launches = {}, {}
    # bf16 on the loop's synthetic settings, one epoch
    cfg = {**LOOP_CFG, "dtype": "bfloat16", "epochs": 1, "weights_dir": w}
    final, total, epochs = run("bf16", cfg)
    if total != closed_form(syn, 1, True):
        raise AssertionError(f"caches bf16: launches {total}, expected "
                             f"{closed_form(syn, 1, True)}")
    sd = load_checkpoint(os.path.join(w, "bf16_best.pth"), "cuda")
    best = get_model("AttentionSR", device="cuda")
    best.load_state_dict(sd, strict=True)
    if any(v.dtype != torch.float32 for v in sd.values()):
        raise AssertionError("caches bf16: the best checkpoint is not "
                             "float32")
    launches["bf16"] = total
    out["bf16"] = {"final": final, "epochs": epochs}

    checks = _cache_loaders(root)
    food_cfg = {**LOOP_CFG, "dataset": "food101", "data_root": root,
                "weights_dir": w}
    kinds = (("cdev", {"cache_device": True}),
             ("chost", {"cache_host": store}),
             ("chost2", {"cache_host": store}),
             ("cwin", {"cache_host": store, "cache_host_reuse": 4}),
             ("bf16cdev", {"cache_device": True, "dtype": "bfloat16"}))
    for name, extra in kinds:
        final, total, epochs = run(name, {**food_cfg, **extra})
        want = closed_form(nb, n_ep, "dtype" in extra)
        if total != want:
            raise AssertionError(f"caches {name}: launches (K1, K2 nhwc, K2 "
                                 f"plane) {total}, expected {want}")
        launches[name] = total
        out[name] = {"final": final, "epochs": epochs}
    n_resumed = {name: resumed_equal(name, {**food_cfg, **extra})
                 for name, extra in kinds if name in ("cdev", "cwin")}

    def per_epoch(name, key):
        return [r[key] for r in out[name]["epochs"]]

    setup = {k: per_epoch(k, "time/loader_setup_s")[0] * 1e3
             for k in ("cdev", "chost", "chost2", "cwin")}
    if not setup["chost2"] < setup["chost"]:
        raise AssertionError(f"caches: the second cache_host run took "
                             f"{setup['chost2']} ms to open the store, the "
                             f"first {setup['chost']} ms to build it")
    numbers = {
        "srdataloader_images_per_s": food["images_per_s"],
        "srdataloader_wait_ms": food["loader_wait_ms"],
        **{f"{k}_images_per_s": per_epoch(k, "time/images_per_s")
           for k, _ in kinds},
        **{f"{k}_wait_ms": per_epoch(k, "time/loader_wait_ms")
           for k, _ in kinds},
        **{f"{k}_step_ms": per_epoch(k, "time/step_ms") for k, _ in kinds},
        "setup_ms": setup,
        "bf16_synthetic_images_per_s": per_epoch("bf16", "time/images_per_s"),
        "f32_synthetic_images_per_s": loop["images_per_s"],
        "launches": launches, "resumed_tensors": n_resumed, **checks}
    print(f"caches: train(dtype=bfloat16) AttentionSR x4 synthetic, 1 "
          f"epoch: launches {launches['bf16']}, best checkpoint float32 "
          f"loads strict, images/s {numbers['bf16_synthetic_images_per_s']}"
          f" (f32 {loop['images_per_s']}) | on {FOOD_TRAIN} + {FOOD_TEST} "
          f"JPEGs, images/s per epoch: SRDataLoader {food['images_per_s']}, "
          + ", ".join(f"{k} {numbers[f'{k}_images_per_s']}" for k, _ in kinds)
          + " | wait ms/step: SRDataLoader " + str(food["loader_wait_ms"])
          + ", " + ", ".join(f"{k} {numbers[f'{k}_wait_ms']}"
                             for k, _ in kinds)
          + f" | setup ms: {setup} | eval batches byte-equal to "
          f"SRDataLoader's ({checks['eval_batches']} a cache), {checks['crops']}"
          f" train crops windows of their canvases | preempted after "
          f"{CACHE_PREEMPT} and resumed bit-equal: {n_resumed} tensors | "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print("caches numbers: " + json.dumps(numbers), flush=True)
    return {k: {"K1": v[0], "K2 nhwc": v[1], "K2 nchw": v[2]}
            for k, v in launches.items()}


def _u8(y: torch.Tensor) -> torch.Tensor:
    """A net's output rounded to uint8 in float32: clamp, x255, round."""
    return (y.float().clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def _counts() -> tuple[int, int, int]:
    from food101_sr_tpu_torch.ops import (blur_kernel, mean_nhwc_kernel,
                                          mean_plane_kernel)

    return (blur_kernel.launches, mean_nhwc_kernel.launches,
            mean_plane_kernel.launches)


def _zero_counts() -> None:
    from food101_sr_tpu_torch.ops import (blur_kernel, mean_nhwc_kernel,
                                          mean_plane_kernel)

    blur_kernel.launches = 0
    mean_nhwc_kernel.launches = mean_plane_kernel.launches = 0


def phase_tails() -> dict:
    """The phase-space upsample tail on the card (module docstring, phase
    14). Returns the phase's numbers and its launches by kernel."""
    from food101_sr_tpu_torch.models import get_model
    from food101_sr_tpu_torch.ops import full_fp32

    t0 = time.perf_counter()
    cl = torch.channels_last
    gen = torch.Generator(device="cuda").manual_seed(12)
    xs = {s: torch.rand((TAIL_BATCH, 3, s, s), device="cuda", generator=gen)
          for s in TAIL_SIDES}
    rows, layout, n_blocks = [], [], 0
    # ---- main path: every forward of the phase, counts from zero ----
    _zero_counts()
    for arch in TAIL_ARCHS:
        for dtype in (torch.float32, torch.bfloat16):
            nets = {pt: get_model(arch, device="cuda", dtype=dtype,
                                  phase_tail=pt,
                                  generator=torch.Generator().manual_seed(0))
                    for pt in (False, True)}
            if arch == "AttentionSR":
                n_blocks = nets[False].num_residuals
            for s in TAIL_SIDES:
                x = xs[s].to(dtype).contiguous(memory_format=cl)
                c = nets[False].input_conv.out_channels
                feat = torch.randn((TAIL_BATCH, c, s, s), device="cuda",
                                   generator=gen).to(dtype) \
                    .contiguous(memory_format=cl)
                with torch.inference_mode(), full_fp32():
                    raw = {pt: m(x).float() for pt, m in nets.items()}
                    fwd = {pt: cuda_ms(lambda m=m: m(x), TAIL_ITERS, 1)
                           for pt, m in nets.items()}
                    tail = {pt: cuda_ms(
                        lambda m=m: m.output_conv(m.upsample(feat)),
                        TAIL_ITERS, 1) for pt, m in nets.items()}
                lv = _levels(_u8(raw[True]).cpu().numpy(),
                             _u8(raw[False]).cpu().numpy())
                rel = ((raw[True] - raw[False]).abs().max()
                       / raw[False].abs().max()).item()
                del raw
                if dtype == torch.float32 and not rel <= TAIL_F32_RTOL:
                    raise AssertionError(f"tail: {arch} {s}^2 float32 phase "
                                         f"tail {rel:.3g} of the peak from "
                                         "the materialized one")
                rows.append({"arch": arch, "dtype": str(dtype)[6:],
                             "side": s, "levels": lv, "rel_err": rel,
                             "fwd_ms": fwd[False], "fwd_phase_ms": fwd[True],
                             "tail_ms": tail[False],
                             "tail_phase_ms": tail[True]})
                print(f"tail: {arch} {str(dtype)[6:]} {TAIL_BATCH}x{s}^2: "
                      f"phase vs materialized {lv} level(s), {rel:.3g} of "
                      f"the peak | forward "
                      f"{fwd[False]:.3f} -> {fwd[True]:.3f} ms | tail alone "
                      f"{tail[False]:.3f} -> {tail[True]:.3f} ms", flush=True)
            # ROADMAP fault 2: channels-last against NCHW in bf16
            if arch == "AttentionSR" and dtype == torch.bfloat16:
                for pt, m in nets.items():
                    nchw = get_model(arch, device="cuda", dtype=dtype,
                                     phase_tail=pt,
                                     generator=torch.Generator().manual_seed(0))
                    nchw.to(memory_format=torch.contiguous_format)
                    nchw.memory_format = torch.contiguous_format
                    for s in TAIL_SIDES:
                        x = xs[s].to(dtype)
                        with torch.inference_mode():
                            lv = _levels(
                                _u8(m(x.contiguous(memory_format=cl)))
                                .cpu().numpy(),
                                _u8(nchw(x.contiguous())).cpu().numpy())
                        layout.append({"phase_tail": pt, "side": s,
                                       "levels": lv})
                    del nchw
            del nets
    torch.cuda.synchronize()
    launches = _counts()
    # ---- end of main path ----
    # AttentionSR: per dtype and side, 2 nets x (1 + 1 warm-up + the timed
    # forwards) channels-last; the layout check's 2 tails x sides forwards
    # channels-last and as many NCHW (the plane entry); the tails alone
    # have no SE block
    n_cl = 2 * len(TAIL_SIDES) * 2 * (2 + TAIL_ITERS) + 2 * len(TAIL_SIDES)
    want = (0, n_blocks * n_cl, n_blocks * 2 * len(TAIL_SIDES))
    if launches != want:
        raise AssertionError(f"tail: launches (K1, K2 nhwc, K2 plane) "
                             f"{launches}, expected {want}: {n_blocks} per "
                             "AttentionSR forward")
    print("tail: bf16 AttentionSR channels-last vs NCHW (ROADMAP fault 2): "
          + ", ".join(f"{'phase' if r['phase_tail'] else 'materialized'} "
                      f"{r['side']}^2 {r['levels']} level(s)"
                      for r in layout)
          + f" | launches (K1, K2 nhwc, K2 plane) {launches} | "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    numbers = {"rows": rows, "layout_levels": layout}
    print("tail numbers: " + json.dumps(numbers), flush=True)
    return {"launches": {"K1": launches[0], "K2 nhwc": launches[1],
                         "K2 nchw": launches[2]}, **numbers}


def _int8_card_vs_cpu() -> dict:
    """The int8 GEMM's int32 accumulators and int8_conv2d's output on the card against the CPU's on the same
    tensors, at every body conv shape of the three nets; largest output
    difference (bit-equal expected: the same float ops on the same
    integers)."""
    from food101_sr_tpu_torch.ops import quantize as q

    gen = torch.Generator(device="cuda").manual_seed(13)
    checked, out_err = [], 0.0
    for arch, shapes in QUANT_SHAPES.items():
        for cin, cout in shapes:
            x = torch.randn((QUANT_BATCH, cin, 64, 64), device="cuda",
                            generator=gen).contiguous(
                                memory_format=torch.channels_last)
            w = torch.randn((cout, cin, 3, 3), device="cuda", generator=gen)
            b = torch.randn((cout,), device="cuda", generator=gen)
            xq, _ = q.quantize_per_sample(x)
            wq, _ = q.quantize_kernel_per_cout(w)
            xq_cpu, _ = q.quantize_per_sample(x.cpu())
            if not torch.equal(xq.cpu(), xq_cpu):
                raise AssertionError(f"quant: {arch} {cin}->{cout} "
                                     "activations quantize differently")
            got = q.int8_accumulators(xq, wq, 1)
            if not torch.equal(got.cpu(), q.int8_accumulators(xq_cpu,
                                                              wq.cpu(), 1)):
                raise AssertionError(f"quant: {arch} {cin}->{cout} int32 "
                                     "accumulators differ from the CPU's")
            y = q.int8_conv2d(x, w, b)
            y_cpu = q.int8_conv2d(x.cpu(), w.cpu(), b.cpu())
            out_err = max(out_err, (y.cpu() - y_cpu).abs().max().item())
            checked.append(f"{cin}->{cout}")
    return {"shapes": checked, "max_abs_err": out_err}


def _serve_int8(arch: str, rng) -> dict:
    """SRServer(arch, quantize="int8") in bf16: QUANT_REQUESTS 64x64
    requests from HTTP_THREADS threads, each within LEVEL_TOL of a direct
    int8 forward of its input; then the int8 and the bf16 server's
    outputs on QUANT_HR seeded HR images degraded x4 (SNR of int8 against
    bf16, and each one's PSNR against the HR)."""
    from food101_sr_tpu_torch.ops import degrade_bicubic
    from food101_sr_tpu_torch.serving import SRServer

    servers = {mode: SRServer(arch, device="cuda", dtype=torch.bfloat16,
                              quantize=mode,
                              generator=torch.Generator().manual_seed(0))
               for mode in ("int8", "")}
    try:
        for srv in servers.values():
            srv.warmup([(64, 64)])
        srv = servers["int8"]
        imgs = [rng.integers(0, 256, (64, 64, 3), np.uint8)
                for _ in range(QUANT_REQUESTS)]
        b0 = srv.batcher.n_batches
        with cf.ThreadPoolExecutor(max_workers=HTTP_THREADS) as pool:
            t0 = time.perf_counter()
            outs = list(pool.map(srv.upscale, imgs))
            wall = time.perf_counter() - t0
        batches = srv.batcher.n_batches - b0
        lv = max(_levels(o, _direct(srv, i)) for i, o in zip(imgs, outs))
        if lv > LEVEL_TOL:
            raise AssertionError(f"quant: {arch} int8 served vs direct int8 "
                                 f"forward: {lv} levels")
        hr = torch.from_numpy(rng.integers(0, 256, (QUANT_HR, 256, 256, 3),
                                           np.uint8)).cuda()
        lr = degrade_bicubic(hr.permute(0, 3, 1, 2).float() / 255, 4)
        lr8 = list(_u8(lr).permute(0, 2, 3, 1).cpu().numpy())
        sr = {m: np.stack([s.upscale(i) for i in lr8]).astype(np.float64)
              for m, s in servers.items()}
        ref = hr.cpu().numpy().astype(np.float64)
        err = np.mean((sr["int8"] - sr[""]) ** 2)
        snr = float(10 * np.log10(np.mean(sr[""] ** 2) / max(err, 1e-12)))

        def psnr(a):
            return float(10 * np.log10(255.0 ** 2 / np.mean((a - ref) ** 2)))

        return {"requests": len(imgs), "batches": batches,
                "n_blocks": getattr(srv.model, "num_residuals", 0),
                "images_per_s": len(imgs) / wall, "levels_vs_direct": lv,
                "snr_int8_vs_bf16_db": snr, "psnr_int8": psnr(sr["int8"]),
                "psnr_bf16": psnr(sr[""])}
    finally:
        for s in servers.values():
            s.close()


def _quant_http(rng, tmp: str) -> dict:
    """``serve --quantize int8`` (the registry AttentionSR, seeded, bf16)
    behind SRHTTPServer in this process: HTTP_REQUESTS 64x64 PNGs from
    HTTP_THREADS client threads, each response equal to the server's
    upscale; then ``predict --quantize int8`` on QUANT_PREDICT PNGs, each
    output within LEVEL_TOL of that server's upscale."""
    from food101_sr_tpu_torch import native, predict, serve

    a = serve.parse_args(["--quantize", "int8", "--architecture",
                          "AttentionSR", "--warmup_sizes", "64x64"])
    srv, _ = serve.build_servers(a)
    httpd = None
    try:
        srv.warmup([(64, 64)])
        httpd = serve.SRHTTPServer(("127.0.0.1", 0), serve.make_handler(srv))
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        port = httpd.server_address[1]
        health = json.loads(_http(port, "/healthz")[2])
        if health["models"]["default"]["quantize"] != "int8":
            raise AssertionError(f"quant: /healthz {health}")
        imgs = [rng.integers(0, 256, (64, 64, 3), np.uint8)
                for _ in range(HTTP_REQUESTS)]
        b0 = srv.batcher.n_batches
        res, wall = _burst(port, "/sr", [native.encode_png_rgb8(x)
                                         for x in imgs], HTTP_THREADS)
        batches = srv.batcher.n_batches - b0
        bucket = _bucket("64x64 PNG int8", res, wall)
        for img, r in zip(imgs, res):
            if not np.array_equal(native.decode_image(r[2]),
                                  srv.upscale(img)):
                raise AssertionError("quant: an HTTP response differs from "
                                     "upscale")
        d_in, d_out = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        os.makedirs(d_in)
        pimgs = [rng.integers(0, 256, (64, 64, 3), np.uint8)
                 for _ in range(QUANT_PREDICT)]
        for i, img in enumerate(pimgs):
            with open(os.path.join(d_in, f"q{i}.png"), "wb") as f:
                f.write(native.encode_png_rgb8(img))
        t0 = time.perf_counter()
        predict.main([d_in, "--out_dir", d_out, "--quantize", "int8"])
        pred_s = time.perf_counter() - t0
        lv = 0
        for i, img in enumerate(pimgs):
            with open(os.path.join(d_out, f"q{i}_x4.png"), "rb") as f:
                lv = max(lv, _levels(native.decode_image(f.read()),
                                     srv.upscale(img)))
        if lv > LEVEL_TOL:
            raise AssertionError(f"quant: predict --quantize int8 is {lv} "
                                 "levels from the server")
        return {**bucket, "batches": batches, "predict_s": pred_s,
                "predict_levels": lv}
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        srv.close()


def _quant_forwards() -> dict:
    """Forward ms (CUDA events) of each net at QUANT_BATCH x QUANT_SIDE^2
    in bf16 with the int8 and int8_dot bodies and without, the phase tail
    on (the server's default)."""
    from food101_sr_tpu_torch.models import get_model

    gen = torch.Generator(device="cuda").manual_seed(14)
    x = torch.rand((QUANT_BATCH, 3, QUANT_SIDE, QUANT_SIDE), device="cuda",
                   generator=gen).to(torch.bfloat16) \
        .contiguous(memory_format=torch.channels_last)
    out = {}
    for arch in QUANT_SHAPES:
        for mode in ("int8", "int8_dot", ""):
            m = get_model(arch, device="cuda", dtype=torch.bfloat16,
                          quantize=mode, phase_tail=True,
                          generator=torch.Generator().manual_seed(0))
            with torch.inference_mode():
                out[f"{arch} {mode or 'bf16'}"] = cuda_ms(lambda: m(x), 5, 1)
            del m
    return out


def _qat_steps() -> dict:
    """One QAT train step and one float step of the registry AttentionSR
    (phase tail, f32, NLPD, Adam 4e-4, TRAIN_BATCH x TRAIN_CROP^2 crops
    made on the device): the QAT net's raw gradients on GRAD_BATCH crops
    against the CPU's plain path (QAT_GRAD_TOL); per net GEN_WARMUP + GEN_TIMED steps
    under CUDA events, the first timed step counting the kernels'
    launches (K1 8, K2 nhwc 32), the loss on that one batch finite and
    falling."""
    from food101_sr_tpu_torch.losses import get_loss_function
    from food101_sr_tpu_torch.models import get_model
    from food101_sr_tpu_torch.training import (FIRST_LAST, SRTrainState,
                                               make_adam, make_train_step)

    gen = torch.Generator(device="cuda").manual_seed(15)
    hr_u8 = torch.randint(0, 256, (TRAIN_BATCH, TRAIN_CROP, TRAIN_CROP, 3),
                          dtype=torch.uint8, device="cuda", generator=gen)
    loss_fn = get_loss_function("nlpd")
    first, last = FIRST_LAST["AttentionSR"]
    out = {}
    for mode in ("", "qat"):
        model = get_model("AttentionSR", device="cuda", quantize=mode,
                          phase_tail=True,
                          generator=torch.Generator().manual_seed(0)).train()
        if mode:
            worst = _grad_check(model)
            err, leaf = worst["shared"]["term_sum"]
            if not err <= GRAD_TOL:
                raise AssertionError(f"quant: QAT gradients with the CPU's "
                                     "choices, card vs "
                                     f"CPU plain: {leaf} off by {err} of its "
                                     f"largest term sum (tol {GRAD_TOL})")
            err, leaf = worst["term_sum"]
            ch = worst["choices"]
            if not (err <= GRAD_TOL or ((ch["flips"] or ch["kinks"])
                                        and err <= QAT_GRAD_TOL)):
                raise AssertionError(f"quant: QAT gradients, card vs CPU "
                                     f"plain: {leaf} off by {err} of its "
                                     f"largest term sum with {ch['flips']} "
                                     f"int8 levels and {ch['kinks']} PReLU "
                                     "branches differing")
            out["grad_max_abs"] = worst["max_abs"]
            out["grad_term_sum"] = worst["term_sum"]
            out["grad_shared"] = worst["shared"]["term_sum"]
            out["grad_shared_max_abs"] = worst["shared"]["max_abs"]
            out["choices"] = worst["choices"]
        state = SRTrainState.create(model, make_adam(TRAIN_LR))
        step = make_train_step(model, loss_fn, 4, first, last)
        losses = []
        for _ in range(GEN_WARMUP):
            state, m = step(state, hr_u8)
            losses.append(m["train_loss"])
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(GEN_TIMED + 1)]
        ev[0].record()
        for i in range(GEN_TIMED):
            if i == 0:
                _zero_counts()
            state, m = step(state, hr_u8)
            if i == 0:
                launches = _counts()
            losses.append(m["train_loss"])
            ev[i + 1].record()
        ev[-1].synchronize()
        ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(GEN_TIMED)]
        losses = [float(v) for v in losses]
        if launches != (8, model.num_residuals, 0):
            raise AssertionError(f"quant: one {mode or 'f32'} step launched "
                                 f"{launches}")
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"quant: {mode or 'f32'} step losses "
                                 f"{losses} on one batch")
        out[f"{mode or 'f32'}_losses"] = losses
        out[f"{mode or 'f32'}_step_ms"] = float(np.mean(ms))
        out[f"{mode or 'f32'}_launches"] = launches
        del model, state, step
    return out


def _qat_loop(tmp: str, n_blocks: int) -> dict:
    """train(quantize="qat") with the loop phase's settings for one epoch
    (QAT_LOOP_CFG): its launches against the closed form, the per-step
    losses (each on its own batch) and the final metrics finite."""
    from food101_sr_tpu_torch.training import train

    runs = os.path.join(tmp, "runs")
    old = os.environ.get("FOOD101_SR_RUN_DIR")
    os.environ["FOOD101_SR_RUN_DIR"] = runs
    try:
        nb = _loop_batches()
        # ---- main path: one train(quantize="qat") run, counts from zero
        _zero_counts()
        final = train({**QAT_LOOP_CFG, "weights_dir":
                       os.path.join(tmp, "w"), "save_name": "qat",
                       "run_name": "qat"})
        launches = _counts()
        # ---- end of main path ----
    finally:
        if old is None:
            os.environ.pop("FOOD101_SR_RUN_DIR", None)
        else:
            os.environ["FOOD101_SR_RUN_DIR"] = old
    with open(os.path.join(runs, "qat", "log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["train_loss"] for r in recs if "train_loss" in r]
    epoch = [r for r in recs if "epoch" in r]
    steps = nb["steps"]
    want = (8 * steps + 4 * nb["val"] + 4 * nb["test"],
            n_blocks * (steps + nb["val"] + nb["test"]), 0)
    if launches != want:
        raise AssertionError(f"quant: train(qat) launched {launches}, "
                             f"expected {want}")
    if not (len(losses) == steps and all(np.isfinite(losses))
            and all(np.isfinite(list(final.values())))):
        raise AssertionError(f"quant: train(qat) losses {losses}, final "
                             f"{final}")
    return {"losses": losses, "final": final, "launches": launches,
            "images_per_s": epoch[-1]["time/images_per_s"],
            "step_ms": epoch[-1]["time/step_ms"]}


def phase_quant() -> dict:
    """int8 serving and QAT training on the card (module docstring, phase
    15). Returns the phase's numbers and its two main paths' launches."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(16)
    acc = _int8_card_vs_cpu()
    print(f"quant: int32 accumulators bit-equal to the CPU's at {QUANT_BATCH}x{{{', '.join(acc['shapes'])}}}x64^2; "
          f"int8_conv2d max abs diff {acc['max_abs_err']:.3g}", flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_quant_") as tmp:
        # ---- main path: int8 serving, counts from zero ----
        _zero_counts()
        served = {arch: _serve_int8(arch, rng) for arch in QUANT_SHAPES}
        http = _quant_http(rng, tmp)
        torch.cuda.synchronize()
        serve_launches = _counts()
        # ---- end of main path ----
        n_blocks = served["AttentionSR"]["n_blocks"]
        qat = _qat_loop(tmp, n_blocks)
    for arch, r in served.items():
        print(f"quant: SRServer({arch!r}, quantize='int8') bf16: "
              f"{r['requests']} 64x64 requests in {r['batches']} batches, "
              f"{r['images_per_s']:.1f} images/s, max {r['levels_vs_direct']}"
              f" level(s) from a direct int8 forward | {QUANT_HR} seeded HR "
              f"256^2 -> 64^2: int8 vs bf16 SNR {r['snr_int8_vs_bf16_db']:.2f}"
              f" dB, PSNR vs HR int8 {r['psnr_int8']:.4f} / bf16 "
              f"{r['psnr_bf16']:.4f} dB", flush=True)
    print(f"quant: serve --quantize int8 over HTTP: {http['requests']} 64x64 "
          f"PNGs from {HTTP_THREADS} threads, {http['images_per_s']:.1f} "
          f"images/s, p50 {http['p50_ms']:.1f} ms, p95 {http['p95_ms']:.1f} "
          f"ms, {http['batches']} batches, each response equal to upscale | "
          f"predict --quantize int8 on {QUANT_PREDICT} PNGs in "
          f"{http['predict_s']:.2f} s, {http['predict_levels']} level(s) "
          f"from the server | launches (K1, K2 nhwc, K2 plane) "
          f"{serve_launches}", flush=True)
    if (serve_launches[0] or serve_launches[2] or not serve_launches[1]
            or serve_launches[1] % n_blocks):
        raise AssertionError(f"quant: int8 serving launched {serve_launches}"
                             f": K2 nhwc {n_blocks} per AttentionSR forward "
                             "only")
    fwd = _quant_forwards()
    print("quant: forward ms at "
          f"{QUANT_BATCH}x{QUANT_SIDE}^2 bf16, phase tail: "
          + ", ".join(f"{k} {v:.3f}" for k, v in fwd.items()), flush=True)
    steps = _qat_steps()
    print(f"quant: QAT step (AttentionSR, phase tail, batch {TRAIN_BATCH}x"
          f"{TRAIN_CROP}^2) {steps['qat_step_ms']:.3f} ms against the f32 "
          f"step's {steps['f32_step_ms']:.3f} | QAT loss on one batch "
          f"{' '.join(f'{v:.6f}' for v in steps['qat_losses'])} | launches "
          "per step "
          f"{steps['qat_launches']} | QAT raw gradients vs CPU plain, with "
          "the CPU's choices: worst "
          f"{steps['grad_shared'][1]} {steps['grad_shared'][0]:.3g} of its "
          f"largest term sum (tol {GRAD_TOL}; over the max abs "
          f"{steps['grad_shared_max_abs'][1]} "
          f"{steps['grad_shared_max_abs'][0]:.3g}); on its own: "
          f"{steps['choices']['flips']} int8 levels of "
          f"{steps['choices']['elements']} differ (at most by "
          f"{steps['choices']['max_levels']}) and "
          f"{steps['choices']['kinks']} PReLU branches of "
          f"{steps['choices']['branches']}, worst "
          f"{steps['grad_term_sum'][1]} {steps['grad_term_sum'][0]:.3g} of "
          f"its largest term sum (tol {QAT_GRAD_TOL}; over the max abs "
          f"{steps['grad_max_abs'][1]} {steps['grad_max_abs'][0]:.3g})",
          flush=True)
    print(f"quant: train(quantize='qat') {QAT_LOOP_CFG['epochs']} epoch: "
          f"losses {' '.join(f'{v:.6f}' for v in qat['losses'])} | final "
          f"psnr {qat['final']['psnr']:.4f} | {qat['images_per_s']:.1f} "
          f"images/s, step {qat['step_ms']:.3f} ms | launches "
          f"{qat['launches']} | {time.perf_counter() - t0:.1f} s",
          flush=True)
    numbers = {"served": served, "http": http, "forward_ms": fwd,
               "steps": {k: v for k, v in steps.items()
                         if k.endswith("_ms")},
               "qat_grad": {k: steps[k] for k in (
                   "grad_shared", "grad_shared_max_abs", "grad_term_sum",
                   "grad_max_abs", "choices")},
               "qat_loop": {k: qat[k] for k in ("losses", "images_per_s",
                                                "step_ms")},
               "int8_max_abs_err": acc["max_abs_err"]}
    print("quant numbers: " + json.dumps(numbers), flush=True)
    return {"serve_launches": dict(zip(("K1", "K2 nhwc", "K2 nchw"),
                                       serve_launches)),
            "qat_launches": dict(zip(("K1", "K2 nhwc", "K2 nchw"),
                                     qat["launches"])), **numbers}


def _dp_reference(tmp: str) -> None:
    """The one-process step of each DP_ARCHS net on GRAD_BATCH seeded
    crops on the card, TF32 off: its raw gradients, the term sums of its
    leaves (recorded on the card), the buffers after it; saved under
    ``tmp`` for the ranks."""
    from food101_sr_tpu_torch.losses import nlpd_loss
    from food101_sr_tpu_torch.models import get_model
    from food101_sr_tpu_torch.ops import full_fp32
    from food101_sr_tpu_torch.training import loss_and_grads
    from food101_sr_tpu_torch.utils.term_sums import term_sums

    hr = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (GRAD_BATCH, TRAIN_CROP, TRAIN_CROP, 3), np.uint8))
    for arch in DP_ARCHS:
        model = get_model(arch, device="cuda", phase_tail=True,
                          generator=torch.Generator().manual_seed(0))
        rec: dict = {}
        with full_fp32(), term_sums(model, {}) as sums, \
                _branches({"": model}, rec, "record", {}):
            _, grads = loss_and_grads(model, nlpd_loss, 4, hr.cuda())
        torch.save({"hr": hr, "grads": [g.cpu() for g in grads],
                    "sums": sums, "buffers": {k: b.cpu() for k, b in
                                              model.named_buffers()},
                    "masks": {n: [m.cpu() for m in ms]
                              for n, ms in rec["masks"].items()}},
                   os.path.join(tmp, f"dp_ref_{arch}.pt"))


def _dp_step_checks(rank: int, tmp: str) -> dict:
    """A rank's part of the step check (module docstring, dp): K1 and K2
    at the rank's shapes against their plain versions; per DP_ARCHS net
    the averaged raw gradients on the rank's crop against the one-process
    step's, the running stats, and the timed step at DP_STEP_BATCH."""
    from food101_sr_tpu_torch.losses import nlpd_loss
    from food101_sr_tpu_torch.models import get_model
    from food101_sr_tpu_torch.ops import full_fp32
    from food101_sr_tpu_torch.parallel import data_sharding, distributed
    from food101_sr_tpu_torch.training import (FIRST_LAST, SRTrainState,
                                               loss_and_grads, make_adam,
                                               make_train_step)

    local = DP_STEP_BATCH // DP_RANKS
    gen = torch.Generator(device="cuda").manual_seed(9 + rank)
    sides = [TRAIN_CROP >> i for i in range(4)]
    err1 = _k1_err([torch.rand((2 * local, 3, s, s), device="cuda",
                               generator=gen) for s in sides], gen)
    rel2, err2, _ = _k2_nhwc_err((local, 96, TRAIN_CROP // 4,
                                  TRAIN_CROP // 4), gen)
    if not (err1 <= K1_TOL and rel2 <= K2_RTOL):
        raise AssertionError(f"dp rank {rank}: K1 off by {err1}, K2 nhwc "
                             f"by {rel2} relative")
    out = {"k1_max_abs_err": err1, "k2_max_abs_err": err2, "nets": {}}
    hr_big = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (DP_STEP_BATCH, TRAIN_CROP, TRAIN_CROP, 3), np.uint8))
    for arch in DP_ARCHS:
        ref = torch.load(os.path.join(tmp, f"dp_ref_{arch}.pt"),
                         weights_only=False)
        # this rank's rows of the one-process step's activation branches
        rec = {"masks": {n: [data_sharding(m) for m in ms]
                         for n, ms in ref["masks"].items()}}
        hr = data_sharding(ref["hr"]).contiguous().cuda()
        runs, kinks = {}, {}
        for mode in ("compare", "replay"):
            model = get_model(arch, device="cuda", phase_tail=True,
                              generator=torch.Generator().manual_seed(0))
            stats: dict = {}
            with full_fp32(), _branches({"": model}, rec, mode, stats):
                loss, grads = loss_and_grads(model, nlpd_loss, 4, hr)
                distributed.all_reduce_mean_([*grads, loss])
            names = [k for k, _ in model.named_parameters()]
            runs[mode] = _worst(names, grads, ref["grads"], ref["sums"])
            if mode == "compare":
                kinks = stats
                bufs = {k: b for k, b in model.named_buffers()
                        if k.endswith(("running_mean", "running_var"))}
                buf = max((((b.cpu() - ref["buffers"][k]).abs().max()
                            / ref["buffers"][k].abs().max()).item()
                           for k, b in bufs.items()), default=0.0)
        # as in the train phase, float rounding alone with the branches
        # shared; as run, an activation input next to 0 may take the other
        # branch at the other batch split, allowed past GRAD_TOL (to
        # DP_AS_RUN_TOL of a term sum) only when some rank counted such an
        # element
        flipped = distributed.agree(kinks["kinks"] > 0, "cuda")
        worst, as_run = runs["replay"], runs["compare"]
        within = (worst["term_sum"][0] <= GRAD_TOL if arch == "AttentionSR"
                  else worst["either"][0] <= 1.0)
        ok = within and (as_run["term_sum"][0] <= GRAD_TOL or (
            flipped and as_run["term_sum"][0] <= DP_AS_RUN_TOL))
        if not (ok and buf <= BUF_TOL):
            raise AssertionError(
                f"dp rank {rank} {arch}: averaged gradients against the "
                f"one-process step: branches shared {worst['term_sum']} of a "
                f"term sum ({worst['either']} of the tolerance), as run "
                f"{as_run['term_sum']} with {kinks['kinks']} of "
                f"{kinks['branches']} branches flipped; running stats {buf}")
        # the timed step: a fresh state at the global batch, this rank's
        # share of it
        model = get_model(arch, device="cuda", phase_tail=True,
                          generator=torch.Generator().manual_seed(0))
        state = SRTrainState.create(model, make_adam(TRAIN_LR))
        step = make_train_step(model, nlpd_loss, 4, *FIRST_LAST[arch])
        hr = data_sharding(hr_big).contiguous().cuda()
        for _ in range(DP_WARMUP):
            step(state, hr)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(DP_TIMED + 1)]
        ev[0].record()
        _zero_counts()
        for i in range(DP_TIMED):
            state, m = step(state, hr)
            if i == 0:
                launches = _counts()
            ev[i + 1].record()
        ev[-1].synchronize()
        ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(DP_TIMED)]
        grads = [p.grad for p in state.params]
        a0, a1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a0.record()
        for _ in range(DP_ALLREDUCE):
            distributed.all_reduce_mean_(grads)
        a1.record()
        a1.synchronize()
        out["nets"][arch] = {
            "grad_term_sum": worst["term_sum"], "grad_max_abs":
            worst["max_abs"], "grad_either": worst["either"],
            "as_run_term_sum": as_run["term_sum"],
            "as_run_either": as_run["either"],
            "branches_flipped": kinks["kinks"],
            "branches": kinks["branches"],
            "running_stats": buf, "step_ms": float(np.mean(ms)),
            "step_ms_min": min(ms), "step_ms_max": max(ms),
            "allreduce_ms": a0.elapsed_time(a1) / DP_ALLREDUCE,
            "allreduce_bytes": sum(g.numel() * 4 for g in grads),
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "launches": {"K1": launches[0], "K2 nhwc": launches[1],
                         "K2 nchw": launches[2]},
            "loss": float(m["train_loss"])}
        want_k2 = model.num_residuals if arch == "AttentionSR" else 0
        if launches != (8, want_k2, 0):
            raise AssertionError(f"dp rank {rank} {arch}: one step launched "
                                 f"(K1, K2 nhwc, K2 plane) {launches}")
        print(f"dp rank {rank} {arch}: averaged gradients, branches "
              f"shared, {worst['term_sum'][0]:.3g} of a term sum at "
              f"{worst['term_sum'][1]} (tol {GRAD_TOL}); as run "
              f"{as_run['term_sum'][0]:.3g} at {as_run['term_sum'][1]}, "
              f"{kinks['kinks']} of {kinks['branches']} branches flipped "
              f"on this rank; running stats "
              f"{buf:.2g} | step of {local} crops ({DP_STEP_BATCH} global) "
              f"{out['nets'][arch]['step_ms']:.3f} ms, all-reduce of "
              f"{out['nets'][arch]['allreduce_bytes'] / 2**20:.1f} MiB "
              f"{out['nets'][arch]['allreduce_ms']:.3f} ms, peak "
              f"{out['nets'][arch]['peak_bytes'] / 2**30:.3f} GiB, launches "
              f"{launches}", flush=True)
    return out


def _dp_runs(w: str) -> dict:
    """The state files of the uninterrupted and the resumed run must be
    equal, leaf for leaf; the checkpoints and logs written are rank 0's
    alone. Reads what the ranks wrote under ``w`` and the run directory."""
    from food101_sr_tpu_torch.training import load_checkpoint

    full = _flat(load_checkpoint(os.path.join(w, "dpA_last.pth")))
    resumed = _flat(load_checkpoint(os.path.join(w, "dpC_last.pth")))
    part = load_checkpoint(os.path.join(w, "dpB_last.pth"))["host"]
    diff = sorted(set(full) ^ set(resumed)) or [
        k for k in full if not _same(full[k], resumed[k])]
    if diff:
        raise AssertionError(f"dp: the resumed state differs from the "
                             f"uninterrupted one at {diff[:5]}")
    if (part["epoch"], part["batch"]) != (0, DP_SYNC):
        raise AssertionError(f"dp: the preempted run saved {part}")
    files = sorted(os.listdir(w))
    want = sorted(f"{n}_{k}.pth" for n in ("dpA", "dpB", "dpC")
                  for k in ("best", "last") if (n, k) != ("dpB", "best"))
    if files != want:
        raise AssertionError(f"dp: checkpoint files {files}, want {want}")
    return {"tensors": sum(isinstance(t, torch.Tensor)
                           for t in full.values())}


def _dp_loop_kernels(rank: int) -> dict:
    """K1 and K2 against their plain versions at the shapes a rank's
    train() gives them (DP_LOOP_CFG: its share of the train, val and test
    batches)."""
    nb = _loop_batches(cfg=DP_LOOP_CFG)
    crop = DP_LOOP_CFG["crop_size"]
    batches = sorted({b // DP_RANKS for b in (
        DP_LOOP_CFG["batch_size"], nb["val_batch"], nb["test_batch"])})
    err1, err2, rel2, _, _ = _kernels_at(crop, batches, f"dp rank {rank}'s "
                                         "train()", seed=29 + rank)
    sides = ",".join(str(crop >> i) for i in range(4))
    print(f"dp rank {rank} train() kernels: K1 fwd+bwd at "
          f"({','.join(str(2 * b) for b in batches)},3,{{{sides}}}^2) f32 "
          f"max_abs_err {err1:.3g} (tol {K1_TOL}) | K2 nhwc at "
          f"({','.join(map(str, batches))},96,{crop // 4},{crop // 4}) rel "
          f"err {rel2:.2g} (tol {K2_RTOL})", flush=True)
    return {"k1_max_abs_err": err1, "k2_max_abs_err": err2,
            "k2_rel_err": rel2, "batches": batches}


def _dp_train(rank: int, tmp: str) -> dict:
    """A rank's train() runs (module docstring, dp), deterministic; the
    uninterrupted one counted from zero."""
    from food101_sr_tpu_torch.training import train

    _deterministic()
    w = os.path.join(tmp, "w")
    cfg = {**DP_LOOP_CFG, "weights_dir": w}
    # ---- main path: train() on two ranks, counts from zero ----
    _zero_counts()
    full = train({**cfg, "save_name": "dpA", "run_name": "dpA"})
    launches = _counts()
    # ---- end of main path ----
    part = train({**cfg, "save_name": "dpB", "run_name": "dpB",
                  **({"preempt_after_updates": DP_PREEMPT} if rank == 0
                     else {})})
    resumed = train({**cfg, "save_name": "dpC", "run_name": "dpC",
                     "resume": os.path.join(w, "dpB_last.pth")})
    if not (part.get("preempted") and resumed == full
            and all(np.isfinite(list(full.values())))):
        raise AssertionError(f"dp rank {rank}: runs {full}, {part}, "
                             f"{resumed}")
    return {"final": full, "launches": {"K1": launches[0],
                                        "K2 nhwc": launches[1],
                                        "K2 nchw": launches[2]}}


def dp_rank_main(rank: int, port: str, tmp: str) -> int:
    """Entry of a dp rank's process (``chip_smoke.py --dp RANK PORT
    DIR``): the group from the explicit flags, the step check, train()."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import torch.distributed as dist

    from food101_sr_tpu_torch.parallel import distributed

    os.environ["FOOD101_SR_RUN_DIR"] = os.path.join(tmp, "runs")
    distributed.maybe_initialize(f"localhost:{port}", DP_RANKS, rank,
                                 device="cuda")
    out = {"backend": dist.get_backend(), "step": _dp_step_checks(rank, tmp)}
    out["loop_kernels"] = _dp_loop_kernels(rank)
    out["train"] = _dp_train(rank, tmp)
    with open(os.path.join(tmp, f"dp_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def dp_one_main(port: str, tmp: str) -> int:
    """Entry of the world of 1's process (``chip_smoke.py --dp-one PORT
    DIR``): train() alone, then train() from the explicit flags of a group
    of one (NCCL: the rank has the card to itself) and one NCCL all-reduce;
    the two runs' checkpoints must be bit-equal."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import torch.distributed as dist

    from food101_sr_tpu_torch.training import load_checkpoint, train

    _deterministic()
    os.environ["FOOD101_SR_RUN_DIR"] = runs = os.path.join(tmp, "runs1")
    w = os.path.join(tmp, "w1")
    cfg = {**DP_LOOP_CFG, "weights_dir": w}
    plain = train({**cfg, "save_name": "one", "run_name": "one"})
    group = train({**cfg, "save_name": "one_nccl", "run_name": "one_nccl",
                   "coordinator": f"localhost:{port}", "num_processes": 1,
                   "process_id": 0})
    one = torch.ones(1, device="cuda")
    dist.all_reduce(one)
    diff = []
    for n in ("best", "last"):
        a, b = (_flat(load_checkpoint(os.path.join(w, f"{s}_{n}.pth")))
                for s in ("one", "one_nccl"))
        if a.keys() != b.keys() or not all(_same(a[k], b[k]) for k in a):
            diff.append(n)
    if diff or plain != group or dist.get_backend() != "nccl" or \
            one.item() != 1.0:
        raise AssertionError(f"dp world of 1: checkpoints {diff} differ, "
                             f"finals {plain} {group}, backend "
                             f"{dist.get_backend()}, all-reduce {one.item()}")
    with open(os.path.join(runs, "one", "log.jsonl")) as f:
        ep = [r for r in map(json.loads, f) if "epoch" in r][0]
    with open(os.path.join(tmp, "dp_one.json"), "w") as f:
        json.dump({"images_per_s": ep["time/images_per_s"],
                   "step_ms": ep["time/step_ms"], "final": plain}, f)
    dist.destroy_process_group()
    return 0


def _dp_children(tmp: str) -> tuple[list, dict]:
    """The ranks' processes, then the world of 1's, each with the loop
    phase's cuBLAS setting and its output in a file of its own (the ranks
    advance in lockstep: an unread pipe would stall both); a child that
    outlives its time is killed. Prints the children's "dp" lines."""
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": LOOP_CUBLAS}
    me = os.path.abspath(__file__)

    def run(argvs, tag):
        logs = [os.path.join(tmp, f"{tag}{i}.log") for i in range(len(argvs))]
        procs = []
        try:
            for argv, log in zip(argvs, logs):
                with open(log, "w") as fh:
                    procs.append(subprocess.Popen(
                        [sys.executable, me, *argv], env=env, stdout=fh,
                        stderr=subprocess.STDOUT))
            rcs = [p.wait(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for log in logs:
            with open(log) as f:
                text = f.read()
            print("".join(ln + "\n" for ln in text.splitlines()
                          if ln.startswith(("dp ", "torch.distributed"))),
                  end="", flush=True)
            if any(rcs):
                print(text[-3000:], flush=True)
        if any(rcs):
            raise RuntimeError(f"dp: {tag} processes exited with {rcs}")

    port = str(_free_port())
    run([["--dp", str(r), port, tmp] for r in range(DP_RANKS)], "rank")
    ranks = []
    for r in range(DP_RANKS):
        with open(os.path.join(tmp, f"dp_rank{r}.json")) as f:
            ranks.append(json.load(f))
    run([["--dp-one", str(_free_port()), tmp]], "one")
    with open(os.path.join(tmp, "dp_one.json")) as f:
        return ranks, json.load(f)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dp_spatial(rates) -> dict:
    """The spatial paths and the mesh server on the card (module
    docstring, dp), with the K2 launches of the halo forward and the
    mesh server's traffic counted from zero; K2 against its plain version
    at every shape these paths give it (the halo windows, wide and
    narrow, the tiled forward's chunk of windows, a mesh server device's
    rows), timed at the wide halo window."""
    from food101_sr_tpu_torch.models import get_model
    from food101_sr_tpu_torch.ops import full_fp32
    from food101_sr_tpu_torch.parallel import (halo_sharded_forward_for,
                                               make_mesh, plan_windows,
                                               receptive_radius,
                                               tiled_forward_for)
    from food101_sr_tpu_torch.parallel.spatial import MAX_WINDOWS
    from food101_sr_tpu_torch.serving import SRServer

    mesh = make_mesh([torch.device("cuda", 0)] * DP_MESH)
    model = get_model("AttentionSR", device="cuda", phase_tail=True,
                      generator=torch.Generator().manual_seed(0)).eval()
    gen = torch.Generator(device="cuda").manual_seed(13)
    out = {}
    halo_fwd = halo_sharded_forward_for(model, "AttentionSR", 4, mesh)
    with full_fp32(), torch.no_grad():
        for key, shape, run in (
                ("halo", DP_HALO_SHAPE, halo_fwd),
                ("halo_narrow", DP_HALO_NARROW, halo_fwd),
                ("tiled", DP_TILED_SHAPE,
                 tiled_forward_for(model, "AttentionSR", 4, tile=DP_TILE))):
            x = torch.rand((1, 3, *shape), device="cuda", generator=gen) \
                .contiguous(memory_format=torch.channels_last)
            whole = _u8(model(x))
            torch.cuda.synchronize()
            _zero_counts()
            t0 = time.perf_counter()
            y = _u8(run(x))
            torch.cuda.synchronize()
            out[key] = {"levels": _levels(y.cpu().numpy(),
                                          whole.cpu().numpy()),
                        "launches": _counts(),
                        "ms": (time.perf_counter() - t0) * 1e3}
    radius = receptive_radius("AttentionSR", model)
    win = DP_HALO_SHAPE[0] // DP_MESH + 2 * radius
    starts_h, starts_w, win_h, win_w = plan_windows(*DP_TILED_SHAPE,
                                                    DP_TILE, radius)
    shapes = {"halo": (1, 96, win, DP_HALO_SHAPE[1]),
              "halo_narrow": (1, 96, win, DP_HALO_NARROW[1]),
              "tiled": (min(MAX_WINDOWS, len(starts_h) * len(starts_w)), 96,
                        win_h, win_w),
              "serve": (2, 96, 64, 64)}
    k2_errs = {}
    for key, shape in shapes.items():
        rel, err, xk = _k2_nhwc_err(shape, gen)
        k2_errs[key] = {"shape": shape, "rel_err": rel, "max_abs_err": err}
        if key == "halo":
            x = xk
    rel = max(e["rel_err"] for e in k2_errs.values())
    k2 = _k2_nhwc_timings(x, rates)
    k2["max_abs_err"] = max(e["max_abs_err"] for e in k2_errs.values())
    k2["rel_err"], k2["checked"] = rel, k2_errs
    rng = np.random.default_rng(17)
    imgs = [rng.integers(0, 256, (64, 64, 3), np.uint8)
            for _ in range(DP_SERVE_REQUESTS)]
    servers = [SRServer("AttentionSR", device="cuda", use_mesh=True,
                        mesh=mesh, max_batch=2 * DP_MESH,
                        generator=torch.Generator().manual_seed(0)),
               SRServer("AttentionSR", device="cuda", max_batch=2,
                        generator=torch.Generator().manual_seed(0))]
    try:
        for srv in servers:
            srv.warmup()
        _zero_counts()
        with cf.ThreadPoolExecutor(max_workers=8) as pool:
            t0 = time.perf_counter()
            meshed = list(pool.map(servers[0].upscale, imgs))
            torch.cuda.synchronize()
            t_mesh = time.perf_counter() - t0
        serve_launches = _counts()
        plain = [servers[1].upscale(i) for i in imgs]
    finally:
        for srv in servers:
            srv.close()
    same = all(np.array_equal(a, b) for a, b in zip(meshed, plain))
    if not (same and out["halo"]["levels"] <= LEVEL_TOL
            and out["tiled"]["levels"] <= LEVEL_TOL and rel <= K2_RTOL
            and out["halo"]["launches"] == (0, DP_MESH * model.num_residuals,
                                            0)):
        raise AssertionError(f"dp spatial: {out}, K2 at these paths' shapes "
                             f"{k2_errs}, mesh server bit-equal {same}")
    out["serve"] = {"images_per_s": len(imgs) / t_mesh,
                    "launches": serve_launches,
                    "batches": servers[0].batcher.n_batches}
    k2["at"] = (f"{tuple(x.shape)} float32 channels-last: one window of "
                f"halo_sharded_apply over {DP_MESH} x cuda:0")
    out["k2_halo"] = k2
    return out


def phase_dp(rates) -> dict:
    """Multi-GPU paths on the card (module docstring, dp): the ranks' step
    checks and train() runs in child processes, the world of 1 under
    NCCL in another, the spatial paths and the mesh server here."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()  # the children share the card
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        _dp_reference(tmp)
        ranks, one = _dp_children(tmp)
        runs = _dp_runs(os.path.join(tmp, "w"))
        logs = [d for d in os.listdir(os.path.join(tmp, "runs"))]
        with open(os.path.join(tmp, "runs", "dpA", "log.jsonl")) as f:
            rows = list(map(json.loads, f))
    if sorted(logs) != ["dpA", "dpB", "dpC"] or \
            sum("_config" in r for r in rows) != 1:
        raise AssertionError(f"dp: run logs {logs}, {rows[:2]}")
    if {r["backend"] for r in ranks} != {"gloo"}:
        raise AssertionError(f"dp: backends {[r['backend'] for r in ranks]}")
    ep = [r for r in rows if "epoch" in r][0]
    spatial = _dp_spatial(rates)
    gen = torch.Generator(device="cuda").manual_seed(19)
    local = DP_STEP_BATCH // DP_RANKS
    x = (torch.rand((local, 96, TRAIN_CROP // 4, TRAIN_CROP // 4),
                    device="cuda", generator=gen) * 2 - 0.5).contiguous(
        memory_format=torch.channels_last)
    k2_rank = _k2_nhwc_timings(x, rates)
    k2_rank["max_abs_err"] = max(max(r["step"]["k2_max_abs_err"],
                                     r["loop_kernels"]["k2_max_abs_err"])
                                 for r in ranks)
    numbers = {
        "step": {f"rank{i}": r["step"]["nets"] for i, r in enumerate(ranks)},
        "train": {"images_per_s_2_ranks": ep["time/images_per_s"],
                  "step_ms_2_ranks": ep["time/step_ms"],
                  "images_per_s_1_rank": one["images_per_s"],
                  "step_ms_1_rank": one["step_ms"],
                  "launches": {f"rank{i}": r["train"]["launches"]
                               for i, r in enumerate(ranks)},
                  "resumed_tensors_bit_equal": runs["tensors"]},
        "spatial": {k: spatial[k] for k in ("halo", "halo_narrow", "tiled",
                                            "serve")}}
    print("dp numbers: " + json.dumps(numbers), flush=True)
    print(f"dp: {DP_RANKS} ranks on one card (gloo) | step checks "
          f"{', '.join(DP_ARCHS)} pass on each rank | train() AttentionSR "
          f"x4 crop {DP_LOOP_CFG['crop_size']}, global batch "
          f"{DP_LOOP_CFG['batch_size']}: {ep['time/images_per_s']:.1f} "
          f"images/s on 2 ranks, {one['images_per_s']:.1f} on 1 (not a "
          f"speed claim: the ranks share the card); rank 0 preempted at "
          f"update {DP_PREEMPT}, both stopped after update {DP_SYNC}, the "
          f"resume bit-equal ({runs['tensors']} tensors); one writer, one "
          f"log per run | world of 1 under NCCL bit-equal to the plain run "
          f"| halo over {DP_MESH} x cuda:0 at {DP_HALO_SHAPE} "
          f"{spatial['halo']['levels']} level(s) from the whole image (at "
          f"{DP_HALO_NARROW}: {spatial['halo_narrow']['levels']}), tiled "
          f"{spatial['tiled']['levels']}, mesh server bit-equal | K2 nhwc "
          f"at " + ", ".join(f"{k} {tuple(e['shape'])} rel err "
                             f"{e['rel_err']:.2g}" for k, e in
                             spatial["k2_halo"]["checked"].items())
          + f" (tol {K2_RTOL}) | {time.perf_counter() - t0:.1f} s",
          flush=True)
    k2_rank.update({
        "name": "K2 spatial mean (SE squeeze), nhwc input, one data-"
                "parallel rank's train step",
        "route": "cuda", "source": "food101_sr_tpu_torch/csrc/kernels.cu",
        "replaces": "food101_sr_tpu/ops/spatial_mean.py:45",
        "wrapper": "food101_sr_tpu_torch/ops/spatial_mean.py:"
                   "mean_nhwc_kernel",
        "launches": ranks[0]["train"]["launches"]["K2 nhwc"],
        "dp_launches": {f"rank{i}": r["train"]["launches"]["K2 nhwc"]
                        for i, r in enumerate(ranks)},
        "at": f"({local},96,{TRAIN_CROP // 4},{TRAIN_CROP // 4}) float32 "
              f"channels-last: a rank's share of a global batch of "
              f"{DP_STEP_BATCH}; timed in the parent process"})
    k2_halo = spatial["k2_halo"]
    k2_halo.update({
        "name": "K2 spatial mean (SE squeeze), nhwc input, halo-sharded "
                "windows",
        "route": "cuda", "source": "food101_sr_tpu_torch/csrc/kernels.cu",
        "replaces": "food101_sr_tpu/ops/spatial_mean.py:45",
        "wrapper": "food101_sr_tpu_torch/ops/spatial_mean.py:"
                   "mean_nhwc_kernel",
        "launches": spatial["halo"]["launches"][1],
        "halo_launches": spatial["halo"]["launches"][1]})
    return {"dp_launches": {key: {f"rank{i}": r["train"]["launches"][key]
                                  for i, r in enumerate(ranks)}
                            for key in ("K1", "K2 nhwc", "K2 nchw")},
            "halo_launches": dict(zip(("K1", "K2 nhwc", "K2 nchw"),
                                      spatial["halo"]["launches"])),
            "k1_max_abs_err": max(max(r["step"]["k1_max_abs_err"],
                                      r["loop_kernels"]["k1_max_abs_err"])
                                  for r in ranks),
            "k2_rank": k2_rank, "k2_halo": k2_halo}


def _bench_cli() -> dict:
    """``python -m food101_sr_tpu_torch.bench`` at its defaults, in a child
    from the repository's root: its stderr goes to this output, prefixed;
    its stdout must be the standard tail's provisional line and the result
    line, which names AttentionSR's inference metric with a positive value
    and the phase tail."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "food101_sr_tpu_torch.bench"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=BENCH_CLI_TIMEOUT)
    for line in proc.stderr.splitlines():
        print(f"bench cli: {line}", flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"the bench exited with {proc.returncode}: "
                           f"{proc.stdout[-2000:]}")
    std, last = [json.loads(ln) for ln in proc.stdout.splitlines()]
    metric = "attentionsr_x4_inference_throughput"
    if not (last == {"metric": metric, "value": last["value"],
                     "unit": "images/sec/chip", "vs_baseline": None,
                     "tail": "phase"}
            and last["value"] > 0 and std["metric"] == metric
            and std["tail"] == "standard" and std["value"] > 0):
        raise AssertionError(f"the bench printed {std} then {last}")
    return {"standard_images_per_s": std["value"],
            "phase_images_per_s": last["value"],
            "wall_s": time.perf_counter() - t0}


def _bench_kernels(rates, k1: dict, k2: dict) -> dict:
    """K1 at the bf16 train step's pyramids (one launch per level, pred's
    and the target's alike) and K2 NHWC at the bench's SE inputs (bf16
    channels-last: inference, the train step, the GAN's G) against their
    plain versions (K1 within K1_TOL forward and backward, K2 within one
    bf16 ulp), with times and bounds; rows for the kernels line."""
    from food101_sr_tpu_torch import bench
    from food101_sr_tpu_torch.ops.spatial_mean import (mean_nhwc_kernel,
                                                       spatial_mean_plain)

    gen = torch.Generator(device="cuda").manual_seed(23)
    side = bench.LR_SIZE * bench.SCALE
    pyr = [torch.rand((bench.TRAIN_BATCH, 3, side >> i, side >> i),
                      device="cuda", generator=gen) for i in range(4)]
    err1 = _k1_err(pyr, gen)
    if not err1 <= K1_TOL:
        raise AssertionError(f"K1 at the bench's pyramid: {err1}")
    rows = {"K1 train": {**{k: k1[k] for k in ("name", "route", "source",
                                               "replaces", "wrapper")},
                         "at": f"4 launches: ({bench.TRAIN_BATCH},3,"
                               f"{{{side},{side // 2},{side // 4},"
                               f"{side // 8}}}^2) float32, a pyramid of the "
                               "bench's bf16 train step; host_us per launch",
                         "max_abs_err": err1, **_k1_timings(pyr, rates)}}
    lr = bench.LR_SIZE
    gan = bench.GAN_CROP // bench.SCALE
    for key, shape in (("K2 infer", (bench.BATCH, 96, lr, lr)),
                       ("K2 train", (bench.TRAIN_BATCH, 96, lr, lr)),
                       ("K2 gan", (bench.GAN_BATCH, 96, gan, gan))):
        x = (torch.rand(shape, device="cuda", generator=gen) * 2 - 0.5).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        got, want = mean_nhwc_kernel(x).float(), spatial_mean_plain(x).float()
        ulp = ((got - want).abs() / _ulp_bf16(want)).max().item()
        if not ulp <= 1.0:
            raise AssertionError(f"K2 NHWC at {shape} bf16: {ulp} ulp")
        t = _timings(lambda: mean_nhwc_kernel(x),
                     lambda: spatial_mean_plain(x), lambda: x.mean((2, 3)),
                     launches=1)
        t["bound_ms"], t["bound_by"] = bound(
            2 * x.numel() + 2 * shape[0] * shape[1], x.numel(), rates)
        rows[key] = {**{k: k2[k] for k in ("name", "route", "source",
                                           "replaces", "wrapper")},
                     "at": f"{shape} bfloat16 channels-last, the bench's "
                           f"{key.split()[1]} SE input",
                     "max_abs_err": (got - want).abs().max().item(),
                     "ulp": ulp, **t}
    for key, row in rows.items():
        print(f"bench kernels: {key} {row['at'].split(',')[0]}... "
              f"err {row['max_abs_err']:.3g} | kernel {row['ms']:.4f} ms, "
              f"device {row['device_ms']:.4f}, plain {row['plain_ms']:.4f}, "
              f"library {row['library_ms']:.4f}, bound {row['bound_ms']:.4f} "
              f"({row['bound_by']})", flush=True)
    return rows


def _host_syncs_per_step() -> dict:
    """Host syncs of one bench train step (bf16 AttentionSR, the bench's
    batch), counted by CUDA's sync debug mode: each of its warnings is
    one call that made the host wait for the device, but the mode's own
    notice that it is a prototype."""
    from food101_sr_tpu_torch import bench

    state, step = bench.build_train("AttentionSR", "cuda")
    hr = bench.hr_batch(bench.TRAIN_BATCH, bench.LR_SIZE * bench.SCALE,
                        "cuda")
    step(state, hr)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(state, hr)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    msgs = [str(w.message).splitlines()[0] for w in caught
            if "synchroniz" in str(w.message)
            and "prototype" not in str(w.message)]
    torch.cuda.synchronize()
    return {"syncs": len(msgs), "first": msgs[0] if msgs else None}


def run_remat_leg() -> dict:
    """The remat leg in a child process of its own, which alone gets the
    determinism environment (as run_loop_phase does)."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_remat_") as tmp:
        env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": LOOP_CUBLAS}
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--remat", tmp], env=env, timeout=600).returncode
        if rc != 0:
            raise RuntimeError(f"the remat leg exited with {rc}")
        with open(os.path.join(tmp, "remat.json")) as f:
            return json.load(f)


def remat_main(tmp: str) -> int:
    """Entry of the remat leg's child process: the registry AttentionSR x4
    float32 step (phase tail, NLPD, Adam) at TRAIN_BATCH crops of
    TRAIN_CROP with remat off and on, on the same seeded weights and
    crops, under the loop phase's determinism. The gradients bit-equal
    or, failing that, within GRAD_TOL of each leaf's term sum; then
    REMAT_WARMUP + REMAT_TIMED steps of each under CUDA events, peak
    memory and launches per step (K1 8 both; K2 32 off, 64 on)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from food101_sr_tpu_torch.losses import nlpd_loss
    from food101_sr_tpu_torch.models import get_model
    from food101_sr_tpu_torch.training import (FIRST_LAST, SRTrainState,
                                               loss_and_grads, make_adam,
                                               make_train_step)
    from food101_sr_tpu_torch.utils.term_sums import term_sums

    _deterministic()
    hr = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (TRAIN_BATCH, TRAIN_CROP, TRAIN_CROP, 3), np.uint8)).cuda()
    nets = {remat: get_model("AttentionSR", phase_tail=True, remat=remat,
                             generator=torch.Generator().manual_seed(0))
            for remat in (False, True)}
    with term_sums(nets[False], {}) as sums:
        loss0, g0 = loss_and_grads(nets[False], nlpd_loss, 4, hr)
    loss1, g1 = loss_and_grads(nets[True], nlpd_loss, 4, hr)
    bit_equal = torch.equal(loss0, loss1) and _bit_equal(g0, g1)
    names = [k for k, _ in nets[False].named_parameters()]
    worst = _worst(names, g1, [g.cpu() for g in g0], sums)
    if not (bit_equal or worst["term_sum"][0] <= GRAD_TOL):
        raise AssertionError(f"remat gradients: {worst['term_sum']}")
    del g0, g1
    out = {"bit_equal": bit_equal, "term_sum": worst["term_sum"]}
    for remat, model in nets.items():
        state = SRTrainState.create(model, make_adam(TRAIN_LR))
        step = make_train_step(model, nlpd_loss, 4,
                               *FIRST_LAST["AttentionSR"])
        for _ in range(REMAT_WARMUP):
            step(state, hr)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        ms = []
        for _ in range(REMAT_TIMED):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step(state, hr)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        per_step = [n // REMAT_TIMED for n in _counts()]
        want = [8, model.num_residuals * (2 if remat else 1), 0]
        if per_step != want:
            raise AssertionError(f"remat={remat}: launches a step "
                                 f"{per_step}, expected {want}")
        out["on" if remat else "off"] = {
            "step_ms": float(np.median(ms)), "step_ms_min": min(ms),
            "step_ms_max": max(ms), "launches": per_step,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del state, step
    with open(os.path.join(tmp, "remat.json"), "w") as f:
        json.dump(out, f)
    return 0


def phase_bench(rates, k1: dict, k2: dict) -> dict:
    """The port's bench on the card (module docstring, phase 17). Returns
    the kernels' rows at the bench's shapes (with their launches in the
    counted legs) and the legs' launch totals."""
    from food101_sr_tpu_torch import bench

    t0 = time.perf_counter()
    torch.cuda.empty_cache()  # the earlier phases' cached blocks
    cli = _bench_cli()
    rows = _bench_kernels(rates, k1, k2)
    small = dict(zip(("n_short", "n_long"), BENCH_N),
                 repeats=BENCH_REPEATS)
    calls = 2 + BENCH_REPEATS * sum(BENCH_N)  # the first call, the timed
    #                                           runs, launches_of's call
    legs, counted = {}, {}

    def leg(key, fn):
        before = _counts()
        legs[key] = fn()
        torch.cuda.synchronize()
        counted[key] = [a - b for a, b in zip(_counts(), before)]
        torch.cuda.empty_cache()

    # ---- main path: counts from zero -----------------------------------
    _zero_counts()
    leg("infer", lambda: bench.bench_infer(**small))
    leg("train", lambda: bench.bench_train(**small))
    leg("gan", lambda: bench.bench_gan(**small))
    leg("input", bench.bench_input)
    rrdb_keys = [(b, lay, f"rrdb {b} {lay} {i}") for b in RRDB_AB_BATCHES
                 for i, lay in enumerate(RRDB_TURNS)]
    for batch, layout, key in rrdb_keys:
        leg(key, lambda: bench.bench_train(
            "RRDB", batch=batch, dense_layout=layout, **small))
    launches = _counts()
    # ---- end of main path ----------------------------------------------

    per_call = {key: tuple(legs[key]["launches"].values())
                for key in ("infer", "train")}
    per_call["gan G"] = tuple(legs["gan"]["launches"]["G"].values())
    per_call["gan D"] = tuple(legs["gan"]["launches"]["D"].values())
    per_call["input"] = tuple(counted["input"])
    for _, _, key in rrdb_keys:
        per_call[key] = tuple(legs[key]["launches"].values())
    for key, got in per_call.items():
        want = BENCH_PER_CALL[key.split()[0] if key.startswith("rrdb")
                              else key]
        if got != want:
            raise AssertionError(f"bench {key}: launches a call {got}, "
                                 f"expected {want}")
    # each leg makes ``calls`` calls (the GAN's of G and of D alike)
    want_total = [calls * sum(BENCH_PER_CALL[k][j] for k in (
        "infer", "train", "gan G", "gan D", *["rrdb"] * len(rrdb_keys)))
        for j in range(3)]
    if list(launches) != want_total:
        raise AssertionError(f"bench legs launched {launches}, expected "
                             f"{want_total}")
    for key, leg_out in legs.items():
        if not leg_out["ips"] > 0:
            raise AssertionError(f"bench {key}: {leg_out}")
    syncs = _host_syncs_per_step()
    remat = run_remat_leg()
    rrdb = {b: {lay: {k: [legs[key][k] for bb, ll, key in rrdb_keys
                          if (bb, ll) == (b, lay)]
                      for k in ("ms", "device_ms", "ips", "peak_gib")}
                for lay in ("split", "concat")} for b in RRDB_AB_BATCHES}
    ab_line = ", ".join(
        f"batch {b}: split {np.median(r['split']['ms']):.1f} concat "
        f"{np.median(r['concat']['ms']):.1f} ms, "
        f"{max(r['split']['peak_gib']):.2f} / "
        f"{max(r['concat']['peak_gib']):.2f} GiB" for b, r in rrdb.items())
    numbers = {"cli": cli, "calls_per_leg": calls,
               "legs": {k: {kk: vv for kk, vv in v.items()
                            if kk != "launches"} for k, v in legs.items()},
               "rrdb_ab": rrdb, "train_step_host_syncs": syncs,
               "remat": remat, "launches": list(launches),
               "phase_s": time.perf_counter() - t0}
    print(f"bench: cli {cli['standard_images_per_s']} -> "
          f"{cli['phase_images_per_s']} images/s (standard -> phase tail, "
          f"{cli['wall_s']:.1f} s) | at n {BENCH_N}, {BENCH_REPEATS} repeat: "
          f"infer {legs['infer']['ips']:.1f}, train "
          f"{legs['train']['ips']:.1f} ({legs['train']['ms']:.1f} ms, "
          f"{legs['train']['peak_gib']:.2f} GiB), gan "
          f"{legs['gan']['ips']:.1f}, input {legs['input']['ips']:.1f} "
          f"images/s | RRDB train (medians of the turns) {ab_line}"
          f" | host syncs a train step {syncs['syncs']} | remat bit-equal "
          f"{remat['bit_equal']}, step ms {remat['off']['step_ms']:.1f} -> "
          f"{remat['on']['step_ms']:.1f}, GiB {remat['off']['peak_gib']:.3f}"
          f" -> {remat['on']['peak_gib']:.3f}, K2 a step "
          f"{remat['off']['launches'][1]} -> {remat['on']['launches'][1]} | "
          f"launches {list(launches)} | {numbers['phase_s']:.1f} s",
          flush=True)
    print("bench numbers: " + json.dumps(numbers), flush=True)
    rows["K1 train"]["launches"] = counted["train"][0] + sum(
        counted[key][0] for b, _, key in rrdb_keys
        if b == bench.TRAIN_BATCH)
    rows["K2 infer"]["launches"] = counted["infer"][1]
    rows["K2 train"]["launches"] = counted["train"][1]
    rows["K2 gan"]["launches"] = counted["gan"][1]
    rows["K1 train"]["step_ms"] = legs["train"]["ms"]
    rows["K2 infer"]["images_per_s"] = legs["infer"]["ips"]
    return {"rows": list(rows.values()),
            "launches": dict(zip(("K1", "K2 nhwc", "K2 nchw"), launches))}


def _k2_op_row(shape, rates, k2: dict, what: str) -> dict:
    """K2 through its registered op (the route an exported program takes)
    at an SE input of ``shape`` bf16 channels-last: within one bf16 ulp of
    the plain version, with the wrapper's times (the op's dispatch in
    host_us) and the bound."""
    from food101_sr_tpu_torch.ops.spatial_mean import (spatial_mean_op,
                                                       spatial_mean_plain)

    gen = torch.Generator(device="cuda").manual_seed(41)
    x = (torch.rand(shape, device="cuda", generator=gen) * 2 - 0.5).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    got, want = spatial_mean_op(x).float(), spatial_mean_plain(x).float()
    ulp = ((got - want).abs() / _ulp_bf16(want)).max().item()
    if not ulp <= 1.0:
        raise AssertionError(f"K2 op at {shape} bf16: {ulp} ulp")
    t = _timings(lambda: spatial_mean_op(x), lambda: spatial_mean_plain(x),
                 lambda: x.mean((2, 3)), launches=1)
    t["bound_ms"], t["bound_by"] = bound(
        2 * x.numel() + 2 * shape[0] * shape[1], x.numel(), rates)
    return {**{k: k2[k] for k in ("route", "source", "replaces")},
            "name": "K2 spatial mean via f101::spatial_mean, in the "
                    "exported serving program",
            "wrapper": "food101_sr_tpu_torch/ops/spatial_mean.py:"
                       "spatial_mean_op",
            "at": f"{shape} bfloat16 channels-last, the SE input of the "
                  f"{what} program",
            "max_abs_err": (got - want).abs().max().item(), "ulp": ulp, **t}


def _aot_programs(tmp: str, rates, k2: dict) -> dict:
    """Export, check in a child without the model code, and time (module
    docstring, phase 18, a to c)."""
    from food101_sr_tpu_torch import export_serving
    from food101_sr_tpu_torch.serving import SRServer

    live = {tta: SRServer("AttentionSR", device="cuda", dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(0),
                          tta=tta, max_batch=AOT_BATCH)
            for tta in (False, True)}
    try:
        n_blocks = live[False].model.num_residuals
        tile = live[False].tile
        win = tile + 2 * live[False].halo
        runs = {"plain": (f"{tile}x{tile},{win}x{win}", []),
                "tta": (f"{tile}x{tile}", ["--tta"])}
        entries, summaries, export_s = [], {}, {}
        rng = np.random.default_rng(17)
        for key, (shapes, extra) in runs.items():
            out = os.path.join(tmp, key)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                summaries[key] = export_serving.main([
                    "--architecture", "AttentionSR", "--out", out,
                    "--shapes", shapes, "--batch", str(AOT_BATCH), "--check",
                    *extra])
            export_s[key] = time.perf_counter() - t0
            with open(os.path.join(out, "manifest.json")) as f:
                man = json.load(f)
            keys = {"kind", "architecture", "scale", "dtype", "quantize",
                    "tta", "phase_tail", "checkpoint", "n_params",
                    "torch_version", "ops_module", "io", "buckets"}
            if not (set(man) == keys and summaries[key]["checked"]
                    == len(man["buckets"]) and man["tta"] == bool(extra)
                    and all(b["platforms"] == ["cuda"]
                            for b in man["buckets"])):
                raise AssertionError(f"aot: {key} manifest {man}")
            tta = bool(extra)
            for b in man["buckets"]:
                x = rng.integers(0, 256, b["lr_shape"], dtype=np.uint8)
                y = live[tta].forward_u8(torch.from_numpy(x).cuda()) \
                    .cpu().numpy()
                name = f"{key}_{b['lr_shape'][1]}"
                np.save(os.path.join(tmp, f"{name}_x.npy"), x)
                np.save(os.path.join(tmp, f"{name}_y.npy"), y)
                entries.append({"key": name, "tta": tta,
                                "path": os.path.join(out, b["file"]),
                                "x": os.path.join(tmp, f"{name}_x.npy"),
                                "y": os.path.join(tmp, f"{name}_y.npy"),
                                "mb": b["bytes"] / 1e6,
                                "k2_per_call": n_blocks * (2 if tta else 1)})
        with open(os.path.join(tmp, "buckets.json"), "w") as f:
            json.dump(entries, f)
        # ---- main path (in the child): each program once, counts from 0
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--aot", tmp],
                            timeout=AOT_CHILD_TIMEOUT).returncode
        if rc != 0:
            raise RuntimeError(f"the aot child exited with {rc}")
        with open(os.path.join(tmp, "aot.json")) as f:
            child = json.load(f)
        if child["imported"]:
            raise AssertionError(f"aot: the loader imported {child['imported']}")
        for e in entries:
            c = child[e["key"]]
            want = [0, e["k2_per_call"], 0]
            if not (c["equal"] and c["launches"] == want
                    and c["op_nodes"] == e["k2_per_call"]
                    and c["aten_means"] == 0):
                raise AssertionError(f"aot: {e['key']} in the child: {c}, "
                                     f"launches expected {want}")
        # exported against eager forward, in turns, on the same input
        timing = {}
        for e in entries:
            prog = export_serving.load_bucket(e["path"], "cuda")
            x = torch.from_numpy(np.load(e["x"])).cuda()
            eager = live[e["tta"]].forward_u8
            if not torch.equal(prog(x), eager(x)):
                raise AssertionError(f"aot: {e['key']} differs in-process")
            turns = [("eager", eager), ("aot", prog), ("aot", prog),
                     ("eager", eager)]
            ms = {"eager": [], "aot": []}
            for which, fn in turns:
                ms[which].append(cuda_ms(lambda: fn(x), AOT_ITERS, 2))
            timing[e["key"]] = {"eager_ms": ms["eager"], "aot_ms": ms["aot"],
                                "child_aot_ms": child[e["key"]]["ms"],
                                "mb": e["mb"]}
            del prog
        rows = [_k2_op_row((AOT_BATCH, 96, tile, tile), rates, k2,
                           f"{tile}x{tile}"),
                _k2_op_row((AOT_BATCH, 96, win, win), rates, k2,
                           f"{win}x{win}"),
                _k2_op_row((4 * AOT_BATCH, 96, tile, tile), rates, k2,
                           f"--tta {tile}x{tile}")]
        for row, e in zip(rows, entries):
            row["launches"] = child[e["key"]]["launches"][1]
    finally:
        for srv in live.values():
            srv.close()
    return {"rows": rows, "timing": timing, "export_s": export_s,
            "summaries": summaries,
            "launches": [sum(child[e["key"]]["launches"][j] for e in entries)
                         for j in range(3)]}


def aot_main(tmp: str) -> int:
    """Entry of the aot phase's child: load each exported program with
    ``export_serving.load_bucket`` (which imports the ops module alone),
    run it once on its saved input with the counts from zero, hold it
    byte-equal to the parent's live forward, time it; then list any
    module of the models, the server or training that was imported."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from food101_sr_tpu_torch.export_serving import load_bucket

    with open(os.path.join(tmp, "buckets.json")) as f:
        entries = json.load(f)
    out = {}
    for e in entries:
        prog = load_bucket(e["path"], "cuda")
        targets = [str(n.target) for n in prog.program.graph.nodes
                   if n.op == "call_function"]
        x, want = np.load(e["x"]), np.load(e["y"])
        _zero_counts()
        got = prog(x)
        torch.cuda.synchronize()
        launches = list(_counts())
        xd = torch.from_numpy(x).cuda()
        out[e["key"]] = {
            "equal": bool(np.array_equal(got, want)),
            "max_levels": _levels(got, want), "launches": launches,
            "op_nodes": sum(t.startswith(K2_OP_NODE) for t in targets),
            "aten_means": sum("aten.mean" in t for t in targets),
            "ms": cuda_ms(lambda: prog(xd), AOT_ITERS, 2)}
        print(f"aot child: {e['key']} byte-equal {out[e['key']]['equal']} "
              f"({out[e['key']]['max_levels']} levels), launches {launches}, "
              f"{out[e['key']]['op_nodes']} K2 op nodes, "
              f"{out[e['key']]['ms']:.3f} ms", flush=True)
    out["imported"] = sorted(m for m in sys.modules if m.startswith((
        "food101_sr_tpu_torch.models", "food101_sr_tpu_torch.serving",
        "food101_sr_tpu_torch.training")))
    with open(os.path.join(tmp, "aot.json"), "w") as f:
        json.dump(out, f)
    return 0


def _nlpd_train(rates, k1: dict) -> dict:
    """nlpd_loss_train on the card (module docstring, phase 18, d): value
    and input gradient against its CPU run, K1 launches, and K1 at the
    loss's pyramid against its plain version, with times."""
    from food101_sr_tpu_torch.losses import nlpd_loss_train

    gen = torch.Generator().manual_seed(31)
    shape = (TRAIN_BATCH, 3, TRAIN_CROP, TRAIN_CROP)
    pred, target = torch.rand(shape, generator=gen), torch.rand(shape,
                                                                 generator=gen)

    def run(dev):
        p = pred.to(dev).requires_grad_(True)
        v = nlpd_loss_train(p, target.to(dev))
        v.backward()
        return v.item(), p.grad.cpu()

    run("cuda")
    torch.cuda.synchronize()
    # ---- main path: one loss and its backward, counts from zero --------
    _zero_counts()
    v_card, g_card = run("cuda")
    torch.cuda.synchronize()
    launches = list(_counts())
    # ---- end of main path ----------------------------------------------
    v_cpu, g_cpu = run("cpu")
    rel = abs(v_card - v_cpu) / abs(v_cpu)
    cos = float((g_card * g_cpu).sum() / g_card.norm() / g_cpu.norm())
    norm = float(g_card.norm() / g_cpu.norm())
    if not (launches == [8, 0, 0] and rel <= NLPD_TRAIN_RTOL
            and cos > NLPD_TRAIN_COS and abs(norm - 1) < NLPD_TRAIN_NORM):
        raise AssertionError(f"nlpd_loss_train: launches {launches}, value "
                             f"{v_card} vs CPU {v_cpu} (rel {rel}), gradient "
                             f"cosine {cos}, norm ratio {norm}")
    gen = torch.Generator(device="cuda").manual_seed(32)
    pyr = [torch.rand((2 * TRAIN_BATCH, 3, TRAIN_CROP >> i, TRAIN_CROP >> i),
                      device="cuda", generator=gen) for i in range(4)]
    err = _k1_err(pyr, gen)
    if not err <= K1_TOL:
        raise AssertionError(f"K1 at nlpd_loss_train's pyramid: {err}")
    p = pred.cuda().requires_grad_(True)
    t = target.cuda()
    loss_ms = cuda_ms(lambda: nlpd_loss_train(p, t).backward(), 10, 2)
    row = {**{k: k1[k] for k in ("route", "source", "replaces", "wrapper")},
           "name": "K1 depthwise Gaussian blur 5x5, under nlpd_loss_train",
           "at": f"4 launches: ({2 * TRAIN_BATCH},3,{{{TRAIN_CROP},"
                 f"{TRAIN_CROP // 2},{TRAIN_CROP // 4},{TRAIN_CROP // 8}}}^2)"
                 " float32 (the bf16 pyramid of pred and target cast around "
                 "the kernel); host_us per launch",
           "launches": launches[0], "max_abs_err": err,
           "value_rel_err": rel, "grad_cos": cos, "loss_fwd_bwd_ms": loss_ms,
           **_k1_timings(pyr, rates)}
    print(f"nlpd_train: {TRAIN_BATCH}x3x{TRAIN_CROP}^2 value {v_card:.6f} "
          f"(CPU {v_cpu:.6f}, rel {rel:.2g}), gradient cosine {cos:.6f}, "
          f"norm ratio {norm:.6f} | K1 {launches[0]} launches (fwd+bwd), "
          f"err {err:.3g} | loss+backward {loss_ms:.3f} ms | K1 pyramid "
          f"{row['ms']:.4f} ms, device {row['device_ms']:.4f}, bound "
          f"{row['bound_ms']:.4f}", flush=True)
    return row


def _vis_forwards(n: int = VIS_IMAGES) -> int:
    """AttentionSR forwards of a visualize run on ``n`` synthetic images:
    one per image and one warm-up per distinct padded LR shape (its
    images and sizes, as run_comparison draws them)."""
    from food101_sr_tpu_torch import visualize
    from food101_sr_tpu_torch.data import SyntheticSource

    src = SyntheticSource(n=max(n, 16), seed=0)
    idx = np.random.default_rng(0).choice(len(src), size=n, replace=False)
    b, s = visualize.BUCKET, visualize.SCALE_FACTOR
    shapes = {tuple(-(-(d // s) // b) * b for d in src.sizes[i % len(src.sizes)])
              for i in idx}
    return n + len(shapes)


def _tools(tmp: str) -> dict:
    """visualize, sweep, generate_model_vis and analyze_models on the card
    (module docstring, phase 18, e to g), each counted from zero."""
    from food101_sr_tpu_torch import (analyze_models, generate_model_vis,
                                      sweep, visualize)
    from food101_sr_tpu_torch.models import get_model, param_count
    from food101_sr_tpu_torch.training import save_checkpoint

    root = os.path.dirname(os.path.abspath(__file__))
    attn = get_model("AttentionSR", device="cpu",
                     generator=torch.Generator().manual_seed(0))
    n_blocks = attn.num_residuals
    weights = {"SRCNN": visualize.WEIGHTS["SRCNN"],
               "AttentionSR": save_checkpoint(attn.state_dict(),
                                              os.path.join(tmp, "attn.pth"))}
    out, launches = {}, {}
    buf = io.StringIO()
    t0 = time.perf_counter()
    # ---- main path: visualize, counts from zero -------------------------
    _zero_counts()
    with contextlib.redirect_stdout(buf):
        times = visualize.run_comparison(
            dataset="synthetic", num_examples=VIS_IMAGES, seed=0,
            out_dir=os.path.join(tmp, "report"), weights=weights)
    torch.cuda.synchronize()
    launches["visualize"] = list(_counts())
    # ---- end of main path -----------------------------------------------
    want = [0, n_blocks * _vis_forwards(), 0]
    dirs = sorted(d for d in os.listdir(os.path.join(tmp, "report")))
    pngs = {"ground_truth.png", "input_lr_resized.png", "bicubic.png",
            "srcnn.png", "attentionsr.png"}
    if not (launches["visualize"] == want and set(times) == set(weights)
            and len(dirs) == VIS_IMAGES and all(
                set(os.listdir(os.path.join(tmp, "report", d))) == pngs
                for d in dirs)):
        raise AssertionError(f"visualize: launches {launches['visualize']} "
                             f"(expected {want}), models {set(times)}, "
                             f"{len(dirs)} image directories")
    out["visualize"] = {
        name: {"avg_ms": float(np.mean(t) * 1e3),
               "std_ms": float(np.std(t) * 1e3),
               "min_ms": float(np.min(t) * 1e3),
               "max_ms": float(np.max(t) * 1e3)} for name, t in times.items()}
    out["visualize_s"] = time.perf_counter() - t0
    table = [ln for ln in buf.getvalue().splitlines() if "| Avg:" in ln]
    for ln in table:
        print(f"visualize: {ln}", flush=True)

    runs = os.path.join(tmp, "runs")
    old = os.environ.get("FOOD101_SR_RUN_DIR")
    os.environ["FOOD101_SR_RUN_DIR"] = runs
    results = os.path.join(tmp, "sweep.jsonl")
    t0 = time.perf_counter()
    try:
        # ---- main path: the sweep's trials, counts from zero ------------
        _zero_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            best_cfg, best = sweep.run_sweep(
                os.path.join(root, "configs", "sweep_attentionSR.yaml"),
                SWEEP_TRIALS, seed=0, out=results,
                overrides={**SWEEP_CFG,
                           "weights_dir": os.path.join(tmp, "sweep_w")})
        launches["sweep"] = list(_counts())
        # ---- end of main path -------------------------------------------
    finally:
        if old is None:
            os.environ.pop("FOOD101_SR_RUN_DIR", None)
        else:
            os.environ["FOOD101_SR_RUN_DIR"] = old
    nb = _loop_batches(cfg=SWEEP_CFG)
    evals = nb["steps"] + nb["val"] + nb["test"]
    want = [SWEEP_TRIALS * (8 * nb["steps"] + 4 * nb["val"] + 4 * nb["test"]),
            SWEEP_TRIALS * n_blocks * evals, 0]
    with open(results) as f:
        rows = [json.loads(line) for line in f]
    if not (launches["sweep"] == want and len(rows) == SWEEP_TRIALS
            and all(np.isfinite(r["val_psnr"]) and r["val_psnr"] > 0
                    and r["config"]["loss_function"] == "nlpd"
                    and r["config"]["architecture"] == "AttentionSR"
                    for r in rows)):
        raise AssertionError(f"sweep: launches {launches['sweep']} (expected "
                             f"{want}), rows {rows}")
    out["sweep"] = {"val_psnr": [r["val_psnr"] for r in rows],
                    "lr": [r["config"]["lr"] for r in rows],
                    "best_val_psnr": best["val_psnr"],
                    "s": time.perf_counter() - t0}

    t0 = time.perf_counter()
    # ---- main path: the graph and FLOP count, counts from zero ----------
    _zero_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        written = generate_model_vis.main(["--out", os.path.join(tmp, "vis"),
                                           "--models", "AttentionSR"])
    torch.cuda.synchronize()
    launches["model_vis"] = list(_counts())
    # ---- end of main path -----------------------------------------------
    with open(os.path.join(written["AttentionSR"], "export_graph.txt")) as f:
        graph = f.read()
    with open(os.path.join(written["AttentionSR"], "flops.json")) as f:
        flops = json.load(f)
    with contextlib.redirect_stdout(io.StringIO()):
        rows = dict(analyze_models.analyze_models())
    n_ops = graph.count(f"torch.ops.{K2_OP_NODE}.default(")
    if not (launches["model_vis"] == [0, n_blocks, 0] and n_ops == n_blocks
            and flops["flops"] > 0 and rows["AttentionSR (96ch, trained)"]
            == param_count(attn)):
        raise AssertionError(f"model_vis: launches {launches['model_vis']}, "
                             f"{n_ops} K2 op nodes, flops {flops}, "
                             f"analyze {rows}")
    out["model_vis"] = {"gflop": flops["flops"] / 1e9, "k2_op_nodes": n_ops,
                        "s": time.perf_counter() - t0, "params": rows}
    out["launches"] = launches
    return out


def phase_aot(rates, k1: dict, k2: dict) -> dict:
    """The AOT serving artifact, nlpd_loss_train and the offline tools on
    the card (module docstring, phase 18). Returns the kernels line's new
    rows and the launches of each counted run."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_aot_") as tmp:
        aot = _aot_programs(tmp, rates, k2)
        nlpd = _nlpd_train(rates, k1)
        tools = _tools(tmp)
    timing = aot["timing"]
    print("aot: AttentionSR x4 bf16 exported "
          + ", ".join(f"{k} in {v:.1f} s" for k, v in aot["export_s"].items())
          + " (--check byte-equal) | the child loads without the model "
          "code; byte-equal | forward ms eager -> exported: "
          + ", ".join(f"{k} {np.mean(t['eager_ms']):.3f} -> "
                      f"{np.mean(t['aot_ms']):.3f} ({t['mb']:.1f} MB)"
                      for k, t in timing.items())
          + f" | K2 launches {aot['launches'][1]}", flush=True)
    print(f"tools: visualize {VIS_IMAGES} images in "
          f"{tools['visualize_s']:.1f} s, launches "
          f"{tools['launches']['visualize']} | sweep {SWEEP_TRIALS} trials "
          f"val_psnr {tools['sweep']['val_psnr']} in "
          f"{tools['sweep']['s']:.1f} s, launches {tools['launches']['sweep']}"
          f" | generate_model_vis AttentionSR {tools['model_vis']['gflop']:.2f}"
          f" GFLOP, {tools['model_vis']['k2_op_nodes']} K2 op nodes, "
          f"launches {tools['launches']['model_vis']} | "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    numbers = {"timing": timing, "export_s": aot["export_s"],
               "summaries": aot["summaries"],
               "nlpd_train": {k: nlpd[k] for k in (
                   "value_rel_err", "grad_cos", "loss_fwd_bwd_ms")},
               **{k: tools[k] for k in ("visualize", "sweep", "model_vis")},
               "phase_s": time.perf_counter() - t0}
    print("aot numbers: " + json.dumps(numbers), flush=True)
    runs = {"aot": aot["launches"], "nlpd_train": [nlpd["launches"], 0, 0],
            **tools["launches"]}
    return {"rows": [*aot["rows"], nlpd],
            "launches": {key: {run: counts[j] for run, counts in runs.items()}
                         for j, key in enumerate(("K1", "K2 nhwc",
                                                  "K2 nchw"))}}


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
    out["cache_launches"] = phase_caches(tmp, out, out["food101_launches"])
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
    winner = phase_winner(rates, k1, k2_nhwc)
    for d, key in ((k1, "K1"), (k2_nhwc, "K2 nhwc"), (k2_nchw, "K2 nchw")):
        d["winner_launches"] = winner["by_winner"][key]
    k1_train, k2_train = phase_train(rates)
    k2_gan = phase_gan(rates)
    gens = phase_generators()
    for d, key in ((k1_train, "K1"), (k2_train, "K2 nhwc"),
                   (k2_nchw, "K2 nchw")):
        d["generator_launches"] = {a: g["launches"][key]
                                   for a, g in gens.items()}
    k1_bf16, k2_bf16, k2_nchw["bf16_launches"] = phase_bf16(rates)
    loop = run_loop_phase()
    for d, key in ((k1, "K1"), (k2_nhwc, "K2 nhwc"), (k2_nchw, "K2 nchw")):
        d["loop_launches"] = loop["launches"][key]
        d["gan_loop_launches"] = loop["gan_launches"][key]
        d["rrdb_gan_loop_launches"] = loop["rrdb_gan_launches"][key]
        d["food101_loop_launches"] = loop["food101_launches"][key]
        for run, out_key in CACHE_LAUNCH_KEYS.items():
            d[out_key] = loop["cache_launches"][run][key]
    for d, key in ((k1, "K1"), (k2_nhwc, "K2 nhwc")):
        d["loop_max_abs_err"] = loop["max_abs_err"][key]
        d["at_loop_val"] = loop["at_val"][key]
    tails = phase_tails()
    quant = phase_quant()
    for d, key in ((k1, "K1"), (k2_nhwc, "K2 nhwc"), (k2_nchw, "K2 nchw")):
        d["tail_launches"] = tails["launches"][key]
        d["quant_serve_launches"] = quant["serve_launches"][key]
        d["qat_loop_launches"] = quant["qat_launches"][key]
    dp = phase_dp(rates)
    for d, key in ((k1, "K1"), (k2_nhwc, "K2 nhwc"), (k2_nchw, "K2 nchw")):
        d["dp_launches"] = dp["dp_launches"][key]
        d["halo_launches"] = dp["halo_launches"][key]
    k1["dp_max_abs_err"] = dp["k1_max_abs_err"]
    bench = phase_bench(rates, k1, k2_nhwc)
    for d, key in ((k1, "K1"), (k2_nhwc, "K2 nhwc"), (k2_nchw, "K2 nchw")):
        d["bench_launches"] = bench["launches"][key]
    aot = phase_aot(rates, k1, k2_nhwc)
    for d, key in ((k1, "K1"), (k2_nhwc, "K2 nhwc"), (k2_nchw, "K2 nchw")):
        d["aot_launches"] = aot["launches"][key]
    keys = ("name", "route", "source", "replaces", "launches",
            "http_launches", "winner_launches", "loop_launches", "gan_loop_launches", "generator_launches",
            "rrdb_gan_loop_launches", "food101_loop_launches",
            "tail_launches", "quant_serve_launches", "qat_loop_launches",
            "bf16_launches", *CACHE_LAUNCH_KEYS.values(), "dp_launches",
            "halo_launches", "bench_launches", "aot_launches",
            "dp_max_abs_err",
            "max_abs_err",
            "loop_max_abs_err", "ms", "device_ms", "host_us", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "wrapper", "at", "at_64",
            "at_loop_val", "half_device_ms", "nchw_copy_ms",
            "nchw_copy_device_ms", "fwd_bwd_ms", "plain_fwd_bwd_ms", "ulp",
            "backward_ulp", "step_ms", "g_step_ms", "d_step_ms",
            "images_per_s", "peak_bytes", "device_split_ms",
            "value_rel_err", "grad_cos", "loss_fwd_bwd_ms")
    kernels = [{k: d[k] for k in keys if k in d}
               for d in (k1, k2_nhwc, k2_nchw, k2_tta, k1_train, k2_train,
                         k2_gan, k1_bf16, k2_bf16, dp["k2_rank"],
                         dp["k2_halo"], *bench["rows"], *aot["rows"],
                         *winner["rows"])]
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
    if sys.argv[1:2] == ["--dp"]:
        sys.exit(dp_rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    if sys.argv[1:2] == ["--dp-one"]:
        sys.exit(dp_one_main(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--remat"]:
        sys.exit(remat_main(sys.argv[2]))
    if sys.argv[1:2] == ["--aot"]:
        sys.exit(aot_main(sys.argv[2]))
    sys.exit(main())
