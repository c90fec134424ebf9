#!/usr/bin/env python
"""Export trained weights that the PyTorch port can read on a host without
JAX or Orbax, with goldens from the JAX package to hold them against.

Runs here, on the CPU, with the JAX package (the port never imports this
file). For the committed SRCNN winner (``weights/winner_srcnn_best``,
24,579 parameters) it writes, under ``food101_sr_tpu_torch/assets/``:

- ``winner_srcnn.pth``: the reference-layout state_dict
  (``tools/export_sr_checkpoint.py::export_state_dict``), float32, which
  loads with ``strict=True`` into the port's registry SRCNN;
- ``winner_srcnn_goldens.npz``: four seeded uint8 LR inputs (``lr_0``..
  ``lr_3``: three 32x32 and one 96x80, which takes the tiled path at the
  server's tile 64 and SRCNN's halo 8) and the JAX package's float32
  served outputs for them (``sr_0``..``sr_3``: ``serve.SRServer("auto",
  checkpoint, dtype=float32).upscale``).

For the committed AttentionSR x4 winner (``weights/winner_attentionsr_best``,
5,842,630 parameters; ``--what attentionsr``) it writes:

- ``winner_attentionsr.f101w``: its reference-layout float32 state_dict
  as a packed weights file (``food101_sr_tpu_torch/training/packed.py``,
  lossless, ~19.6 MB; ~23.4 MB as a ``.pth``), which loads with
  ``strict=True`` into the port's registry AttentionSR (32 blocks x 96
  channels);
- ``winner_attentionsr_goldens.npz`` (under 1.5 MB): five uint8 LR inputs
  (``lr_0``..``lr_4``) and the JAX package's float32 served outputs for
  them (``sr_0``..``sr_4``), each stored as the bytes of a PNG stream. The
  first four LRs are the mini tree's test images (``assets/jpeg/``,
  below) decoded by the JAX package's binding, centre-cropped to a
  multiple of 4 (the HR, not stored: the port's decoder rebuilds it
  pixel-equal) and degraded x4 as its eval step does
  (``data.prepare_batch``), rounded to uint8; the fifth is a 200x152 LR
  of an 800x608 HR from ``make_image`` (seed 19), which takes the
  server's tiled path. For the four small ones: the JAX
  ``MetricsCalculator``'s ``psnr``, ``ssim``, ``lpips`` and ``nlpd`` of
  each float32 output against its HR (LPIPS on the port's seeded
  fallback AlexNet, the one its card host runs, written as JAX's weight
  file: both packages score on the same weights), ``psnr_bf16`` and
  ``psnr_int8`` of JAX's bfloat16 server and of its ``quantize="int8"``
  one (bfloat16, its serving default), and ``snr_int8``, the int8
  outputs' SNR in dB against the float32 ones over all four images.

For the committed ResNetSR x4 winner (``weights/winner_resnet_best``,
1,549,462 parameters) and its QAT fine-tune
(``weights/winner_resnet_qat_best``, float weights served through
``quantize="int8"``; ``--what resnet``) it writes:

- ``winner_resnet.f101w`` and ``winner_resnet_qat.f101w``: their
  reference-layout float32 state_dicts, packed losslessly (~5.2 MB each,
  every BatchNorm's running mean and variance and its 0-d counter
  included), which load with ``strict=True`` into the port's registry
  ResNetSR (16 blocks x 64 channels);
- ``winner_resnet_goldens.npz`` (under 1.5 MB): for each net, under the
  prefix ``resnet_`` or ``resnet_qat_``, the same goldens as the
  AttentionSR winner's on the same five LR inputs, which are read from
  ``winner_attentionsr_goldens.npz`` (and held equal to
  ``winner_lr(winner_hr())``) rather than stored twice.

For the AttentionSR winner's GAN and QAT fine-tunes
(``weights/winner_attentionsr_gan_best`` and
``weights/winner_attentionsr_qat_best``; ``--what attentionsr_tunes``,
which needs ``winner_attentionsr.f101w`` in the output directory) it
writes:

- ``winner_attentionsr_gan.f101w`` and ``winner_attentionsr_qat.f101w``:
  their state_dicts rounded to bfloat16 (to nearest even), each packed as
  the XOR of its bfloat16 bits with those of ``winner_attentionsr.f101w``
  (~4 MB each); they unpack to the rounded weights widened to float32;
- ``winner_attentionsr_tunes_goldens.npz`` (under 1.5 MB): for each net,
  under the prefix ``attentionsr_gan_`` or ``attentionsr_qat_``, the same
  goldens as the AttentionSR winner's on the same five LR inputs (read
  from its goldens, not stored twice), computed by the JAX server on the
  same rounded weights (an Orbax copy with every float32 leaf rounded, in
  a temporary directory); and what the rounding costs JAX's float32
  server: its PSNR on the original Orbax weights for the small inputs
  (``psnr_orbax``) and per input the largest uint8 difference between
  the two weights' outputs (``levels_orbax``), also printed.

For the port's codecs it writes ``assets/jpeg/`` (``--what jpeg``),
under 1.2 MB:

- ``food-101/``: a mini Food-101 tree (``images/<class>/<id>.jpg``,
  ``meta/train.txt`` and ``meta/test.txt``) of 16 train and 4 test images
  made by ``tools/make_fake_food101.py``'s ``make_image`` and saved by PIL
  at that tool's quality 92, except two train images: one arithmetic-
  coded by libjpeg (the loader's libjpeg region path) and one CMYK (its
  PIL fallback); most have both sides at 200-280 px (the region path at
  crop 200), two are smaller (the resize path);
- ``streams/``: one stream per decoder feature. Written by PIL: 4:4:4,
  4:2:2, 4:2:0, grayscale, progressive, optimized Huffman, restart
  markers, EXIF, 16-bit DQT, odd sizes, CMYK, 16-bit gray PNG, GIF
  (interlaced and not), BMP (1-, 8-, 24- and 32-bit), lossy, lossless,
  RGBA, ICC/EXIF WebP. Written by libjpeg through a small C helper built
  here with ``gcc -ljpeg``: arithmetic coding (sequential, progressive,
  with restarts; one past PIL's 64 KiB read block), YCCK, and
  progressive scripts that leave coefficients unrefined (block
  smoothing). Written by the wheel's libwebp through ctypes
  (``libwebp()``): WebP with the simple loop filter, none, sharpness 7,
  1 and 4 segments, 8 token partitions, quantized alpha levels.
  Assembled with ``struct`` and ``zlib``: 16-bit RGB, RGBA and gray+alpha
  PNG, Adam7-interlaced PNG, a lossless (SOF3) JPEG, RLE8, 16-bit and
  top-down BMP, WebP ALPH raw and VP8L-coded with each filter, an
  animated WebP whose first frame is smaller than its canvas, 12-bit and
  hierarchical JPEG (a frame header patched); truncated JPEGs are other
  streams cut short, two of them just before EOI (one PIL decodes).
  TIFF, Netpbm, ICO, CUR and QOI (``tools/raster_writers.py``): TIFFs
  with LZW and a predictor, tiled Deflate, Deflate (32946) RGBA, JPEG
  YCbCr 4:2:0 strips sharing ``JPEGTables``, PackBits 4-bit palette,
  16-bit RGB big-endian, separate planes, BigTIFF, a float with the
  floating-point predictor, LZW YCbCr 4:2:0 (libtiff's RGBA path), an
  Orientation tag; PIL's own JPEG RGB, CMYK, LZMA and CCITT (G3 1-D and
  2-D, G4, Modified Huffman) TIFFs; binary and plain PPM, 16-bit and
  maxval-100 PGM, plain and binary PBM, PFM; ICO with PNG and BMP
  entries, a CUR; QOI RGB and RGBA. The last TIFF compressions PIL's
  libtiff decodes: ZSTD (PIL's own; the ``zstandard`` module's at levels
  1 and 19, with a checksum, a second frame after a full first one, a
  skippable frame after the data, predictor 2), raw-16 with FillOrder 2
  (a row a strip), ThunderScan with every code, and old-style JPEG
  (4:4:4 in JPEGInterchangeFormat, 4:2:0 with a strip a restart interval,
  4:2:2 rebuilt from JPEGQTables, JPEGDCTables and JPEGACTables), and
  a CIELab TIFF. The formats PIL's opener walk reaches past those
  (``raster_writers.legacy_streams``): TGA (PIL's uncompressed RGB, whose
  first bytes are CUR's signature, RGBA, RLE, grey, palette, LA with an
  ID; 16-bit, mirrored RLE, literals across rows and a 16-bit colour map
  after a start offset assembled), a bare DIB, PCX (PIL's RGB, palette,
  grey and 1-bit; 2 and 4 bit planes assembled), a DCX, SGI (PIL's raw
  8- and 16-bit; RLE assembled), Sun raster (24-bit of types 1 and 3,
  RLE with a colour map, 1- and 32-bit), PIL's IM (RGB, palette), IMT,
  IPTC (raw grey, a grey JPEG in one band of RGB) and SPIDER (PIL's, and
  little-endian with NaN and infinities); PSD (``raster_writers.
  psd_streams``, by hand: each colour mode PIL reads, raw and PackBits,
  resources, a layer section, PackBits runs across rows, and the 16-bit
  and PSB files PIL refuses) and JPEG 2000 (``raster_writers.
  jpeg2000_streams``: PIL's writer, the wheel's OpenJPEG through ctypes
  (``libopenjp2()``) for the code-block styles, SOP/EPH, POC,
  tile-parts, ROI and subsampled sYCC, JP2 boxes by hand for CMYK and
  palettes; two 800 x 608 photos among them);
- ``goldens.json``: sha256 digests (not pixels, to stay small) of, for
  each stream, the JAX package's ``decode_jpeg_rgb8`` (``sha256``; for
  PNG, GIF, BMP and WebP PIL's decode; ``binding_refused`` where it
  raises) and of what its server decodes, PIL's
  ``Image.open(...).convert("RGB")`` (``served_sha256``, or
  ``served_refused`` where PIL raises); of each lossy WebP still's
  Y/U/V planes, libwebp's ``WebPDecodeYUV`` (``yuv_sha256``: the three
  planes' bytes in turn); of its region decodes at seeded
  regions (``crops``: ``decode_jpeg_crop_rgb8``, or its loader's PIL
  fallback, full decode then crop, where that returns None); of its
  ``encode_jpeg_rgb8`` at q90 on a seeded 256x256 image and at q92 on a
  seeded 800x608 one (``chip_smoke.jpeg_test_image``); and of the first
  two batches of its ``SRDataLoader`` over the mini tree's train split
  (seed 0, crop 200, batch 8; train and eval); and of PIL's decode of the
  PhotoCD ``chip_smoke.pcd_stream`` builds (``generated``).

    python tools/export_port_assets.py      # JAX_PLATFORMS=cpu is set here
    python tools/export_port_assets.py --what jpeg
    python tools/export_port_assets.py --what attentionsr   # ~4 min
    python tools/export_port_assets.py --what resnet
    python tools/export_port_assets.py --what attentionsr_tunes  # ~10 min

The directory is not called ``weights``: files under any ``weights``
directory are kept out of the copy sent to the GPU host.
"""
from __future__ import annotations

import argparse
import ctypes
import io
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import zlib

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

from chip_smoke import jpeg_test_image, pcd_stream, sha256  # noqa: E402
from food101_sr_tpu import native as jax_native  # noqa: E402
from food101_sr_tpu.data import (Food101Source, SRDataLoader,  # noqa: E402
                                 prepare_batch)
from food101_sr_tpu.training import load_checkpoint  # noqa: E402
from food101_sr_tpu_torch.training.packed import (  # noqa: E402
    pack_state_dict)
from tools.export_sr_checkpoint import export_state_dict  # noqa: E402
from tools.make_fake_food101 import CLASSES, make_image  # noqa: E402
from tools.raster_writers import (dib, ico, jpeg2000_streams,  # noqa: E402
                                  jpeg_strip, psd_streams,
                                  jpeg_tables, legacy_streams, lzw, netpbm,
                                  ojpeg, pfm,
                                  pil_tiff, qoi, raw16, thunderscan,
                                  tiff_file, tiff_image, zstd)

CHECKPOINT = os.path.join(ROOT, "weights", "winner_srcnn_best")
ASSETS = os.path.join(ROOT, "food101_sr_tpu_torch", "assets")
LR_SHAPES = [(32, 32), (32, 32), (32, 32), (96, 80)]
SEED = 0


def golden_inputs(seed: int = SEED) -> list[np.ndarray]:
    """The seeded uint8 LR inputs, (h, w, 3) each."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), np.uint8) for h, w in LR_SHAPES]


def jax_served(inputs, checkpoint: str = CHECKPOINT, dtype=jnp.float32,
               quantize: str = "") -> list[np.ndarray]:
    """The JAX package's server's outputs for ``inputs`` (float32 unless
    ``dtype`` says otherwise)."""
    import serve

    server = serve.SRServer("auto", checkpoint, dtype=dtype,
                            quantize=quantize)
    return [np.asarray(server.upscale(Image.fromarray(x)), np.uint8)
            for x in inputs]


# The AttentionSR winner (--what attentionsr): the mini tree's four test
# images as small inputs, and one large HR drawn by make_image whose x4 LR
# takes the server's tiled path
ATTN_CHECKPOINT = os.path.join(ROOT, "weights", "winner_attentionsr_best")
ATTN_LARGE_HR, ATTN_LARGE_SEED = (800, 608), 19  # (h, w): a 200x152 LR


def winner_hr() -> list[np.ndarray]:
    """The HR images of the AttentionSR goldens: the mini tree's four test
    JPEGs decoded by the JAX package's binding and centre-cropped to a
    multiple of 4, then the large HR (``make_image`` from a fixed seed,
    the generator of the tree the winners were trained on)."""
    base = os.path.join(ASSETS, "jpeg", "food-101")
    with open(os.path.join(base, "meta", "test.txt")) as f:
        names = f.read().split()
    out = []
    for name in names:
        with open(os.path.join(base, "images", name + ".jpg"), "rb") as f:
            img = jax_native.decode_jpeg_rgb8(f.read())
        out.append(center_crop4(img))
    out.append(make_image(np.random.default_rng(ATTN_LARGE_SEED),
                          *ATTN_LARGE_HR))
    return out


def center_crop4(img: np.ndarray) -> np.ndarray:
    """The centred crop of ``img`` whose sides are multiples of 4."""
    h, w = img.shape[:2]
    y0, x0 = (h % 4) // 2, (w % 4) // 2
    return img[y0:y0 + h - h % 4, x0:x0 + w - w % 4]


def winner_lr(hr: np.ndarray) -> np.ndarray:
    """The uint8 x4 LR of ``hr``, degraded as the JAX package's eval step
    does (``data.prepare_batch``: ToTensor, the antialiased bicubic) and
    rounded to uint8."""
    lr, _ = prepare_batch(jnp.asarray(hr)[None], 4)
    return np.asarray(jnp.clip(lr[0], 0.0, 1.0) * 255.0 + 0.5).astype(
        np.uint8)


def port_alexnet_npz(weights_dir: str) -> str:
    """Write the port's seeded fallback AlexNet (what its LPIPS runs on
    without weight files, the card host's case) as JAX's
    ``alexnet_features.npz`` into ``weights_dir``, so both packages score
    LPIPS on the same weights; the heads stay uniform on both sides."""
    import warnings

    from food101_sr_tpu_torch.models.feature_nets import load_alexnet

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        net, pretrained = load_alexnet(tempfile.mkdtemp())
    assert not pretrained
    path = os.path.join(weights_dir, "alexnet_features.npz")
    np.savez(path, **{
        f"{name}/{leaf}": (m.weight.detach().numpy().transpose(2, 3, 1, 0)
                           if leaf == "kernel" else m.bias.detach().numpy())
        for name, m in net.named_children() for leaf in ("kernel", "bias")})
    return path


def jax_scores(srs, hrs) -> dict:
    """Per image, the JAX package's MetricsCalculator (LPIPS on the port's
    seeded AlexNet, ``port_alexnet_npz``) of each uint8 SR against its
    uint8 HR: {"psnr": [...], "ssim": [...], "lpips": [...], "nlpd": [...]}."""
    import warnings

    from food101_sr_tpu.metrics import MetricsCalculator

    with tempfile.TemporaryDirectory() as d:
        port_alexnet_npz(d)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the heads' uniform fallback
            calc = MetricsCalculator(weights_dir=d)
    assert calc.pretrained and not calc.heads_pretrained
    out = {k: [] for k in ("psnr", "ssim", "lpips", "nlpd")}
    for sr, hr in zip(srs, hrs):
        got = calc.compute(sr[None].astype(np.float32) / 255,
                           hr[None].astype(np.float32) / 255)
        for k in out:
            out[k].append(got[k])
    return out


def psnr_u8(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR in dB of two uint8 images (the metric's data range 1 on /255)."""
    d = a.astype(np.float64) / 255 - b.astype(np.float64) / 255
    return float(10 * np.log10(1.0 / np.mean(d * d)))


def snr_db(got, ref) -> float:
    """SNR in dB of ``got`` against ``ref`` over all their pixels (uint8
    values), as chip_smoke.py's quant phase measures int8 against bf16."""
    g = np.concatenate([x.ravel() for x in got]).astype(np.float64)
    r = np.concatenate([x.ravel() for x in ref]).astype(np.float64)
    return float(10 * np.log10(np.mean(r * r) / np.mean((g - r) ** 2)))


def png_array(img: np.ndarray) -> np.ndarray:
    """``img`` as the bytes of a PNG stream (PIL, optimized), a 1-D uint8
    array: PNG's row filters store the goldens' images in half the room
    deflate alone takes."""
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG", optimize=True)
    return np.frombuffer(buf.getvalue(), np.uint8)


def winner_goldens(checkpoint: str, lrs, hrs, prefix: str = "") -> dict:
    """The goldens of one winner (module docstring) under keys that start
    with ``prefix``: JAX's float32 served outputs for ``lrs`` as PNG
    streams, then, on the small inputs (all but the last), its scores
    against ``hrs``, its bfloat16 and int8 servers' PSNRs and the int8
    SNR."""
    small = len(lrs) - 1
    f32 = jax_served(lrs, checkpoint)
    bf16 = jax_served(lrs[:small], checkpoint, dtype=jnp.bfloat16)
    int8 = jax_served(lrs[:small], checkpoint, dtype=jnp.bfloat16,
                      quantize="int8")
    scores = jax_scores(f32[:small], hrs[:small])
    return {
        **{f"{prefix}sr_{i}": png_array(y) for i, y in enumerate(f32)},
        **{prefix + k: np.asarray(v) for k, v in scores.items()},
        prefix + "psnr_bf16": np.asarray([psnr_u8(y, h)
                                          for y, h in zip(bf16, hrs)]),
        prefix + "psnr_int8": np.asarray([psnr_u8(y, h)
                                          for y, h in zip(int8, hrs)]),
        prefix + "snr_int8": np.asarray(snr_db(int8, f32[:small]))}


def winner_state_dict(checkpoint: str, arch: str) -> dict:
    """The reference-layout float32 state_dict of the Orbax ``checkpoint``
    (which must hold ``arch``), as torch tensors."""
    sd, got = export_state_dict(load_checkpoint(checkpoint))
    if got != arch:
        raise SystemExit(f"{checkpoint} holds {got}, not {arch}")
    # ascontiguousarray makes 0-d arrays 1-d: keep each shape (a
    # BatchNorm's num_batches_tracked is a scalar)
    return {k: torch.from_numpy(np.ascontiguousarray(v).reshape(
        np.shape(v))) for k, v in sd.items()}


def export_attentionsr(out_dir: str) -> tuple[str, str]:
    """Write winner_attentionsr.f101w and winner_attentionsr_goldens.npz
    (module docstring) under ``out_dir``; return their paths."""
    pack = os.path.join(out_dir, "winner_attentionsr.f101w")
    pack_state_dict(winner_state_dict(ATTN_CHECKPOINT, "AttentionSR"), pack)
    hrs = winner_hr()
    lrs = [winner_lr(hr) for hr in hrs]
    npz = os.path.join(out_dir, "winner_attentionsr_goldens.npz")
    np.savez_compressed(
        npz, **{f"lr_{i}": png_array(x) for i, x in enumerate(lrs)},
        **winner_goldens(ATTN_CHECKPOINT, lrs, hrs))
    return pack, npz


# The ResNetSR winners (--what resnet): the plain one and its QAT
# fine-tune, each under its tag in one goldens file
RESNET_WINNERS = {
    "resnet": os.path.join(ROOT, "weights", "winner_resnet_best"),
    "resnet_qat": os.path.join(ROOT, "weights", "winner_resnet_qat_best")}


def attentionsr_lrs(out_dir: str) -> list[np.ndarray]:
    """The LR inputs stored in the AttentionSR goldens (``out_dir``'s, or
    the committed ones), held equal to ``winner_lr(winner_hr())``."""
    npz = os.path.join(out_dir, "winner_attentionsr_goldens.npz")
    g = np.load(npz if os.path.exists(npz) else
                os.path.join(ASSETS, "winner_attentionsr_goldens.npz"))
    n = sum(k.startswith("lr_") for k in g.files)
    lrs = [np.asarray(Image.open(io.BytesIO(g[f"lr_{i}"].tobytes())))
           for i in range(n)]
    if not all(np.array_equal(x, winner_lr(hr))
               for x, hr in zip(lrs, winner_hr(), strict=True)):
        raise SystemExit("the AttentionSR goldens' LRs are not "
                         "winner_lr(winner_hr())")
    return lrs


def export_resnet(out_dir: str) -> tuple[str, ...]:
    """Write winner_resnet.f101w, winner_resnet_qat.f101w and
    winner_resnet_goldens.npz (module docstring) under ``out_dir``; return
    their paths."""
    paths = []
    for tag, checkpoint in RESNET_WINNERS.items():
        paths.append(os.path.join(out_dir, f"winner_{tag}.f101w"))
        pack_state_dict(winner_state_dict(checkpoint, "RESNET"), paths[-1])
    hrs = winner_hr()
    lrs = attentionsr_lrs(out_dir)
    npz = os.path.join(out_dir, "winner_resnet_goldens.npz")
    np.savez_compressed(npz, **{
        k: v for tag, checkpoint in RESNET_WINNERS.items()
        for k, v in winner_goldens(checkpoint, lrs, hrs, tag + "_").items()})
    return (*paths, npz)


# The AttentionSR fine-tunes (--what attentionsr_tunes): stored as
# bfloat16 deltas against winner_attentionsr.f101w, with goldens from JAX
# on the same rounded weights
ATTN_TUNES = {
    "attentionsr_gan": os.path.join(ROOT, "weights",
                                    "winner_attentionsr_gan_best"),
    "attentionsr_qat": os.path.join(ROOT, "weights",
                                    "winner_attentionsr_qat_best")}


def rounded_checkpoint(checkpoint: str, out: str) -> str:
    """Write the Orbax ``checkpoint`` with every float32 leaf rounded to
    bfloat16 (to nearest even) and widened back to float32 at ``out``, the
    weights the port's bf16 pack decodes to."""
    from food101_sr_tpu.training import save_checkpoint

    def rne(x):
        x = np.asarray(x)
        if x.dtype != np.float32:
            return x
        return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(
            jnp.float32))

    return save_checkpoint(jax.tree_util.tree_map(
        rne, load_checkpoint(checkpoint)), out)


def rounding_cost(checkpoint: str, rounded: str, lrs, hrs,
                  prefix: str) -> dict:
    """What rounding to bfloat16 costs the JAX float32 server: its PSNR
    on the original weights for the small inputs (``psnr_orbax``), and
    per input the largest uint8 difference between the original's and the
    rounded weights' outputs (``levels_orbax``)."""
    small = len(lrs) - 1
    orig = jax_served(lrs, checkpoint)
    rnd = jax_served(lrs, rounded)
    return {
        prefix + "psnr_orbax": np.asarray([psnr_u8(y, h) for y, h in
                                           zip(orig[:small], hrs)]),
        prefix + "levels_orbax": np.asarray(
            [int(np.abs(a.astype(np.int16) - b).max())
             for a, b in zip(orig, rnd)])}


def export_attentionsr_tunes(out_dir: str) -> tuple[str, ...]:
    """Write winner_attentionsr_gan.f101w, winner_attentionsr_qat.f101w
    (bfloat16 deltas against ``out_dir``'s winner_attentionsr.f101w) and
    winner_attentionsr_tunes_goldens.npz (module docstring); return their
    paths."""
    base = os.path.join(out_dir, "winner_attentionsr.f101w")
    hrs = winner_hr()
    lrs = attentionsr_lrs(out_dir)
    paths, gold = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, checkpoint in ATTN_TUNES.items():
            paths.append(os.path.join(out_dir, f"winner_{tag}.f101w"))
            pack_state_dict(winner_state_dict(checkpoint, "AttentionSR"),
                            paths[-1], base=base, dtype="bfloat16")
            rounded = rounded_checkpoint(checkpoint,
                                         os.path.join(tmp, tag))
            gold.update(winner_goldens(rounded, lrs, hrs, tag + "_"))
            gold.update(rounding_cost(checkpoint, rounded, lrs, hrs,
                                      tag + "_"))
            small = len(lrs) - 1
            print(f"{tag}: bf16 rounding: JAX f32 PSNR "
                  f"{np.mean(gold[tag + '_psnr_orbax']):.6f} dB on the Orbax "
                  f"weights, {np.mean(gold[tag + '_psnr'][:small]):.6f} on "
                  f"the rounded ones; outputs up to "
                  f"{gold[tag + '_levels_orbax'].max()} levels apart")
    npz = os.path.join(out_dir, "winner_attentionsr_tunes_goldens.npz")
    np.savez_compressed(npz, **gold)
    return (*paths, npz)


# (h, w) of the mini tree's images: 16 train (two below the crop of 200),
# then 4 test
FOOD_SHAPES = [(212, 236), (240, 204), (200, 200), (226, 251), (150, 260),
               (205, 222), (263, 210), (231, 231), (201, 248), (230, 170),
               (244, 219), (209, 203), (218, 265), (257, 228), (203, 241),
               (236, 207), (224, 214), (210, 245), (248, 202), (216, 233)]
N_FOOD_TRAIN = 16
FOOD_ARITH, FOOD_CMYK = 3, 9  # train images written arithmetic-coded, CMYK
LOADER = dict(seed=0, crop_size=200, batch_size=8, batches=2)
ENCODE = [(256, 256, 90, 1), (608, 800, 92, 2)]  # h, w, quality, seed


def _pil_jpeg(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _pil_rgb(data: bytes) -> np.ndarray:
    """What the JAX package's server decodes: PIL's convert("RGB")."""
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


# libjpeg's encoder with the options PIL does not expose: arithmetic
# coding, YCCK, and progression scripts that stop before refinement
_LIBJPEG_ENC = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>
long enc(const unsigned char* in, int w, int h, int nc, int quality,
         int ycck, int prog, int arith, int restart_rows, const int* hv,
         unsigned char* out, long cap) {
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr e;
  unsigned char* buf = NULL;
  unsigned long sz = 0;
  static jpeg_scan_info script[8];
  c.err = jpeg_std_error(&e);
  jpeg_create_compress(&c);
  jpeg_mem_dest(&c, &buf, &sz);
  c.image_width = w;
  c.image_height = h;
  c.input_components = nc;
  c.in_color_space = nc == 4 ? JCS_CMYK : JCS_RGB;
  jpeg_set_defaults(&c);
  if (ycck) jpeg_set_colorspace(&c, JCS_YCCK);
  jpeg_set_quality(&c, quality, TRUE);
  if (hv)  /* sampling factors (h, v) of each of 3 components */
    for (int i = 0; i < 3; i++) {
      c.comp_info[i].h_samp_factor = hv[2 * i];
      c.comp_info[i].v_samp_factor = hv[2 * i + 1];
    }
  if (prog == 1) jpeg_simple_progression(&c);
  if (prog >= 2) {  /* 2: AC scans with Al 1-2 and no refinement; 3: DC only */
    int n = 0, i;
    script[n].comps_in_scan = c.num_components;
    for (i = 0; i < c.num_components; i++) script[n].component_index[i] = i;
    script[n].Ss = script[n].Se = script[n].Ah = script[n].Al = 0;
    n++;
    if (prog == 2)
      for (i = 0; i < c.num_components; i++, n++) {
        script[n].comps_in_scan = 1;
        script[n].component_index[0] = i;
        script[n].Ss = 1; script[n].Se = 63; script[n].Ah = 0;
        script[n].Al = i ? 2 : 1;
      }
    c.scan_info = script;
    c.num_scans = n;
  }
  c.arith_code = arith ? TRUE : FALSE;
  c.restart_in_rows = restart_rows;
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW r = (JSAMPROW)(in + (long)c.next_scanline * w * nc);
    jpeg_write_scanlines(&c, &r, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  long n = (long)sz <= cap ? (long)sz : -1;
  if (n > 0) memcpy(out, buf, sz);
  free(buf);
  return n;
}
"""


def libjpeg_encoder():
    """``encode(img, quality, ycck=0, prog=0, arith=0, restart_rows=0,
    hv=None)`` through the system libjpeg (built here with gcc; the helper's library
    lives in a temporary directory)."""
    d = tempfile.mkdtemp(prefix="libjpeg_enc")
    src, lib = os.path.join(d, "enc.c"), os.path.join(d, "libenc.so")
    with open(src, "w") as f:
        f.write(_LIBJPEG_ENC)
    subprocess.run(["gcc", "-O2", "-shared", "-fPIC", src, "-ljpeg", "-o",
                    lib], check=True, capture_output=True)
    enc = ctypes.CDLL(lib).enc
    enc.restype = ctypes.c_long
    enc.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 8 + [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long]

    def encode(img, quality, ycck=0, prog=0, arith=0, restart_rows=0,
               hv=None):
        img = np.ascontiguousarray(img)
        h, w, nc = img.shape
        out = ctypes.create_string_buffer(8 * img.nbytes + 65536)
        factors = (ctypes.c_int * 6)(*hv) if hv else None
        n = enc(img.ctypes.data, w, h, nc, quality, ycck, prog, arith,
                restart_rows, factors, out, len(out))
        if n <= 0:
            raise RuntimeError("libjpeg encode failed")
        return out.raw[:n]
    return encode


class _WebPConfig(ctypes.Structure):
    """libwebp's WebPConfig (encode.h), field for field."""
    _fields_ = [(n, ctypes.c_float if n in ("quality", "target_PSNR")
                 else ctypes.c_int) for n in (
        "lossless quality method image_hint target_size target_PSNR "
        "segments sns_strength filter_strength filter_sharpness filter_type "
        "autofilter alpha_compression alpha_filtering alpha_quality pass_ "
        "show_compressed preprocessing partitions partition_limit "
        "emulate_jpeg_size thread_level low_memory near_lossless exact "
        "use_delta_palette use_sharp_yuv qmin qmax").split()] + [
        ("pad", ctypes.c_uint32 * 8)]


class _WebPPicture(ctypes.Structure):
    """libwebp's WebPPicture (encode.h), field for field."""
    _vp, _i, _u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    _fields_ = [("use_argb", _i), ("colorspace", _i), ("width", _i),
                ("height", _i), ("y", _vp), ("u", _vp), ("v", _vp),
                ("y_stride", _i), ("uv_stride", _i), ("a", _vp),
                ("a_stride", _i), ("pad1", _u * 2), ("argb", _vp),
                ("argb_stride", _i), ("pad2", _u * 3), ("writer", _vp),
                ("custom_ptr", _vp), ("extra_info_type", _i),
                ("extra_info", _vp), ("stats", _vp), ("error_code", _i),
                ("progress_hook", _vp), ("user_data", _vp),
                ("pad3", _u * 3), ("pad4", _vp), ("pad5", _vp),
                ("pad6", _u * 8), ("memory_", _vp), ("memory_argb_", _vp),
                ("pad7", _vp * 2)]


class _WebPWriter(ctypes.Structure):
    _fields_ = [("mem", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("max_size", ctypes.c_size_t), ("pad", ctypes.c_uint32)]


def libwebp():
    """The libwebp that PIL's wheel ships, through ctypes: ``encode(img,
    **config)`` (uint8 HxWx3 or HxWx4; any WebPConfig field, e.g.
    ``filter_type=0``, ``segments=1``, ``partitions=3``,
    ``alpha_filtering=2``) -> a whole WebP file, and ``decode_yuv(data)``
    -> WebPDecodeYUV's (y, u, v) planes. Raises OSError where the wheel
    has no libwebp."""
    import glob
    import types

    import PIL
    libs = os.path.join(os.path.dirname(PIL.__file__), os.pardir,
                        "pillow.libs")
    found = glob.glob(os.path.join(libs, "libwebp-*.so*"))
    if not found:
        raise OSError(f"no libwebp under {libs}")
    for dep in sorted(glob.glob(os.path.join(libs, "libsharpyuv-*.so*"))):
        ctypes.CDLL(dep, mode=ctypes.RTLD_GLOBAL)
    lib = ctypes.CDLL(found[0])
    abi = 0x0200  # the encoder and decoder ABIs' major version
    vp = ctypes.c_void_p
    lib.WebPDecodeYUV.restype = vp
    lib.WebPDecodeYUV.argtypes = [ctypes.c_char_p, ctypes.c_size_t] + [vp] * 6
    lib.WebPFree.argtypes = [vp]

    def encode(img, **config):
        img = np.ascontiguousarray(img, np.uint8)
        h, w, nc = img.shape
        cfg = _WebPConfig()
        if not lib.WebPConfigInitInternal(ctypes.byref(cfg), 0,
                                          ctypes.c_float(75.0), abi):
            raise OSError("WebPConfigInit failed")
        for k, v in config.items():
            setattr(cfg, k, v)
        pic = _WebPPicture()
        if not lib.WebPPictureInitInternal(ctypes.byref(pic), abi):
            raise OSError("WebPPictureInit failed")
        pic.use_argb = int(bool(cfg.lossless))
        pic.width, pic.height = w, h
        imp = (lib.WebPPictureImportRGBA if nc == 4
               else lib.WebPPictureImportRGB)
        if not imp(ctypes.byref(pic), img.ctypes.data_as(vp), w * nc):
            raise OSError("WebPPictureImport failed")
        wr = _WebPWriter()
        lib.WebPMemoryWriterInit(ctypes.byref(wr))
        pic.writer = ctypes.cast(lib.WebPMemoryWrite, vp).value
        pic.custom_ptr = ctypes.addressof(wr)
        ok = lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic))
        data = ctypes.string_at(wr.mem, wr.size) if ok else None
        lib.WebPMemoryWriterClear(ctypes.byref(wr))
        lib.WebPPictureFree(ctypes.byref(pic))
        if data is None:
            raise OSError(f"WebPEncode failed ({pic.error_code})")
        return data

    def decode_yuv(data: bytes):
        w, h, stride, uv_stride = (ctypes.c_int() for _ in range(4))
        u, v = ctypes.c_void_p(), ctypes.c_void_p()
        y = lib.WebPDecodeYUV(data, len(data), ctypes.byref(w),
                              ctypes.byref(h), ctypes.byref(u),
                              ctypes.byref(v), ctypes.byref(stride),
                              ctypes.byref(uv_stride))
        if not y:
            raise ValueError("WebPDecodeYUV refused the stream")
        W, H, uw, uh = w.value, h.value, (w.value + 1) // 2, (h.value + 1) // 2

        def plane(ptr, rows, cols, st):
            raw = ctypes.string_at(ptr, st * (rows - 1) + cols)
            return np.array([np.frombuffer(raw[r * st:r * st + cols],
                                           np.uint8) for r in range(rows)])
        out = (plane(y, H, W, stride.value), plane(u.value, uh, uw,
                                                    uv_stride.value),
               plane(v.value, uh, uw, uv_stride.value))
        lib.WebPFree(y)
        return out

    return types.SimpleNamespace(encode=encode, decode_yuv=decode_yuv)


def webp_chunks(data: bytes) -> list:
    """(fourcc, payload) of each chunk of a WebP file's RIFF body."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        tag, n = data[pos:pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        out.append((tag, data[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def webp_file(chunks) -> bytes:
    """A WebP file from (fourcc, payload) chunks, each padded to even."""
    body = b"".join(t + struct.pack("<I", len(p)) + p + b"\0" * (len(p) & 1)
                    for t, p in chunks)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def webp_vp8x(w: int, h: int, flags: int) -> tuple:
    return (b"VP8X", struct.pack("<I", flags) + (w - 1).to_bytes(3, "little")
            + (h - 1).to_bytes(3, "little"))


def webp_raw_alpha(alpha: np.ndarray, filt: int) -> bytes:
    """An uncompressed ALPH payload: the plane predicted by ``filt`` (0
    none, 1 horizontal, 2 vertical, 3 gradient) as libwebp's filters do."""
    a = alpha.astype(np.int32)
    h, w = a.shape
    pred = np.zeros_like(a)
    if filt:
        pred[0, 1:] = a[0, :-1]  # the first row is always horizontal
        if filt == 1:
            pred[1:, 0] = a[:-1, 0]
            pred[1:, 1:] = a[1:, :-1]
        elif filt == 2:
            pred[1:] = a[:-1]
        else:
            pred[1:, 0] = a[:-1, 0]
            pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0,
                                   255)
    return bytes([filt << 2]) + ((a - pred) & 0xFF).astype(np.uint8).tobytes()


def lossless_jpeg(img: np.ndarray, predictor: int, pt: int = 0,
                  restart_rows: int = 0) -> bytes:
    """A lossless (SOF3) JPEG of an 8-bit (h, w, n) image: one interleaved
    scan with ``predictor`` (1-7) and point transform ``pt``, restarts
    every ``restart_rows`` rows, the Annex K luminance DC table extended to
    category 16. PIL's libjpeg-turbo decodes it; the JAX package's libjpeg
    refuses SOF3 and falls back to PIL."""
    bits = [0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0]
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length]):
            codes[k] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    x = img.astype(np.int64) >> pt
    h, w, n = x.shape
    data, acc = bytearray(), []

    def flush():
        stream = "".join(acc)
        stream += "1" * (-len(stream) % 8)
        for i in range(0, len(stream), 8):
            data.append(int(stream[i:i + 8], 2))
            if data[-1] == 0xFF:
                data.append(0)
        acc.clear()
    first, rst = 0, 0
    for r in range(h):
        if restart_rows and r and r % restart_rows == 0:
            flush()
            data.extend((0xFF, 0xD0 + rst))
            first, rst = r, (rst + 1) & 7
        for c in range(w):
            for ci in range(n):
                if r == first:
                    p = (1 << (7 - pt)) if c == 0 else x[r, c - 1, ci]
                elif c == 0:
                    p = x[r - 1, c, ci]
                else:
                    a, b, d = x[r, c - 1, ci], x[r - 1, c, ci], x[r - 1, c - 1, ci]
                    p = (a, b, d, a + b - d, a + ((b - d) >> 1),
                         b + ((a - d) >> 1), (a + b) >> 1)[predictor - 1]
                diff = int((x[r, c, ci] - p + 32768) % 65536) - 32768
                s = 16 if diff == -32768 else abs(diff).bit_length()
                cd, ln = codes[s]
                acc.append(format(cd, f"0{ln}b"))
                if 0 < s < 16:
                    acc.append(format(diff if diff > 0 else diff + (1 << s) - 1,
                                      f"0{s}b"))
    flush()

    def seg(m, body):
        return bytes([0xFF, m]) + struct.pack(">H", len(body) + 2) + body
    return (b"\xff\xd8" + seg(0xC4, bytes([0]) + bytes(bits[1:]) + bytes(range(17)))
            + (seg(0xDD, struct.pack(">H", restart_rows * w))
               if restart_rows else b"")
            + seg(0xC3, bytes([8]) + struct.pack(">HHB", h, w, n)
                  + b"".join(bytes([i + 1, 0x11, 0]) for i in range(n)))
            + seg(0xDA, bytes([n]) + b"".join(bytes([i + 1, 0]) for i in range(n))
                  + bytes([predictor, 0, pt]))
            + bytes(data) + b"\xff\xd9")


def _png(vals: np.ndarray, depth: int, color: int, interlace: bool,
         plte: bytes = b"") -> bytes:
    """A PNG of ``vals`` (h, w, channels) sample values, every row of every
    pass with filter type (row % 5), Adam7 if ``interlace``."""
    h, w, ch = vals.shape
    passes = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
              (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)) if interlace \
        else ((0, 0, 1, 1),)
    bpp = max(1, ch * depth // 8)
    raw = bytearray()
    for x0, y0, dx, dy in passes:
        sub = vals[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        flat = sub.reshape(sub.shape[0], -1)
        if depth == 16:
            rows = flat.astype(">u2").view(np.uint8).reshape(len(flat), -1)
        elif depth == 8:
            rows = flat.astype(np.uint8)
        else:
            per = 8 // depth
            pad = np.zeros((len(flat), -flat.shape[1] % per), flat.dtype)
            v = np.concatenate([flat, pad], 1).reshape(len(flat), -1, per)
            rows = (v << np.arange(8 - depth, -1, -depth)).sum(-1).astype(
                np.uint8)
        prev = np.zeros(rows.shape[1], np.int64)
        for r, row in enumerate(rows.astype(np.int64)):
            ft = r % 5
            left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
            upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
            if ft == 4:
                p = left + prev - upleft
                pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
                pred = np.where((pa <= pb) & (pa <= pc), left,
                                np.where(pb <= pc, prev, upleft))
            else:
                pred = [0 * row, left, prev, (left + prev) // 2][ft]
            raw += bytes([ft]) + ((row - pred) % 256).astype(np.uint8).tobytes()
            prev = row

    def chunk(t, b):
        return struct.pack(">I", len(b)) + t + b + struct.pack(
            ">I", zlib.crc32(t + b))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0,
                                         int(interlace)))
            + (chunk(b"PLTE", plte) if plte else b"")
            + chunk(b"IDAT", zlib.compress(bytes(raw), 9))
            + chunk(b"IEND", b""))


def _bmp(rows: list, w: int, h: int, bits: int, compression: int = 0,
         masks: tuple = (), palette: bytes = b"", top_down: bool = False,
         ) -> bytes:
    """A BMP with a 40-byte info header: ``rows`` are the stored rows in
    file order (padded here for raw data), masks after the header for
    BI_BITFIELDS, ``palette`` as BGRX quads."""
    if compression in (0, 3):
        stride = ((w * bits + 31) >> 3) & ~3
        pix = b"".join(r + bytes(stride - len(r)) for r in rows)
    else:
        pix = b"".join(rows)
    hdr = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bits,
                      compression, len(pix), 2835, 2835,
                      len(palette) // 4, 0)
    hdr += b"".join(struct.pack("<I", m) for m in masks) + palette
    off = 14 + len(hdr)
    return b"BM" + struct.pack("<IHHI", off + len(pix), 0, 0, off) + hdr + pix


def _other_streams(rng) -> dict:
    """name -> bytes of the PNG, GIF, BMP and WebP streams."""
    img = make_image(rng, 40, 48)
    out = {}
    gray16 = Image.fromarray((img[..., 0].astype(np.uint16) * 3 + 100))
    buf = io.BytesIO()
    gray16.save(buf, format="PNG")
    out["gray16.png"] = buf.getvalue()
    wide = img.astype(np.uint16) * 257 + rng.integers(0, 256, img.shape)
    out["rgb16.png"] = _png(wide, 16, 2, False)
    out["rgba16.png"] = _png(np.concatenate([wide, wide[..., :1]], 2), 16, 6,
                             False)
    out["graya16.png"] = _png(wide[..., :2], 16, 4, False)
    out["interlaced.png"] = _png(img, 8, 2, True)
    out["interlaced_gray16.png"] = _png(wide[..., :1], 16, 0, True)
    out["interlaced_palette.png"] = _png(
        (img[..., :1] >> 4), 4, 3, True,
        rng.integers(0, 256, 48, np.uint8).tobytes())
    pil = Image.fromarray(img)
    for name, kw in (("gif.gif", {}), ("gif_noninterlaced.gif",
                                       {"interlace": False})):
        buf = io.BytesIO()
        pil.convert("P").save(buf, format="GIF", **kw)
        out[name] = buf.getvalue()
    for mode, name in (("1", "bmp1.bmp"), ("P", "bmp8.bmp"),
                       ("RGB", "bmp24.bmp"), ("RGBA", "bmp32.bmp")):
        buf = io.BytesIO()
        pil.convert(mode).save(buf, format="BMP")
        out[name] = buf.getvalue()
    h, w = img.shape[:2]
    idx = (img[..., 1] >> 5).astype(np.uint8)
    pal = b"".join(bytes([b, g, r, 0]) for r, g, b in
                   rng.integers(0, 256, (8, 3)).tolist())
    rle = b""
    for row in idx[::-1]:  # bottom-up: runs, and an absolute run of 5
        row = row.tolist()
        rle += bytes([0, 5]) + bytes(row[:5]) + b"\x00"
        x = 5
        while x < w:
            n = 1
            while x + n < w and row[x + n] == row[x] and n < 255:
                n += 1
            rle += bytes([n, row[x]])
            x += n
        rle += b"\x00\x00"
    out["bmp_rle8.bmp"] = _bmp([rle + b"\x00\x01"], w, h, 8, 1, palette=pal)
    p565 = ((img[..., 0].astype(np.uint16) >> 3) << 11
            | (img[..., 1].astype(np.uint16) >> 2) << 5 | img[..., 2] >> 3)
    out["bmp16_565.bmp"] = _bmp([r.astype("<u2").tobytes() for r in p565[::-1]],
                                w, h, 16, 3, (0xF800, 0x7E0, 0x1F))
    out["bmp24_topdown.bmp"] = _bmp([r[:, ::-1].tobytes() for r in img], w,
                                    h, 24, top_down=True)
    buf = io.BytesIO()
    pil.save(buf, format="WEBP", quality=80)
    out["webp.webp"] = buf.getvalue()
    return out


def webp_lossless_alpha(alpha: np.ndarray, filt: int, encode) -> bytes:
    """A VP8L-coded ALPH payload: the plane predicted by ``filt`` as
    webp_raw_alpha does, coded by libwebp's lossless encoder as the green
    channel of an image (its VP8L stream without the 5-byte header)."""
    res = np.frombuffer(webp_raw_alpha(alpha, filt)[1:], np.uint8).reshape(
        alpha.shape)
    vp8l = dict(webp_chunks(encode(np.repeat(res[..., None], 3, 2),
                                   lossless=1, exact=1)))[b"VP8L"]
    return bytes([1 | filt << 2]) + vp8l[5:]


def webp_anmf(x: int, y: int, still: bytes) -> tuple:
    """An ANMF chunk at (x, y) holding a still's ALPH/VP8/VP8L chunks."""
    chunks = [(t, p) for t, p in webp_chunks(still)
              if t in (b"ALPH", b"VP8 ", b"VP8L")]
    img = chunks[-1][1]
    if chunks[-1][0] == b"VP8L":
        bits = int.from_bytes(img[1:5], "little")
        w, h = (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
    else:
        w, h = (v & 0x3FFF for v in struct.unpack_from("<HH", img, 6))
    hdr = b"".join(v.to_bytes(3, "little") for v in (x // 2, y // 2, w - 1,
                                                     h - 1, 100)) + b"\0"
    body = b"".join(t + struct.pack("<I", len(p)) + p + b"\0" * (len(p) & 1)
                    for t, p in chunks)
    return (b"ANMF", hdr + body)


def _webp_streams() -> dict:
    """name -> bytes of the WebP streams: PIL's lossy (quality 0, 50 and
    100, methods 0 and 6, odd sizes, a 512x384), lossless, RGBA, ICC and
    EXIF; libwebp's encoder (ctypes) for the simple filter, a filter
    strength of 0, sharpness 7, 1 and 4 segments, 8 token partitions,
    quantized alpha levels; and assembled here: ALPH raw and VP8L-coded
    with each filter, an animation whose first frame is smaller than the
    canvas."""
    rng = np.random.default_rng(17)
    enc = libwebp().encode
    out = {}

    def pil(img, **kw):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="WEBP", **kw)
        return buf.getvalue()
    photo = make_image(rng, 64, 64)
    for h, w in ((1, 1), (13, 7), (97, 131)):
        out[f"webp_{h}x{w}"] = pil(make_image(rng, h, w), quality=80)
    for q in (0, 50, 100):
        out[f"webp_q{q}"] = pil(photo, quality=q)
    for m in (0, 6):
        out[f"webp_method{m}"] = pil(photo, quality=75, method=m)
    big = make_image(rng, 384, 512)
    out["webp_512x384"] = pil(big, quality=60)
    for name, cfg in (("simple_filter", {"filter_type": 0}),
                      ("filter0", {"filter_strength": 0}),
                      ("sharpness7", {"filter_sharpness": 7}),
                      ("segments1", {"segments": 1}),
                      ("segments4", {"segments": 4, "sns_strength": 100}),
                      ("partitions8", {"partitions": 3})):
        out[f"webp_{name}"] = enc(photo, quality=70, **cfg)
    small = make_image(rng, 40, 48)
    out["webp_lossless"] = pil(small, lossless=True, exact=True)
    pal = (rng.integers(0, 6, (31, 37)) * 40).astype(np.uint8)
    out["webp_lossless_palette"] = pil(np.stack([pal, pal // 2, 255 - pal],
                                                2), lossless=True)
    alpha = np.clip(np.add.outer(np.arange(64) * 3, np.arange(64) * 2)
                    + rng.integers(0, 24, (64, 64)), 0, 255).astype(np.uint8)
    rgba = np.concatenate([photo, alpha[..., None]], 2)
    out["webp_rgba"] = pil(rgba, quality=70)
    out["webp_rgba_lossless"] = pil(rgba[:40, :48], lossless=True,
                                    exact=True)
    out["webp_alpha_levels"] = enc(rgba, quality=70, alpha_quality=50)
    base = webp_chunks(enc(rgba, quality=70, alpha_compression=0))
    for f in range(4):
        for kind, payload in (("raw", webp_raw_alpha(alpha, f)),
                              ("vp8l", webp_lossless_alpha(alpha, f, enc))):
            if kind == "vp8l" and f == 0:
                continue  # webp_rgba is that
            out[f"webp_alpha_{kind}_f{f}"] = webp_file(
                [(t, payload if t == b"ALPH" else p) for t, p in base])
    exif = Image.Exif()
    exif[0x010E] = "a plate of food"
    out["webp_icc_exif"] = pil(small, quality=80, icc_profile=bytes(64),
                               exif=exif.tobytes())
    frames = [enc(make_image(rng, 30, 40), quality=70),
              enc(make_image(rng, 48, 64), lossless=1),
              enc(np.concatenate([make_image(rng, 48, 64),
                                  alpha[:48, :, None]], 2), quality=70)]
    out["webp_animation"] = webp_file(
        [webp_vp8x(64, 48, 0x12), (b"ANIM", bytes(6)),
         webp_anmf(8, 6, frames[0]), webp_anmf(0, 0, frames[1]),
         webp_anmf(0, 0, frames[2])])
    return {f"{k}.webp": v for k, v in out.items()}


def _streams() -> dict:
    """name -> JPEG bytes, one per decoder feature."""
    rng = np.random.default_rng(11)
    photo = Image.fromarray(make_image(rng, 72, 88))
    exif = Image.Exif()
    exif[0x010E] = "a plate of food"
    out = {
        "444": _pil_jpeg(photo, quality=90, subsampling=0),
        "422": _pil_jpeg(photo, quality=90, subsampling=1),
        "420": _pil_jpeg(photo, quality=90, subsampling=2),
        "gray": _pil_jpeg(photo.convert("L"), quality=90),
        "progressive": _pil_jpeg(photo, quality=85, progressive=True),
        "progressive_444": _pil_jpeg(photo, quality=85, progressive=True,
                                     subsampling=0),
        "optimized": _pil_jpeg(photo, quality=85, optimize=True),
        "restart": _pil_jpeg(photo, quality=85, restart_marker_blocks=2),
        "exif": _pil_jpeg(photo, quality=85, exif=exif.tobytes()),
        "dqt16": _pil_jpeg(photo, qtables=[list(range(200, 264)),
                                           [300] * 64]),
        "cmyk": _pil_jpeg(photo.convert("CMYK"), quality=85),
    }
    for h, w in ((1, 1), (13, 7), (97, 131)):
        out[f"odd_{h}x{w}"] = _pil_jpeg(
            Image.fromarray(make_image(rng, h, w)), quality=88)
    enc = libjpeg_encoder()
    rgb = np.asarray(photo)
    cmyk = 255 - np.asarray(photo.convert("CMYK"))  # inverted, as Adobe's
    out.update({
        "arith": enc(rgb, 85, arith=1),
        "arith_progressive": enc(rgb, 85, prog=1, arith=1),
        "arith_restart": enc(rgb, 85, arith=1, restart_rows=1),
        "ycck": enc(cmyk, 85, ycck=1),
        "progressive_unrefined": enc(rgb, 85, prog=2),
        "progressive_dc_only": enc(rgb, 85, prog=3),
        "lossless": lossless_jpeg(make_image(rng, 24, 32), 7),
    })
    for name, src in (("truncated", "444"), ("truncated_progressive",
                                             "progressive"),
                      ("truncated_arith", "arith_progressive")):
        out[name] = out[src][:len(out[src]) * 2 // 3]
    out.update(_pil_feed_streams(enc))
    return ({f"{k}.jpg": v for k, v in out.items()} | _other_streams(rng)
            | _webp_streams() | _raster_streams() | _tiff_codec_streams()
            | legacy_streams() | psd_streams() | jpeg2000_streams()
            | _cielab_streams())


def _pil_ccitt(img: Image.Image, compression: str, rows: int, **kw) -> bytes:
    """A bilevel TIFF through PIL's libtiff writer, ``rows`` rows a strip
    (PIL sizes strips by TiffImagePlugin.STRIP_SIZE bytes)."""
    from PIL import TiffImagePlugin
    old = TiffImagePlugin.STRIP_SIZE
    TiffImagePlugin.STRIP_SIZE = rows * ((img.size[0] + 7) // 8)
    try:
        return pil_tiff(img, compression=compression, **kw)
    finally:
        TiffImagePlugin.STRIP_SIZE = old


def _raster_streams() -> dict:
    """name -> bytes of the TIFF, Netpbm, ICO, CUR and QOI streams: one per
    decoder feature the http phase uploads on the card (the tests hold
    the rest of each format's table against PIL live)."""
    rng = np.random.default_rng(29)
    photo = make_image(rng, 40, 48)
    pil = Image.fromarray(photo)
    out = {}
    out["tiff_lzw_pred2.tif"] = tiff_image(photo, 8, 2, compression=5,
                                           predictor=2, rows_per_strip=16)
    out["tiff_deflate_tiled.tif"] = tiff_image(photo, 8, 2, compression=8,
                                               tile=(32, 16))
    out["tiff_deflate32946_rgba.tif"] = tiff_image(
        np.concatenate([photo, photo[..., :1]], 2), 8, 2, compression=32946,
        extra=(2,), rows_per_strip=8)
    strips = [jpeg_strip(2, 85)(photo[y:y + 16]) for y in range(0, 40, 16)]
    tables, short = jpeg_tables(strips)
    out["tiff_jpeg_ycbcr420.tif"] = tiff_file(
        {256: (4, (48,)), 257: (4, (40,)), 258: (3, (8, 8, 8)),
         259: (3, (7,)), 262: (3, (6,)), 277: (3, (3,)), 278: (4, (16,)),
         284: (3, (1,)), 347: (7, tables), 530: (3, (2, 2))}, short)
    out["tiff_jpeg_rgb.tif"] = pil_tiff(pil, compression="jpeg", quality=85)
    idx = (photo[..., 1] >> 4).astype(np.uint8)
    cmap = rng.integers(0, 65536, 3 * 16)
    out["tiff_packbits_palette.tif"] = tiff_image(
        idx[..., None], 4, 3, compression=32773, colormap=cmap,
        rows_per_strip=10)
    bw = pil.convert("1")
    out["tiff_g4.tif"] = _pil_ccitt(bw, "group4", 12)
    out["tiff_g3_2d.tif"] = _pil_ccitt(bw, "group3", 12, tiffinfo={292: 1})
    out["tiff_g3.tif"] = _pil_ccitt(bw, "group3", 12)
    out["tiff_mh.tif"] = _pil_ccitt(bw, "tiff_ccitt", 12)
    wide = photo.astype(np.uint16) * 257 + rng.integers(0, 256, photo.shape)
    out["tiff_rgb16_be.tif"] = tiff_image(wide, 16, 2, order=">",
                                          compression=5, predictor=2,
                                          rows_per_strip=8)
    out["tiff_planar.tif"] = tiff_image(photo, 8, 2, compression=8, planar=2,
                                        rows_per_strip=16)
    out["tiff_bigtiff.tif"] = tiff_image(photo, 8, 2, compression=8,
                                         big=True, rows_per_strip=8)
    out["tiff_cmyk.tif"] = pil_tiff(pil.convert("CMYK"),
                                    compression="tiff_lzw")
    out["tiff_lzma.tif"] = pil_tiff(pil, compression="lzma")
    f32 = (photo[..., 0].astype(np.float32) * 1.25 - 20)[..., None]
    out["tiff_float_pred3.tif"] = tiff_image(f32, 32, 1, compression=8,
                                             predictor=3, sampleformat=3,
                                             rows_per_strip=8)
    ycc = rng.integers(0, 256, (20 * 24 * 6,), np.uint8).reshape(20, 24, 6)
    out["tiff_ycbcr_lzw.tif"] = tiff_file(
        {256: (4, (48,)), 257: (4, (40,)), 258: (3, (8, 8, 8)),
         259: (3, (5,)), 262: (3, (6,)), 277: (3, (3,)), 278: (4, (40,)),
         284: (3, (1,)), 530: (3, (2, 2))}, [lzw(ycc.tobytes())])
    out["tiff_orientation6.tif"] = tiff_image(
        photo, 8, 2, extra_tags={274: (3, (6,))}, rows_per_strip=13)
    gray = photo[..., 1]
    out["ppm_binary.ppm"] = netpbm(b"P6", photo, 255)
    out["ppm_plain.ppm"] = netpbm(b"P3", photo[:12, :16], 255, comment=True)
    out["pgm16.pgm"] = netpbm(b"P5", gray.astype(np.uint16) * 200, 65535)
    out["pgm_maxval100.pgm"] = netpbm(b"P5", gray // 3, 100)
    out["pbm_plain.pbm"] = netpbm(b"P1", (gray > 128).astype(np.uint8))
    out["pbm.pbm"] = netpbm(b"P4", (gray > 100).astype(np.uint8))
    out["pfm.pfm"] = pfm(gray.astype(np.float32) * 1.1 - 10, little=True)
    buf = io.BytesIO()
    Image.fromarray(photo[:32, :32]).save(buf, "PNG")
    pal = rng.integers(0, 256, (256, 3))
    out["ico_png.ico"] = ico([(16, 16, 0, 24, dib(photo[:16, :16], 24)),
                              (32, 32, 0, 32, buf.getvalue())])
    out["ico_bmp.ico"] = ico([(32, 32, 0, 8, dib(gray[:32, :32], 8, pal)),
                              (32, 32, 0, 24, dib(photo[:32, :32], 24))])
    out["cur_bmp.cur"] = ico([(32, 32, 0, 24, dib(photo[8:40, 8:40], 24))],
                             cursor=True)
    out["qoi_rgb.qoi"] = qoi(photo)
    out["qoi_rgba.qoi"] = qoi(np.concatenate([photo, gray[..., None]], 2))
    return out


def _tiff_codec_streams() -> dict:
    """name -> bytes of TIFFs in the compressions libtiff decodes with code
    of its own or libzstd's: ZSTD, raw-16, ThunderScan, old-style JPEG."""
    rng = np.random.default_rng(31)
    photo = make_image(rng, 40, 48)
    pil = Image.fromarray(photo)
    out = {"tiff_zstd.tif": pil_tiff(pil, compression="zstd")}
    raw = photo.tobytes()
    tags = {256: (4, (48,)), 257: (4, (40,)), 258: (3, (8, 8, 8)),
            259: (3, (50000,)), 262: (3, (2,)), 277: (3, (3,)),
            278: (4, (40,)), 284: (3, (1,))}
    out["tiff_zstd_l1.tif"] = tiff_file(tags, [zstd(raw, 1)])
    out["tiff_zstd_l19.tif"] = tiff_file(tags, [zstd(raw, 19)])
    out["tiff_zstd_checksum.tif"] = tiff_file(tags, [zstd(
        raw, 3, write_checksum=True, write_content_size=False)])
    # libtiff reads one frame a strip: a second one is never read
    out["tiff_zstd_two_frames.tif"] = tiff_file(tags, [
        zstd(raw, 3) + zstd(raw[::-1], 3)])
    skippable = struct.pack("<II", 0x184D2A53, 6) + b"f101sr"
    out["tiff_zstd_skippable.tif"] = tiff_file(tags, [zstd(raw, 3)
                                                      + skippable])
    out["tiff_zstd_pred2.tif"] = tiff_image(photo, 8, 2, compression=50000,
                                            predictor=2, rows_per_strip=16)
    bw = pil.convert("1")
    rows = [raw16(bw.crop((0, y, 48, y + 1))) for y in range(40)]
    out["tiff_raw16_fill2.tif"] = tiff_file(
        {256: (4, (48,)), 257: (4, (40,)), 258: (3, (1,)),
         259: (3, (32771,)), 262: (3, (1,)), 266: (3, (2,)),
         277: (3, (1,)), 278: (4, (1,))},
        [bytes(int(f"{b:08b}"[::-1], 2) for b in r) for r in rows])
    g4 = np.asarray(pil.convert("L")) >> 4
    g4[:, 20:30] = g4[:, 20:21]  # a run of one value
    out["tiff_thunderscan.tif"] = tiff_file(
        {256: (4, (48,)), 257: (4, (40,)), 258: (3, (4,)),
         259: (3, (32809,)), 262: (3, (1,)), 277: (3, (1,)),
         278: (4, (20,))},
        [thunderscan(g4[:20]), thunderscan(g4[20:])])
    out["tiff_ojpeg_444.tif"] = ojpeg(photo, "jif", 0)
    out["tiff_ojpeg_420.tif"] = ojpeg(photo, "jif_header", 2,
                                      rows_per_strip=16)
    out["tiff_ojpeg_tables.tif"] = ojpeg(photo, "tables", 1,
                                         rows_per_strip=8)
    return out


def _cielab_streams() -> dict:
    """A CIELab TIFF (PIL converts it through LittleCMS)."""
    rng = np.random.default_rng(37)
    lab = make_image(rng, 40, 48)
    return {"tiff_cielab.tif": tiff_image(lab, 8, 8)}



def _pil_feed_streams(enc) -> dict:
    """The JPEG uploads whose answer rests on how PIL feeds libjpeg: two
    baseline streams cut just before their EOI marker (one PIL decodes,
    its reader having read ahead no further than the data; one it
    refuses), an arithmetic-coded stream whose scan runs past PIL's first
    64 KiB block (refused: libjpeg's arithmetic decoder cannot suspend),
    and a 12-bit and a hierarchical stream (refused; the JAX package's
    binding refuses them too)."""
    rng = np.random.default_rng(23)
    out = {}
    while len(out) < 2:
        h, w = (int(v) for v in rng.integers(12, 64, 2))
        cut = _pil_jpeg(Image.fromarray(make_image(rng, h, w)),
                        quality=90)[:-2]
        try:
            _pil_rgb(cut)
            out.setdefault("cut_before_eoi_decodes", cut)
        except OSError:
            out.setdefault("cut_before_eoi", cut)
    side = 224
    while "arith_past_64k" not in out:  # just past one block: keep it small
        data = enc(make_image(rng, side, side), 97, arith=1)
        if len(data) > 65536:
            try:
                _pil_rgb(data)
            except OSError:
                out["arith_past_64k"] = data
        side += 4
    base = _pil_jpeg(Image.fromarray(make_image(rng, 16, 16)), quality=90)
    i = base.index(b"\xff\xc0")
    out["precision_12bit"] = base[:i + 4] + b"\x0c" + base[i + 5:]
    out["hierarchical"] = base[:i + 1] + b"\xc5" + base[i + 2:]
    return out


def export_jpeg(out_dir: str) -> dict:
    """Write assets/jpeg/ (module docstring) and return its goldens."""
    root = os.path.join(out_dir, "jpeg")
    shutil.rmtree(root, ignore_errors=True)
    base = os.path.join(root, "food-101")
    os.makedirs(os.path.join(base, "meta"))
    os.makedirs(os.path.join(root, "streams"))
    rng = np.random.default_rng(0)
    rel = {"train": [], "test": []}
    enc = libjpeg_encoder()
    for n, (h, w) in enumerate(FOOD_SHAPES):
        cls = CLASSES[n % len(CLASSES)]
        os.makedirs(os.path.join(base, "images", cls), exist_ok=True)
        name = f"{cls}/{1000000 + n}"
        img = make_image(rng, h, w)
        path = os.path.join(base, "images", name + ".jpg")
        if n == FOOD_ARITH:
            with open(path, "wb") as f:
                f.write(enc(img, 92, arith=1))
        elif n == FOOD_CMYK:
            Image.fromarray(img).convert("CMYK").save(path, quality=92)
        else:
            Image.fromarray(img).save(path, quality=92)
        rel["train" if n < N_FOOD_TRAIN else "test"].append(name)
    for split, names in rel.items():
        with open(os.path.join(base, "meta", f"{split}.txt"), "w") as f:
            f.write("\n".join(names) + "\n")

    goldens = {"streams": {}, "crops": [], "encode": [], "loader": {}}
    crop_rng = np.random.default_rng(5)
    for fname, data in _streams().items():
        path = os.path.join(root, "streams", fname)
        with open(path, "wb") as f:
            f.write(data)
        name, ext = os.path.splitext(fname)
        entry = {"file": f"streams/{fname}"}
        try:
            served = _pil_rgb(data)
            entry["served_sha256"] = sha256(served)
        except OSError:
            served, entry["served_refused"] = None, True
        try:
            px = (jax_native.decode_jpeg_rgb8(data) if ext == ".jpg"
                  else served)
        except (ValueError, RuntimeError, OSError):
            entry["binding_refused"] = True
            goldens["streams"][name] = entry
            continue
        if px is None:  # a file PIL refuses (its 400 is the golden)
            goldens["streams"][name] = entry
            continue
        entry.update(shape=list(px.shape), sha256=sha256(px))
        if ext == ".webp" and b"VP8 " in data[12:] and b"ANMF" not in data:
            entry["yuv_sha256"] = sha256(np.concatenate(
                [p.ravel() for p in libwebp().decode_yuv(data)]))
        goldens["streams"][name] = entry
        if ext != ".jpg":
            continue
        h, w = px.shape[:2]
        for _ in range(3):
            ch, cw = int(crop_rng.integers(1, h + 1)), int(crop_rng.integers(1, w + 1))
            y0, x0 = int(crop_rng.integers(0, h - ch + 1)), int(crop_rng.integers(0, w - cw + 1))
            got = jax_native.decode_jpeg_crop_rgb8(data, x0, y0, cw, ch)
            if got is None:  # the loader's PIL fallback
                got = px[y0:y0 + ch, x0:x0 + cw]
            goldens["crops"].append({"stream": name, "x0": x0, "y0": y0,
                                     "cw": cw, "ch": ch, "sha256": sha256(got)})
    # built by chip_smoke.py itself rather than committed (PhotoCD's base
    # image alone is 768 KB)
    served = _pil_rgb(pcd_stream())
    goldens["generated"] = {"pcd": {"made_by": "chip_smoke.pcd_stream",
                                    "shape": list(served.shape),
                                    "served_sha256": sha256(served)}}
    for h, w, q, seed in ENCODE:
        data = jax_native.encode_jpeg_rgb8(jpeg_test_image(h, w, seed), q)
        goldens["encode"].append({"h": h, "w": w, "quality": q, "seed": seed,
                                  "bytes": len(data), "sha256": sha256(data)})
    src = Food101Source(root, "train")
    goldens["loader"] = {**LOADER, "split": "train"}
    for mode, train in (("train", True), ("eval", False)):
        loader = SRDataLoader(src, crop_size=LOADER["crop_size"],
                              batch_size=LOADER["batch_size"], train=train,
                              seed=LOADER["seed"])
        loader.set_epoch(0)
        batches = [np.asarray(b, np.uint8) for b in loader]
        goldens["loader"][mode] = [sha256(b) for b in
                                   batches[:LOADER["batches"]]]
    with open(os.path.join(root, "goldens.json"), "w") as f:
        json.dump(goldens, f, indent=1)
        f.write("\n")
    return goldens


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--out_dir", default=ASSETS)
    p.add_argument("--what", default="all",
                   choices=["all", "srcnn", "attentionsr", "resnet",
                            "attentionsr_tunes", "jpeg"])
    a = p.parse_args()
    jax.config.update("jax_platforms", "cpu")

    if a.what in ("all", "jpeg"):
        export_jpeg(a.out_dir)
        total = sum(os.path.getsize(os.path.join(d, f))
                    for d, _, fs in os.walk(os.path.join(a.out_dir, "jpeg"))
                    for f in fs)
        print(f"{os.path.join(a.out_dir, 'jpeg')}: {total:,} bytes")
    if a.what in ("all", "attentionsr"):
        for path in export_attentionsr(a.out_dir):
            print(f"{path}: {os.path.getsize(path):,} bytes")
    if a.what in ("all", "resnet"):
        for path in export_resnet(a.out_dir):
            print(f"{path}: {os.path.getsize(path):,} bytes")
    if a.what in ("all", "attentionsr_tunes"):
        for path in export_attentionsr_tunes(a.out_dir):
            print(f"{path}: {os.path.getsize(path):,} bytes")
    if a.what not in ("all", "srcnn"):
        return
    pth = os.path.join(a.out_dir, "winner_srcnn.pth")
    os.makedirs(a.out_dir, exist_ok=True)
    torch.save(winner_state_dict(CHECKPOINT, "SRCNN"), pth)
    inputs = golden_inputs()
    outputs = jax_served(inputs)
    npz = os.path.join(a.out_dir, "winner_srcnn_goldens.npz")
    np.savez_compressed(npz, **{f"lr_{i}": x for i, x in enumerate(inputs)},
                        **{f"sr_{i}": y for i, y in enumerate(outputs)})
    for path in (pth, npz):
        print(f"{path}: {os.path.getsize(path):,} bytes")


if __name__ == "__main__":
    main()
