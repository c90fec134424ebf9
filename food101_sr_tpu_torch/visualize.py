"""Offline model comparison, visualization and latency report
(counterpart of the JAX package's root ``visualize.py``).

    python -m food101_sr_tpu_torch.visualize --dataset synthetic \\
        --num_examples 8 --out_dir report/images
    python -m food101_sr_tpu_torch.visualize --data_root DIR \\
        --weights AttentionSR=w/attentionsr_best.pth --metrics

Samples test images and writes the JAX tool's report layout,
``{out_dir}/image_{idx}/{ground_truth,input_lr_resized,bicubic,<model>}
.png``, prints each image's 255-range PSNR per model, and a latency
table (avg/std/min/max ms per model). As there:

* each model is built and its checkpoint loaded once; a checkpoint that
  cannot be read is skipped with a warning (no seeded weights stand in);
* with ``--bucket`` (the default) each LR input is edge-padded to a
  multiple of 32 and the output cropped back, so a handful of shapes
  serve the run (cuDNN picks its algorithms per shape, once);
* each model's first call at a shape is a warm-up, left out of the
  times; a timed call is fenced by ``torch.cuda.synchronize`` on the
  card.

The LR input is PIL's bicubic (``data.pil_bicubic``, byte-exact), the
nearest-neighbour view repeats each LR pixel, and the PNGs go through the
port's own encoder (``native``). Models run in float32, as JAX's do.
"""
from __future__ import annotations

import argparse
import math
import os
import pickle
import time
from collections import defaultdict

import numpy as np
import torch

from . import native
from .data import Food101Source, SyntheticSource, resize_bicubic_u8
from .models import get_model
from .ops import self_ensemble
from .serving import load_generator_weights

SCALE_FACTOR = 4
NUM_EXAMPLES = 1000
OUTPUT_DIR = "report/images"
BUCKET = 32
ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")

# The JAX tool's table, in the port's checkpoint format: the committed
# SRCNN, ResNetSR and AttentionSR winners, and port files for the other
# winners (a row whose file is absent is skipped; override any row with
# --weights NAME=PATH).
WEIGHTS = {
    "SRCNN": os.path.join(ASSETS, "winner_srcnn.pth"),
    "RESNET": os.path.join(ASSETS, "winner_resnet.pth"),
    "AttentionSR": os.path.join(ASSETS, "winner_attentionsr.pth"),
    "AttentionSR_GAN": os.path.join(ASSETS, "winner_attentionsr_gan.pth"),
    "RRDB": os.path.join(ASSETS, "winner_rrdb.pth"),
    "RRDB_GAN": os.path.join(ASSETS, "winner_rrdb_gan.pth"),
}

# what reading a checkpoint file may raise: missing or a directory (an
# Orbax checkpoint), not a torch file, or weights of another shape
_LOAD_ERRORS = (OSError, ValueError, RuntimeError, KeyError,
                pickle.UnpicklingError)


def calculate_psnr(img1, img2) -> float:
    """255-range PSNR on uint8 images (100 when they are equal)."""
    a = np.asarray(img1).astype(np.float32)
    b = np.asarray(img2).astype(np.float32)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return 100.0
    return 20 * math.log10(255.0 / math.sqrt(mse))


def nearest_upscale(img: np.ndarray, s: int) -> np.ndarray:
    """Each pixel repeated ``s`` x ``s`` times: PIL's NEAREST resize by an
    integer factor."""
    return np.repeat(np.repeat(img, s, axis=0), s, axis=1)


class ModelRunner:
    """A model with its checkpoint loaded once; ``model`` is None when
    the checkpoint could not be read."""

    def __init__(self, display_name: str, ckpt_path: str,
                 quantize: str = "", device="cuda"):
        # display names may carry a suffix (AttentionSR_GAN, RRDB_GAN: the
        # same net, GAN-fine-tuned weights)
        arch = display_name
        for base in ("AttentionSR", "RRDB"):
            if display_name.startswith(base):
                arch = base
        self.name = display_name
        self.device = torch.device(device)
        # quantize applies to the nets with a body stack; SRCNN stays float
        q = quantize if arch in ("RESNET", "AttentionSR", "RRDB") else ""
        torch.empty(0, device=self.device)  # raises without the device
        model = get_model(arch, scale_factor=SCALE_FACTOR, quantize=q,
                          device=self.device)
        try:
            model.load_state_dict(load_generator_weights(ckpt_path),
                                  strict=True)
        except _LOAD_ERRORS as e:
            print(f"Warning: could not load weights for {display_name} at "
                  f"{ckpt_path}: {e}")
            self.model = None
            return
        self.model = model
        self._warm_shapes = set()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def _forward(self, x: torch.Tensor, tta: bool) -> torch.Tensor:
        y = self_ensemble(self.model, x) if tta else self.model(x)
        return (y.float().clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)

    def predict(self, lr_np: np.ndarray, bucket: bool, tta: bool = False):
        """lr_np: [H, W, 3] float32 in [0, 1]. Returns (sr uint8 HWC,
        seconds of the timed forward)."""
        h, w = lr_np.shape[:2]
        if bucket:
            x = np.pad(lr_np, ((0, (-h) % BUCKET), (0, (-w) % BUCKET), (0, 0)),
                       mode="edge")
        else:
            x = lr_np
        xb = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        xb = xb.permute(2, 0, 1)[None]  # (1, 3, H, W), channels-last memory
        if (tuple(xb.shape), tta) not in self._warm_shapes:
            self._forward(xb, tta)
            self._sync()
            self._warm_shapes.add((tuple(xb.shape), tta))
        self._sync()
        t0 = time.perf_counter()
        y8 = self._forward(xb, tta)
        self._sync()
        dt = time.perf_counter() - t0
        sr = y8[0].permute(1, 2, 0).cpu().numpy()
        return np.ascontiguousarray(sr[: h * SCALE_FACTOR,
                                       : w * SCALE_FACTOR]), dt


def parse_weight_specs(specs):
    """``["NAME=CKPT", ...]`` -> checkpoint mapping, or None to use the
    default WEIGHTS table. Raises ValueError on a spec without '='."""
    if not specs:
        return None
    out = {}
    for spec in specs:
        name, sep, path = spec.partition("=")
        if not sep or not name or not path:
            raise ValueError(f"--weights expects NAME=CKPT, got {spec!r}")
        out[name] = path
    return out


def _save_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(native.encode_png_rgb8(np.ascontiguousarray(img)))


def run_comparison(dataset="food101", data_root="./data",
                   num_examples=NUM_EXAMPLES, out_dir=OUTPUT_DIR,
                   bucket=True, seed=0, weights=None, tta=False,
                   full_metrics=False, quantize="", device="cuda"):
    """The report (module docstring). Returns ``{model: [seconds per
    image]}``, and with ``full_metrics`` also ``{model: {psnr, ssim,
    lpips, nlpd}}`` means."""
    device = torch.device(device)
    torch.empty(0, device=device)  # raises without the device; no fallback
    if dataset == "synthetic":
        source = SyntheticSource(n=max(num_examples, 16), seed=seed)
    else:
        source = Food101Source(data_root, "test")
    print(f"Processing images on {device.type} ...")

    rng = np.random.default_rng(seed)
    indices = rng.choice(len(source), size=min(num_examples, len(source)),
                         replace=False)
    os.makedirs(out_dir, exist_ok=True)

    runners = [ModelRunner(name, path, quantize=quantize, device=device)
               for name, path in (weights or WEIGHTS).items()]
    runners = [r for r in runners if r.model is not None]

    metrics_calc = None
    if full_metrics:  # the reference report prints PSNR only
        from .metrics import MetricsCalculator

        metrics_calc = MetricsCalculator(device=device)
    all_metrics = defaultdict(lambda: defaultdict(list))
    inference_times = defaultdict(list)
    s = SCALE_FACTOR
    for i, idx in enumerate(indices):
        print(f"\n--- Processing Image {i + 1}/{len(indices)} (Index: {idx}) ---")
        save_path = os.path.join(out_dir, f"image_{idx}")
        os.makedirs(save_path, exist_ok=True)

        hr = source[int(idx)]
        h, w = (hr.shape[0] // s) * s, (hr.shape[1] // s) * s
        hr = np.ascontiguousarray(hr[:h, :w])
        lr = resize_bicubic_u8(hr, (w // s, h // s))
        _save_png(os.path.join(save_path, "ground_truth.png"), hr)
        _save_png(os.path.join(save_path, "input_lr_resized.png"),
                  nearest_upscale(lr, s))
        bicubic = resize_bicubic_u8(lr, (w, h))
        _save_png(os.path.join(save_path, "bicubic.png"), bicubic)
        print(f"Saved Baseline | Bicubic PSNR: "
              f"{calculate_psnr(bicubic, hr):.2f} dB")

        lr_np = lr.astype(np.float32) / 255.0
        for runner in runners:
            sr, dt = runner.predict(lr_np, bucket, tta=tta)
            inference_times[runner.name].append(dt)
            _save_png(os.path.join(save_path, f"{runner.name.lower()}.png"), sr)
            line = (f"Saved {runner.name} | PSNR: "
                    f"{calculate_psnr(sr, hr):.2f} dB | "
                    f"Inference: {dt * 1000:.2f} ms")
            if metrics_calc is not None:
                # one fixed centre crop (256 px, or the largest multiple of
                # 32 that fits), as the JAX report measures
                hh = ww = min(256, (sr.shape[0] // 32) * 32,
                              (sr.shape[1] // 32) * 32)
                if hh == 0:
                    hh, ww = sr.shape[0], sr.shape[1]
                oy, ox = (sr.shape[0] - hh) // 2, (sr.shape[1] - ww) // 2
                m = metrics_calc.compute(
                    sr[None, oy:oy + hh, ox:ox + ww].astype(np.float32) / 255.0,
                    hr[None, oy:oy + hh, ox:ox + ww].astype(np.float32) / 255.0)
                for k, v in m.items():
                    all_metrics[runner.name][k].append(v)
                line += (f" | SSIM {m['ssim']:.4f} | LPIPS {m['lpips']:.4f}"
                         f" | NLPD {m['nlpd']:.4f}")
            print(line)

    print(f"\n{'=' * 50}\nINFERENCE TIME SUMMARY\n{'=' * 50}")
    for name, times in inference_times.items():
        ms = np.asarray(times) * 1000
        print(f"{name:15} | Avg: {ms.mean():7.2f} ms | Std: {ms.std():6.2f} ms "
              f"| Min: {ms.min():7.2f} ms | Max: {ms.max():7.2f} ms")
    if all_metrics:
        print(f"\n{'=' * 50}\nQUALITY METRICS (mean over "
              f"{len(indices)} images)\n{'=' * 50}")
        for name, md in all_metrics.items():
            print(f"{name:15} | " + " | ".join(
                f"{k} {np.mean(v):.4f}" for k, v in md.items()))
    print(f"\nDone! Check the '{out_dir}' folder.")
    if full_metrics:  # arity follows the flag, not whether anything ran
        return inference_times, {n: {k: float(np.mean(v))
                                     for k, v in md.items()}
                                 for n, md in all_metrics.items()}
    return inference_times


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", default="food101", choices=["food101", "synthetic"])
    p.add_argument("--data_root", default="./data")
    p.add_argument("--num_examples", type=int, default=NUM_EXAMPLES)
    p.add_argument("--out_dir", default=OUTPUT_DIR)
    p.add_argument("--no_bucket", action="store_true",
                   help="disable shape bucketing (one shape per image size)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--self_ensemble", action="store_true",
                   help="x8 geometric TTA (dihedral transforms averaged)")
    p.add_argument("--metrics", action="store_true",
                   help="also compute SSIM/LPIPS/NLPD per image + summary")
    p.add_argument("--weights", action="append", default=None,
                   metavar="NAME=CKPT",
                   help="override the checkpoint mapping (repeatable); the "
                        "architecture is inferred from NAME as in the "
                        "default table")
    p.add_argument("--quantize", default="", choices=["", "int8", "int8_dot"],
                   help="dynamic-int8 body convs for the RESNET/AttentionSR/"
                        "RRDB rows (SRCNN rows stay float32)")
    p.add_argument("--cpu", action="store_true",
                   help="run the models on the CPU; the card otherwise")
    a = p.parse_args(argv)
    return run_comparison(a.dataset, a.data_root, a.num_examples, a.out_dir,
                          bucket=not a.no_bucket, seed=a.seed,
                          weights=parse_weight_specs(a.weights),
                          tta=a.self_ensemble, full_metrics=a.metrics,
                          quantize=a.quantize,
                          device="cpu" if a.cpu else "cuda")


if __name__ == "__main__":
    main()
