"""Training CLI of the PyTorch/CUDA port: the flags and defaults of the
JAX package's ``train.py`` (the reference's public flags plus the
extensions in ``training.DEFAULTS``), running ``training.train`` on the
CUDA device.

    python -m food101_sr_tpu_torch.train --data_root DIR \\
        --architecture AttentionSR --epochs 2
    python -m food101_sr_tpu_torch.train --dataset synthetic \\
        --architecture AttentionSR --epochs 2 --synthetic_size 96

The default ``--dataset food101`` reads the Food-101 layout under
``--data_root`` (``DIR/food-101/images/<class>/<id>.jpg`` and
``meta/{train,test}.txt``) and decodes each training crop's region with
the port's own JPEG codec, which needs no library.

``--architecture`` is SRCNN (the default), RESNET, AttentionSR or RRDB, at
the registry's sizes.

``--loss_function gan`` trains the relativistic GAN (a spectral-norm
discriminator, the VGG19 perceptual loss, a D step every 5 batches:
``d_update_every`` in ``training.DEFAULTS``); ``perceptual`` is the
supervised step on the VGG19 loss. ``--quantize qat`` trains RESNET,
AttentionSR or RRDB with fake-quantized body convs (the float checkpoint
it writes serves with ``--quantize int8``). The upsample tail runs in
phase space unless ``--no_phase_tail`` (the same function and weights).
``--dtype bfloat16`` trains in bf16 on float32 master weights (Adam, the
EMA and the checkpoints stay float32). ``--cache_device`` draws the
batches from uint8 canvases in device memory; ``--cache_host DIR``
decodes the dataset once into a canvas store under DIR and streams it,
through a device window of canvases with ``--cache_host_reuse N``.

    python -m food101_sr_tpu_torch.train --dataset synthetic \
        --architecture RRDB --dtype bfloat16 --cache_device

Data-parallel training runs one process per card; ``--batch_size`` is
the global batch. With torchrun, or one command per card::

    torchrun --nproc_per_node 2 -m food101_sr_tpu_torch.train \
        --distributed auto --dataset synthetic --architecture AttentionSR
    python -m food101_sr_tpu_torch.train --coordinator localhost:8476 \
        --num_processes 2 --process_id 0 ...    # and --process_id 1
"""
from __future__ import annotations

import argparse
from typing import Sequence

from .training import DEFAULTS, train


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    # Reference-compatible flags (same names and defaults).
    p.add_argument("--architecture", type=str, default="SRCNN",
                   choices=["SRCNN", "RESNET", "AttentionSR", "RRDB"],
                   help="registry name")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=0.0004)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--loss_function", type=str, default="nlpd",
                   help="mae, mse, nlpd, perceptual (VGG19) or gan")
    p.add_argument("--subset", type=float, default=1.0)
    p.add_argument("--pretrained_weights", type=str, default="",
                   help="a state_dict file (e.g. {save_name}_best.pth) to "
                        "warm-start from where keys and shapes match")
    p.add_argument("--patience", type=int, default=5)
    p.add_argument("--save_name", type=str, default="model_best")
    # Extensions (training.DEFAULTS).
    p.add_argument("--dataset", type=str, default=DEFAULTS["dataset"],
                   choices=["food101", "synthetic"],
                   help="food101 (the layout under --data_root) or "
                        "synthetic")
    p.add_argument("--data_root", type=str, default=DEFAULTS["data_root"])
    p.add_argument("--crop_size", type=int, default=DEFAULTS["crop_size"])
    p.add_argument("--scale_factor", type=int, default=DEFAULTS["scale_factor"])
    p.add_argument("--dtype", type=str, default=DEFAULTS["dtype"],
                   choices=["float32", "bfloat16"],
                   help="compute dtype of the nets; the parameters, Adam "
                        "and the checkpoints stay float32")
    p.add_argument("--seed", type=int, default=DEFAULTS["seed"])
    p.add_argument("--weights_dir", type=str, default=DEFAULTS["weights_dir"])
    p.add_argument("--log_every", type=int, default=DEFAULTS["log_every"])
    p.add_argument("--run_name", type=str, default=None)
    p.add_argument("--resume", type=str, default=DEFAULTS["resume"],
                   help="path to a {save_name}_last.pth full-state "
                        "checkpoint (params + optimizer + scheduler + epoch)")
    p.add_argument("--profile_steps", type=int,
                   default=DEFAULTS["profile_steps"],
                   help="trace this many train steps (first epoch) with "
                        "torch.profiler into --profile_dir/trace.json")
    p.add_argument("--profile_dir", type=str, default=DEFAULTS["profile_dir"])
    p.add_argument("--preempt_after_updates", type=int,
                   default=DEFAULTS["preempt_after_updates"],
                   help="simulate a preemption: after N optimizer updates, "
                        "take the graceful path a SIGTERM takes (full-state "
                        "save at the update boundary, clean exit, mid-epoch "
                        "--resume). 0 = off; real SIGTERMs are always "
                        "handled")
    p.add_argument("--ema", type=float, default=DEFAULTS["ema"],
                   help="EMA decay of the params (e.g. 0.999); the EMA is "
                        "validated and saved as the best checkpoint. 0 = off")
    p.add_argument("--grad_accum", type=int, default=DEFAULTS["grad_accum"],
                   help="accumulate gradients over k microbatches of "
                        "batch_size/k per optimizer update: 1/k the "
                        "activation memory, the unsplit batch's math")
    p.add_argument("--quantize", type=str, default=DEFAULTS["quantize"],
                   choices=["", "qat"],
                   help="qat: quantization-aware training, the body convs on "
                        "fake-quantized (int8-grid, STE) weights and "
                        "activations, so the float checkpoint serves with "
                        "--quantize int8. RESNET, AttentionSR, RRDB")
    p.add_argument("--phase_tail", action="store_true",
                   default=DEFAULTS["phase_tail"],
                   help="(default on) run the upsample tail in pixel-shuffle "
                        "phase space at LR resolution: the same function, "
                        "weights and checkpoints")
    p.add_argument("--no_phase_tail", action="store_false", dest="phase_tail",
                   help="train with the materialized upsample tail")
    # The device and canvas caches (data/device_cache.py, canvas_cache.py).
    p.add_argument("--cache_device", action="store_true",
                   default=DEFAULTS["cache_device"],
                   help="keep the dataset in device memory as uint8 "
                        "canvases; crop and flip drawn there")
    p.add_argument("--cache_canvas", type=int,
                   default=DEFAULTS["cache_canvas"],
                   help="train canvas side (0: max(256, crop_size))")
    p.add_argument("--cache_budget_gb", type=float,
                   default=DEFAULTS["cache_budget_gb"],
                   help="refuse a device cache above this")
    p.add_argument("--cache_host", type=str, default=DEFAULTS["cache_host"],
                   metavar="DIR",
                   help="decode once into a canvas store under DIR (reused "
                        "across runs) and stream it to the device")
    p.add_argument("--cache_host_budget_gb", type=float,
                   default=DEFAULTS["cache_host_budget_gb"],
                   help="refuse a disk store above this")
    p.add_argument("--cache_host_reuse", type=int,
                   default=DEFAULTS["cache_host_reuse"], metavar="K",
                   help="K>1: train from a device window of canvases, K "
                        "draws per upload in expectation")
    p.add_argument("--cache_window", type=int,
                   default=DEFAULTS["cache_window"], metavar="N",
                   help="window size in canvases (0: auto)")
    p.add_argument("--use_wandb", type=lambda s: s.lower() in ("1", "true"),
                   default=DEFAULTS["use_wandb"], nargs="?", const=True,
                   help="force W&B on/off (default: auto, on iff wandb is "
                        "importable; JSONL fallback otherwise)")
    # Multi-process launch (parallel/distributed.py): one process per card.
    p.add_argument("--coordinator", type=str, default=DEFAULTS["coordinator"],
                   help="host:port of process 0 for torch.distributed "
                        "(with --num_processes/--process_id; or set "
                        "MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)")
    p.add_argument("--num_processes", type=int,
                   default=DEFAULTS["num_processes"])
    p.add_argument("--process_id", type=int, default=DEFAULTS["process_id"])
    p.add_argument("--distributed", type=str, default=DEFAULTS["distributed"],
                   choices=["", "auto"],
                   help="'auto': init_method env:// from torchrun's "
                        "environment, so a torchrun launch needs no "
                        "per-process flags")
    return p


def main(argv: Sequence[str] | None = None) -> dict:
    return train(config=vars(build_parser().parse_args(argv)))


if __name__ == "__main__":
    main()
