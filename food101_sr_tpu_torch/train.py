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
supervised step on the VGG19 loss. A flag whose setting the port does not
run yet is accepted by the parser and refused by ``train`` with a
NotImplementedError that names the ROADMAP item bringing it: ``--quantize``,
``--dtype bfloat16``, ``--cache_*`` and the multi-process flags.
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
                   help="float32 (bfloat16: ROADMAP item 9c)")
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
                   choices=["", "qat"], help="qat: ROADMAP item 8")
    p.add_argument("--phase_tail", action="store_true",
                   default=DEFAULTS["phase_tail"],
                   help="accepted for the JAX CLI's sake: the port runs the "
                        "materialized upsample tail either way, the same "
                        "function, until ops/subpixel_conv.py is ported "
                        "(ROADMAP item 4)")
    p.add_argument("--no_phase_tail", action="store_false", dest="phase_tail",
                   help="the materialized tail (what the port runs)")
    # The device and canvas caches: ROADMAP item 9b.
    p.add_argument("--cache_device", action="store_true",
                   default=DEFAULTS["cache_device"],
                   help="ROADMAP item 9b (the device and canvas caches)")
    p.add_argument("--cache_canvas", type=int,
                   default=DEFAULTS["cache_canvas"])
    p.add_argument("--cache_budget_gb", type=float,
                   default=DEFAULTS["cache_budget_gb"])
    p.add_argument("--cache_host", type=str, default=DEFAULTS["cache_host"],
                   metavar="DIR")
    p.add_argument("--cache_host_budget_gb", type=float,
                   default=DEFAULTS["cache_host_budget_gb"])
    p.add_argument("--cache_host_reuse", type=int,
                   default=DEFAULTS["cache_host_reuse"], metavar="K")
    p.add_argument("--cache_window", type=int,
                   default=DEFAULTS["cache_window"], metavar="N")
    p.add_argument("--use_wandb", type=lambda s: s.lower() in ("1", "true"),
                   default=DEFAULTS["use_wandb"], nargs="?", const=True,
                   help="force W&B on/off (default: auto, on iff wandb is "
                        "importable; JSONL fallback otherwise)")
    # Multi-process launch: ROADMAP item 10.
    p.add_argument("--coordinator", type=str, default=DEFAULTS["coordinator"],
                   help="ROADMAP item 10 (multi-GPU)")
    p.add_argument("--num_processes", type=int,
                   default=DEFAULTS["num_processes"])
    p.add_argument("--process_id", type=int, default=DEFAULTS["process_id"])
    p.add_argument("--distributed", type=str, default=DEFAULTS["distributed"],
                   choices=["", "auto"])
    return p


def main(argv: Sequence[str] | None = None) -> dict:
    return train(config=vars(build_parser().parse_args(argv)))


if __name__ == "__main__":
    main()
