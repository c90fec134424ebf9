"""Model analysis table: name / params / fp32 size (counterpart of the
JAX package's root ``analyze_models.py``).

    python -m food101_sr_tpu_torch.analyze_models

The six rows of the JAX table: the registry nets, the 64-channel
AttentionSR variant the reference's own tool instantiates beside the
96-channel one the registry trains, and the Discriminator. Counting needs
no weights: the nets are built on the meta device, where no memory is
allocated and nothing is drawn. Parameters are counted as JAX's
``param_count`` counts its ``params`` collection (running statistics and
spectral-norm vectors are buffers, not parameters).
"""
from __future__ import annotations

import torch

from .models import AttentionSR, Discriminator, param_count
from .models.registry import _REGISTRY

SCALE = 4


def model_rows() -> list[tuple[str, "torch.nn.Module"]]:
    """(display name, net on the meta device) of each row of the table."""
    with torch.device("meta"):
        return [
            ("SRCNN", _REGISTRY["SRCNN"](SCALE)),
            ("ResNetSR", _REGISTRY["RESNET"](SCALE)),
            ("AttentionSR (96ch, trained)", _REGISTRY["AttentionSR"](SCALE)),
            ("AttentionSR (64ch variant)",
             AttentionSR(scale_factor=SCALE, num_channels=64,
                         num_residuals=32)),
            ("RRDB (ESRGAN, beyond-parity)", _REGISTRY["RRDB"](SCALE)),
            ("Discriminator", Discriminator()),
        ]


def analyze_models() -> list[tuple[str, int]]:
    """Print the table; returns (name, parameter count) per row."""
    rows = [(name, param_count(model)) for name, model in model_rows()]
    print(f"{'Model Name':<30} | {'Params':<12} | {'Size (MB)':<10}")
    print("-" * 58)
    for name, n in rows:
        print(f"{name:<30} | {n:<12,} | {n * 4 / 2**20:<10.2f}")
    return rows


if __name__ == "__main__":
    analyze_models()
