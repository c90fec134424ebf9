"""Model registry (counterpart of ``food101_sr_tpu/models/registry.py``):
name -> module at the reference's sizes. This slice ports AttentionSR
(32 blocks x 96 channels); the other generators come in later slices.
"""
from __future__ import annotations

import torch
from torch import nn

from .attention_sr import AttentionSR
from .layers import init_weights

_REGISTRY = {
    "AttentionSR": lambda scale: AttentionSR(
        scale_factor=scale, num_residuals=32, num_channels=96),
}


def build_model(module_fn, dtype: torch.dtype = torch.float32,
                device: str | torch.device = "cuda",
                generator: torch.Generator | None = None) -> nn.Module:
    """Construct ``module_fn()`` without touching the global RNG, draw its
    weights from ``generator`` (seed 0 when None), and move it to
    ``device``/``dtype`` in eval mode, 4-D weights in channels-last memory
    (the format the nets run in)."""
    with torch.device("meta"):
        model = module_fn()
    model = model.to_empty(device="cpu")
    init_weights(model, generator if generator is not None
                 else torch.Generator().manual_seed(0))
    return model.to(device=device, dtype=dtype,
                    memory_format=torch.channels_last).eval()


def get_model(name: str, scale_factor: int = 4,
              dtype: torch.dtype = torch.float32,
              device: str | torch.device = "cuda",
              generator: torch.Generator | None = None) -> nn.Module:
    """Registry model ``name`` with seeded random weights, on ``device``."""
    if name not in _REGISTRY:
        raise ValueError(f"Unknown or not yet ported architecture: {name}")
    return build_model(lambda: _REGISTRY[name](scale_factor), dtype, device,
                       generator)

