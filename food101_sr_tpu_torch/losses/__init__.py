"""Loss registry (counterpart of ``food101_sr_tpu/losses/__init__.py``):
mae, mse, nlpd. ``perceptual`` needs VGG19, which comes with the GAN slice
of the port (ROADMAP item 6). Losses take NCHW tensors."""
from __future__ import annotations

import torch

from .nlpd import laplacian_pyramid, nlpd_loss
from .tv import tv_loss


def mae_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def get_loss_function(name: str):
    """``loss(pred, target) -> scalar`` by name (case-insensitive)."""
    name = name.lower()
    if name == "mae":
        return mae_loss
    if name == "mse":
        return mse_loss
    if name == "nlpd":
        return nlpd_loss
    if name == "perceptual":
        raise NotImplementedError("the perceptual loss needs VGG19, which is "
                                  "not ported yet (ROADMAP item 6)")
    raise ValueError(f"Unknown loss function: {name}")


__all__ = ["get_loss_function", "laplacian_pyramid", "mae_loss", "mse_loss",
           "nlpd_loss", "tv_loss"]
