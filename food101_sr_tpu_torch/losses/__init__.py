"""Loss registry (counterpart of ``food101_sr_tpu/losses/__init__.py``):
mae, mse, perceptual, nlpd. ``gan`` is not an entry: the training loop
assembles it (``training/steps.py``, ``make_gan_*_step``). Losses take
NCHW tensors."""
from __future__ import annotations

import torch

from .nlpd import laplacian_pyramid, nlpd_loss, nlpd_loss_train
from .perceptual import PerceptualLoss
from .tv import tv_loss


def mae_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def get_loss_function(name: str, weights_dir: str | None = None,
                      device: str | torch.device = "cuda"):
    """``loss(pred, target) -> scalar`` by name (case-insensitive).
    ``weights_dir`` and ``device`` are the perceptual loss's VGG19 (its
    weights file and where the net lives); the other losses ignore them."""
    name = name.lower()
    if name == "mae":
        return mae_loss
    if name == "mse":
        return mse_loss
    if name == "perceptual":
        return PerceptualLoss(weights_dir=weights_dir, device=device)
    if name == "nlpd":
        return nlpd_loss
    raise ValueError(f"Unknown loss function: {name}")


__all__ = ["PerceptualLoss", "get_loss_function", "laplacian_pyramid",
           "mae_loss", "mse_loss", "nlpd_loss", "nlpd_loss_train", "tv_loss"]
