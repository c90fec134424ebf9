"""Anisotropic total-variation loss (counterpart of
``food101_sr_tpu/losses/tv.py``), with the reference formula's quirk of
applying ``tv_loss_weight`` per term and again globally (weight squared)."""
from __future__ import annotations

import torch


def tv_loss(x: torch.Tensor, tv_loss_weight: float = 1.0) -> torch.Tensor:
    """``x``: NCHW. Returns a scalar."""
    w = tv_loss_weight
    count_h = w * torch.sum((x[:, :, 1:, :] - x[:, :, :-1, :]) ** 2)
    count_w = w * torch.sum((x[:, :, :, 1:] - x[:, :, :, :-1]) ** 2)
    return w * 2.0 * (count_h + count_w) / x.shape[0]
