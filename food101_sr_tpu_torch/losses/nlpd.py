"""NLPD loss (counterpart of ``food101_sr_tpu/losses/nlpd.py``).

4-level Laplacian pyramid: depthwise 5x5 Gaussian blur (sigma 1, zero
padding; kernel K1 on CUDA), stride-2 subsample, bilinear upsample back
(``align_corners=False``), difference. Loss = alpha * MAE +
(1 - alpha) * sum_i mean|dL_i|, alpha = 0.7. Images are NCHW.
"""
from __future__ import annotations

import torch

from ..ops.pallas_blur import depthwise_blur_fast
from ..ops.resize import resize_bilinear_torch


def laplacian_pyramid(img: torch.Tensor, n_levels: int = 4) -> list:
    """Per-level difference images (NCHW)."""
    pyramid = []
    current = img
    for _ in range(n_levels):
        down = depthwise_blur_fast(current, size=5, sigma=1.0)[:, :, ::2, ::2]
        up = resize_bilinear_torch(down, current.shape[2], current.shape[3])
        pyramid.append(current - up)
        current = down
    return pyramid


def nlpd_loss(pred: torch.Tensor, target: torch.Tensor, n_levels: int = 4,
              alpha: float = 0.7) -> torch.Tensor:
    """One pyramid over ``cat([pred, target])``, split at each level: every
    plane is blurred as in two separate pyramids, with half the launches
    (4 of K1 for 4 levels, and of each other pyramid op)."""
    loss_mae = torch.mean(torch.abs(pred - target))
    n = pred.shape[0]
    pyr = laplacian_pyramid(torch.cat([pred, target]), n_levels)
    loss_nlpd = sum(torch.mean(torch.abs(lv[:n] - lv[n:])) for lv in pyr)
    return alpha * loss_mae + (1.0 - alpha) * loss_nlpd
