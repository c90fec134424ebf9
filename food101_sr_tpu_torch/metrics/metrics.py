"""Image-quality metrics: PSNR, SSIM, NLPD (counterpart of
``food101_sr_tpu/metrics/metrics.py``).

Semantics follow the JAX package (and the reference's torchmetrics setup):
inputs are clamped to [0, 1]; PSNR has data range 1.0 and one global MSE
over the batch; SSIM uses an 11x11 sigma 1.5 Gaussian window on valid
positions, k1 = 0.01, k2 = 0.03, and a global mean; NLPD is the loss reused
as a metric, so it runs the blur kernel K1 on CUDA. Everything runs in full
float32 (``ops.precision.full_fp32``): TF32 convolutions make SSIM's
variance term cancel and SSIM exceed 1.

LPIPS is not here yet: it needs the AlexNet feature net, which comes with
the GAN slice of the port.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..losses.nlpd import nlpd_loss
from ..ops.precision import full_fp32


def psnr(pred: torch.Tensor, target: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    mse = torch.mean((pred - target) ** 2)
    return 10.0 * torch.log10(data_range**2 / mse)


@functools.lru_cache(maxsize=4)
def _gaussian_window(kernel_size: int, sigma: float) -> np.ndarray:
    coords = np.arange(kernel_size, dtype=np.float64) - (kernel_size - 1) / 2.0
    g = np.exp(-(coords**2) / (2.0 * sigma**2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    """Wang et al. SSIM of NCHW images with Gaussian windows on valid
    positions, global mean."""
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    x, y = pred.float(), target.float()
    c = x.shape[1]
    w = torch.from_numpy(_gaussian_window(kernel_size, sigma)).to(x.device)
    w = w.expand(c, 1, kernel_size, kernel_size)
    with full_fp32():
        mu_x, mu_y, mu_xx, mu_yy, mu_xy = (
            F.conv2d(t, w, groups=c) for t in (x, y, x * x, y * y, x * y))
    sigma_x = mu_xx - mu_x**2
    sigma_y = mu_yy - mu_y**2
    sigma_xy = mu_xy - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x**2 + mu_y**2 + c1) * (sigma_x + sigma_y + c2)
    return torch.mean(num / den)


class MetricsCalculator:
    """``compute(sr, hr) -> {"psnr", "ssim", "nlpd"}`` of Python floats, for
    NHWC float images (numpy arrays or tensors) in [0, 1]."""

    def __init__(self, device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        torch.empty(0, device=self.device)  # raises if the device is absent

    @torch.no_grad()
    def compute(self, sr, hr) -> dict[str, float]:
        sr, hr = (torch.as_tensor(t, dtype=torch.float32, device=self.device)
                  .clamp(0.0, 1.0).permute(0, 3, 1, 2).contiguous()
                  for t in (sr, hr))
        with full_fp32():
            out = {"psnr": psnr(sr, hr), "ssim": ssim(sr, hr),
                   "nlpd": nlpd_loss(sr, hr)}
        return {k: float(v) for k, v in out.items()}
