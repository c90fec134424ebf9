"""Gaussian blur primitives for the NLPD Laplacian pyramid
(counterpart of ``food101_sr_tpu/ops/gaussian.py``).

:func:`depthwise_blur` is the plain PyTorch version of kernel K1
(``ops/pallas_blur.py``): a 5x5 sigma=1 Gaussian as a depthwise,
zero-padded ``F.conv2d`` in float32.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .precision import full_fp32


@functools.lru_cache(maxsize=8)
def gaussian_kernel_2d(size: int = 5, sigma: float = 1.0) -> np.ndarray:
    """Normalized 2-D Gaussian, float32 ``[size, size]``."""
    coords = np.arange(size, dtype=np.float64)
    mean = (size - 1) / 2.0
    g = np.exp(-((coords - mean) ** 2) / (2.0 * sigma**2))
    k2d = np.outer(g, g)
    k2d /= k2d.sum()
    return k2d.astype(np.float32)


def depthwise_blur(x: torch.Tensor, size: int = 5,
                   sigma: float = 1.0) -> torch.Tensor:
    """Depthwise Gaussian blur of NCHW ``x`` with zero padding (size-1)//2,
    ``F.conv2d(padding=2, groups=C)``, computed in float32 and returned in
    ``x.dtype``."""
    c = x.shape[1]
    k = torch.from_numpy(gaussian_kernel_2d(size, sigma)).to(x.device)
    weight = k.expand(c, 1, size, size)
    with full_fp32():
        y = F.conv2d(x.float(), weight, padding=(size - 1) // 2, groups=c)
    return y.to(x.dtype)
