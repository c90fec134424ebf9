"""Separable image resampling as two matrix products (counterpart of
``food101_sr_tpu/ops/resize.py``).

The 1-D resampling operator is a dense ``[out, in]`` weight matrix built
once per shape in float64 numpy; H and W are then resized with two float32
matmuls. Weights match PyTorch/PIL exactly: half-pixel centres
(``align_corners=False``), a kernel stretched by the scale when
antialiasing a minification, edge taps dropped and renormalized (antialias)
or clamped (plain), and rows summing to 1. ``a=-0.5`` is PIL's and
torchvision's antialiased bicubic, ``a=-0.75`` torch's plain bicubic.
Images are NCHW (or CHW); computation is full float32 (a measurement op).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .precision import full_fp32


def _cubic_kernel(x: np.ndarray, a: float) -> np.ndarray:
    """Keys cubic convolution kernel with free parameter ``a`` (support 2)."""
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    inner = (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0
    outer = a * (ax3 - 5.0 * ax2 + 8.0 * ax - 4.0)
    return np.where(ax <= 1.0, inner, np.where(ax < 2.0, outer, 0.0))


def _linear_kernel(x: np.ndarray) -> np.ndarray:
    """Triangle kernel (support 1): bilinear."""
    return np.maximum(0.0, 1.0 - np.abs(x))


@functools.lru_cache(maxsize=256)
def resample_matrix(in_size: int, out_size: int, kernel: str = "cubic",
                    a: float = -0.75, antialias: bool = True) -> np.ndarray:
    """Dense ``[out_size, in_size]`` float32 1-D resampling matrix."""
    if kernel == "cubic":
        kfn, support = (lambda t: _cubic_kernel(t, a)), 2.0
    elif kernel == "linear":
        kfn, support = _linear_kernel, 1.0
    else:
        raise ValueError(f"Unknown kernel: {kernel}")

    scale = in_size / out_size
    fscale = max(scale, 1.0) if antialias else 1.0
    sup = support * fscale

    centers = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    lo = np.floor(centers - sup + 1.0)
    n_taps = int(np.ceil(sup) * 2 + 1)
    taps = lo[:, None] + np.arange(n_taps)[None, :]
    weights = kfn((taps - centers[:, None]) / fscale)
    if antialias:
        # drop out-of-range taps, renormalize the rest
        valid = (taps >= 0) & (taps <= in_size - 1)
        weights = np.where(valid, weights, 0.0)
        weights /= weights.sum(axis=1, keepdims=True)
    # plain: clamp tap indices to the edge, weights accumulate at 0 / n-1
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    idx = np.clip(taps, 0, in_size - 1).astype(np.int64)
    np.add.at(mat, (np.repeat(np.arange(out_size), n_taps), idx.reshape(-1)),
              weights.reshape(-1))
    return mat.astype(np.float32)


def resize2d(x: torch.Tensor, out_h: int, out_w: int, kernel: str = "cubic",
             a: float = -0.75, antialias: bool = True) -> torch.Tensor:
    """Resize NCHW (or CHW) ``x`` in float32; returns ``x.dtype``."""
    h, w = x.shape[-2], x.shape[-1]
    xf = x.float()
    with full_fp32():
        if h != out_h:
            mh = torch.from_numpy(
                resample_matrix(h, out_h, kernel, a, antialias)).to(x.device)
            xf = mh @ xf                   # [OH,H] @ [...,H,W]
        if w != out_w:
            mw = torch.from_numpy(
                resample_matrix(w, out_w, kernel, a, antialias)).to(x.device)
            xf = xf @ mw.T                 # [...,H,W] @ [W,OW]
    return xf.to(x.dtype)


def resize_bicubic_torch(x: torch.Tensor, out_h: int, out_w: int,
                         antialias: bool = True) -> torch.Tensor:
    """torch ``F.interpolate(mode='bicubic', align_corners=False)``: the
    antialiased path uses a=-0.5 (PIL-compatible), the plain one a=-0.75."""
    a = -0.5 if antialias else -0.75
    return resize2d(x, out_h, out_w, kernel="cubic", a=a, antialias=antialias)


def resize_bilinear_torch(x: torch.Tensor, out_h: int, out_w: int,
                          antialias: bool = False) -> torch.Tensor:
    """torch ``F.interpolate(mode='bilinear', align_corners=False)``; the
    NLPD pyramid's upsample."""
    return resize2d(x, out_h, out_w, kernel="linear", antialias=antialias)


def degrade_bicubic(hr: torch.Tensor, scale: int) -> torch.Tensor:
    """HR -> LR: antialiased bicubic by ``1/scale`` (the dataset's
    degradation)."""
    h, w = hr.shape[-2], hr.shape[-1]
    return resize_bicubic_torch(hr, h // scale, w // scale, antialias=True)
