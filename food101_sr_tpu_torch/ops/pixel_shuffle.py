"""PixelShuffle (depth-to-space) and its inverse on (N, C, H, W) tensors
(counterpart of ``food101_sr_tpu/ops/pixel_shuffle.py``).

Channel semantics are ``nn.PixelShuffle``'s, which are also the JAX
package's: ``out[b, c, h*r+i, w*r+j] = x[b, c*r*r + i*r + j, h, w]``.
Both functions work through the NHWC view of their input, so a
channels-last tensor (the nets' format) is read without a transpose and
the result is channels-last whatever the input's format.
"""
from __future__ import annotations

import torch


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(N, C*r*r, H, W) -> (N, C, H*r, W*r), channel ``c*r*r + i*r + j``
    to pixel ``(h*r + i, w*r + j)``."""
    n, crr, h, w = x.shape
    if crr % (r * r):
        raise ValueError(f"channels {crr} not divisible by r^2={r * r}")
    c = crr // (r * r)
    y = x.permute(0, 2, 3, 1).reshape(n, h, w, c, r, r)
    y = y.permute(0, 1, 4, 2, 5, 3).reshape(n, h * r, w * r, c)
    return y.permute(0, 3, 1, 2)


def pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """Exact inverse of :func:`pixel_shuffle`: (N, C, H, W) -> (N, C*r*r,
    H/r, W/r) in the same ``c*r*r + i*r + j`` channel layout; moves an
    image into phase space (``ops.subpixel_conv``)."""
    n, c, h, w = x.shape
    if h % r or w % r:
        raise ValueError(f"spatial dims {h}x{w} not divisible by r={r}")
    y = x.permute(0, 2, 3, 1).reshape(n, h // r, r, w // r, r, c)
    y = y.permute(0, 1, 3, 5, 2, 4).reshape(n, h // r, w // r, c * r * r)
    return y.permute(0, 3, 1, 2)
