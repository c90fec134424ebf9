"""Geometric self-ensemble, x8 test-time augmentation (counterpart of
``food101_sr_tpu/ops/tta.py``).

Run the model on the eight dihedral transforms of the input (4 rotations
x horizontal flip), undo each transform on its output, and average (Lim
et al. 2017, EDSR), at 8x the inference work. The eight transforms fall
into two shape classes, HxW and WxH, so the ensemble is two batched
forwards of 4N images each, as in the JAX package; inside the server
every device batch has ``max_batch`` rows, so both forwards always run
``4 * max_batch`` rows.
"""
from __future__ import annotations

from typing import Callable

import torch

# the four axis-flip subsets of an (N, C, H, W) batch; each is its own
# inverse (the JAX package's NHWC (), (2,), (1,), (1, 2))
_FLIPS = ((), (3,), (2,), (2, 3))


def _flip(x: torch.Tensor, dims: tuple) -> torch.Tensor:
    return torch.flip(x, dims) if dims else x


def self_ensemble(forward: Callable[[torch.Tensor], torch.Tensor],
                  x: torch.Tensor) -> torch.Tensor:
    """Average ``forward`` over the dihedral group D4.

    Args:
      forward: (N, C, h, w) -> (N, C, h*s, w*s), the SR net.
      x: (N, C, H, W) LR batch.

    Returns:
      (N, C, H*s, W*s): the mean of the eight un-transformed outputs,
      accumulated in float32 at least and returned in the outputs' dtype
      (as ``jnp.mean`` does for bf16).
    """
    n = x.shape[0]
    xt = x.transpose(2, 3)
    ye = forward(torch.cat([_flip(x, f) for f in _FLIPS]))    # H x W
    yo = forward(torch.cat([_flip(xt, f) for f in _FLIPS]))   # W x H
    acc = torch.zeros(ye[:n].shape, device=ye.device,
                      dtype=torch.promote_types(ye.dtype, torch.float32))
    for i, f in enumerate(_FLIPS):
        acc += _flip(ye[i * n:(i + 1) * n], f)
    for i, f in enumerate(_FLIPS):
        acc += _flip(yo[i * n:(i + 1) * n], f).transpose(2, 3)
    return (acc / 8).to(ye.dtype)
