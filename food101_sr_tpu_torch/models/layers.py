"""Building blocks of the SR generators (counterpart of
``food101_sr_tpu/models/layers.py``), (N, C, H, W) in either memory
format.

Module names follow the reference PyTorch layout, so that a state_dict
exported from a JAX checkpoint (``convert.params_from_jax``) loads with
``strict=True``. Initialization matches the JAX package's distributions
and is drawn from an explicit ``torch.Generator`` (:func:`init_weights`).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.spatial_mean import spatial_mean


def scale_stages(scale: int) -> tuple:
    """Upsample-stage factorization of ``scale``: prime factors, ascending
    (x4 -> (2, 2), the reference's two x2 stages)."""
    if int(scale) != scale or scale < 2:
        raise ValueError(f"scale_factor must be an integer >= 2, got {scale}")
    out, s, p = [], int(scale), 2
    while p * p <= s:
        while s % p == 0:
            out.append(p)
            s //= p
        p += 1
    if s > 1:
        out.append(s)
    return tuple(out)


class Conv(nn.Conv2d):
    """2-D conv with symmetric ``(k-1)//2`` padding. Initialized
    kaiming-normal (fan_in, gain sqrt 2) with zero bias, or ICNR for
    ``icnr_scale > 1`` (a conv that feeds a pixel shuffle)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, bias: bool = True, icnr_scale: int = 0):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding=(kernel_size - 1) // 2, bias=bias)
        self.icnr_scale = icnr_scale


def prelu() -> nn.PReLU:
    """PReLU with one shared slope, initial 0.25."""
    return nn.PReLU(num_parameters=1, init=0.25)


class SEBlock(nn.Module):
    """Squeeze-and-excitation, reduction 16: spatial mean (kernel K2 on
    CUDA) -> Linear(c/r) -> ReLU -> Linear(c) -> sigmoid -> rescale."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        hidden = channels // reduction
        self.fc = nn.Sequential(nn.Linear(channels, hidden, bias=False),
                                nn.ReLU(),
                                nn.Linear(hidden, channels, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.sigmoid(self.fc(spatial_mean(x)))
        return x * y[:, :, None, None]


class AttentionResidualBlock(nn.Module):
    """conv3x3 -> PReLU -> conv3x3 -> SE, no BN, residual scaled by 0.1."""

    def __init__(self, channels: int, res_scale: float = 0.1):
        super().__init__()
        self.conv1 = Conv(channels, channels, 3)
        self.prelu = prelu()
        self.conv2 = Conv(channels, channels, 3)
        self.se = SEBlock(channels)
        self.res_scale = res_scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = self.se(self.conv2(self.prelu(self.conv1(x))))
        return x + r * self.res_scale


def upsample_block(in_channels: int, out_channels: int = 64,
                   scale: int = 2) -> list[nn.Module]:
    """One x``scale`` tail stage: conv3x3 (ICNR) -> PixelShuffle -> PReLU,
    as a flat list so the stages of a tail share one ``nn.Sequential``
    (state_dict keys ``upsample.{3s}`` / ``upsample.{3s+2}``)."""
    return [Conv(in_channels, out_channels * scale * scale, 3,
                 icnr_scale=scale),
            nn.PixelShuffle(scale), prelu()]


def _normal(shape, std: float, gen: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=gen) * std


def _trunc_normal(shape, std: float, gen: torch.Generator) -> torch.Tensor:
    """Normal truncated at +-2 standard deviations, rescaled so its std is
    ``std`` (flax's ``variance_scaling(..., "truncated_normal")``)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = lo + (1.0 - 2.0 * lo) * torch.rand(shape, generator=gen)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return z * (std / 0.87962566103423978)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded init with the JAX package's distributions: kaiming-normal
    convs (ICNR for pixel-shuffle feeders), zero biases, lecun-normal
    linears, PReLU slope 0.25. Draws on the CPU in module order."""
    for m in model.modules():
        if isinstance(m, Conv):
            cout = m.weight.shape[0]
            fan_in = m.weight[0].numel()
            r2 = m.icnr_scale ** 2
            std = math.sqrt(2.0 / fan_in)
            if r2 > 1 and cout % r2 == 0:
                sub = _normal((cout // r2, *m.weight.shape[1:]), std, generator)
                w = sub.repeat_interleave(r2, dim=0)
            else:
                w = _normal(m.weight.shape, std, generator)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            m.weight.copy_(_trunc_normal(m.weight.shape,
                                         math.sqrt(1.0 / m.weight.shape[1]),
                                         generator))
        elif isinstance(m, nn.PReLU):
            m.weight.fill_(0.25)
