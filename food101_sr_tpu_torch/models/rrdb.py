"""RRDBNet, the ESRGAN residual-in-residual dense block generator
(counterpart of ``food101_sr_tpu/models/rrdb.py``, the ``concat`` layout).

conv3 head (no activation) -> N RRDBs (three 5-conv dense blocks each,
LeakyReLU 0.2, residual scale 0.2 inside and outside) -> conv3 -> global
skip -> x2 stages [conv3x3(->4*64) -> PixelShuffle -> PReLU] ->
conv9x9(64->3), or with ``phase_tail`` the same tail in phase space.
``quantize`` applies to the dense convs and the trunk projection
``mid_conv``, which keep the ``concat`` layout as in JAX (per-conv
activation scales are defined on the concatenated input). The registry size (``RRDB``: 64 channels, growth 32, 23
blocks) has 16,896,453 parameters.

Init as in JAX: the dense convs kaiming-normal x 0.1 (ESRGAN's), and the
trunk projection ``mid_conv`` x 0.01, without which the 23-block trunk
starts ~66x the size of its input.

The JAX package's ``split`` dense layout computes the same function
rewritten per source to fill the TPU's MXU; the port runs ``concat`` and
refuses ``split`` until an H100 A/B decides it (ROADMAP item 7a).
``compute_dtype`` runs the convs in that dtype on float32 weights (JAX's
``dtype=``).
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import (Conv, leaky_relu, scalar_in, set_compute_dtype,
                     upsample_tail)


class ResidualDenseBlock(nn.Module):
    """conv_k sees [x, c1..c_{k-1}] on the channel axis; convs 1-4 emit
    ``growth`` channels through LeakyReLU(0.2), conv5 projects back to
    ``channels``; the residual is scaled by ``res_scale``."""

    def __init__(self, channels: int, growth: int = 32,
                 res_scale: float = 0.2, quantize: str = ""):
        super().__init__()
        self.res_scale = res_scale
        for k in range(4):
            setattr(self, f"conv{k + 1}",
                    Conv(channels + k * growth, growth, 3, init_scale=0.1,
                         quantize=quantize))
        self.conv5 = Conv(channels + 4 * growth, channels, 3, init_scale=0.1,
                          quantize=quantize)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4):
            inp = feats[0] if len(feats) == 1 else torch.cat(feats, 1)
            feats.append(leaky_relu(conv(inp), 0.2))
        out = self.conv5(torch.cat(feats, 1))
        return x + out * scalar_in(self.res_scale, out.dtype)


class RRDB(nn.Module):
    """Residual in residual: three dense blocks, the outer residual scaled
    by ``res_scale``."""

    def __init__(self, channels: int, growth: int = 32,
                 res_scale: float = 0.2, quantize: str = ""):
        super().__init__()
        self.res_scale = res_scale
        self.dense1 = ResidualDenseBlock(channels, growth, res_scale, quantize)
        self.dense2 = ResidualDenseBlock(channels, growth, res_scale, quantize)
        self.dense3 = ResidualDenseBlock(channels, growth, res_scale, quantize)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = self.dense3(self.dense2(self.dense1(x)))
        return x + r * scalar_in(self.res_scale, r.dtype)


class RRDBNet(nn.Module):
    """(N, C, H, W) in and out at ``scale_factor`` times the size, run
    channels-last. Parameters ``input_conv``, ``rrdb.{i}.dense{j}.conv{k}``,
    ``mid_conv``, ``upsample.{3s,3s+2}``, ``output_conv`` (the layout
    ``convert.params_from_jax`` writes). ``dense_layout`` is "auto" or
    "concat" (the same computation here); "split" raises."""

    memory_format = torch.channels_last

    def __init__(self, scale_factor: int = 4, num_channels: int = 64,
                 growth: int = 32, num_blocks: int = 23,
                 dense_layout: str = "auto", quantize: str = "",
                 phase_tail: bool = False,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        if dense_layout == "split":
            raise NotImplementedError(
                "RRDBNet dense_layout='split' is not ported to PyTorch yet: "
                "ROADMAP item 7a (an H100 A/B of the split dense layout)")
        if dense_layout not in ("auto", "concat"):
            raise ValueError(f"Unknown dense_layout: {dense_layout!r}")
        self.scale_factor = scale_factor
        self.num_channels = num_channels
        self.growth = growth
        self.num_blocks = num_blocks
        self.quantize = quantize
        self.phase_tail = phase_tail
        self.input_conv = Conv(3, num_channels, 3)
        self.rrdb = nn.ModuleList(RRDB(num_channels, growth, quantize=quantize)
                                  for _ in range(num_blocks))
        self.mid_conv = Conv(num_channels, num_channels, 3, init_scale=0.01,
                             quantize=quantize)
        self.upsample, self.output_conv = upsample_tail(
            num_channels, scale_factor, phase_tail)
        set_compute_dtype(self, compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        initial = self.input_conv(
            x.contiguous(memory_format=self.memory_format))
        r = initial
        for block in self.rrdb:
            r = block(r)
        x = initial + self.mid_conv(r)
        return self.output_conv(self.upsample(x))
