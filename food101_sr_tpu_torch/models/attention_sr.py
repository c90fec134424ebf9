"""AttentionSR, the channel-attention SR net (counterpart of
``food101_sr_tpu/models/attention_sr.py``), with the standard upsample tail.

The JAX package's ``phase_tail`` computes the same function in pixel-shuffle
phase space; the port keeps the standard tail, and the tests hold it
against the JAX net with ``phase_tail`` both on and off.
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import (AttentionResidualBlock, Conv, prelu, scale_stages,
                     upsample_block)


class AttentionSR(nn.Module):
    """conv9 -> PReLU -> N attention residual blocks -> conv3, global skip,
    then x2 stages (conv, pixel shuffle, PReLU) and a conv9 to RGB.
    (N, C, H, W) in and out, at ``scale_factor`` times the size.

    The net runs in ``memory_format``, channels-last by default: cuDNN's
    bf16 tensor-core convs work in NHWC, so an NCHW net pays a transpose
    into and out of every conv, and the SE squeeze (kernel K2) reads
    channels-last directly. The weights should be in the same format
    (``registry.build_model`` puts them there)."""

    memory_format = torch.channels_last

    def __init__(self, scale_factor: int = 4, num_channels: int = 64,
                 num_residuals: int = 32):
        super().__init__()
        self.scale_factor = scale_factor
        self.num_residuals = num_residuals
        self.input_conv = Conv(3, num_channels, 9)
        self.prelu = prelu()
        self.res_blocks = nn.ModuleList(
            AttentionResidualBlock(num_channels) for _ in range(num_residuals))
        self.mid_conv = Conv(num_channels, num_channels, 3)
        tail, cin = [], num_channels
        for s in scale_stages(scale_factor):
            tail += upsample_block(cin, 64, s)
            cin = 64
        self.upsample = nn.Sequential(*tail)
        self.output_conv = Conv(64, 3, 9)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        initial = self.prelu(self.input_conv(
            x.contiguous(memory_format=self.memory_format)))
        r = initial
        for block in self.res_blocks:
            r = block(r)
        x = initial + self.mid_conv(r)
        return self.output_conv(self.upsample(x))
