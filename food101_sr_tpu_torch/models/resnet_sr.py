"""ResNetSR, the post-upsampling SRResNet/EDSR hybrid (counterpart of
``food101_sr_tpu/models/resnet_sr.py`` with the materialized tail).

conv9x9(3->C) + PReLU -> N residual blocks (BatchNorm) -> conv3x3 + BN ->
global skip -> x2 stages [conv3x3(->4*64) -> PixelShuffle -> PReLU] ->
conv9x9(64->3). The BatchNorms keep their parameters and running stats in
float32 in any dtype (``layers.BatchNorm2d``), as the JAX package's do.
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import (BatchNorm2d, Conv, ResidualBlock, prelu, scale_stages,
                     upsample_block)


class ResNetSR(nn.Module):
    """(N, C, H, W) in and out at ``scale_factor`` times the size, run
    channels-last (the weights should be in the same format;
    ``registry.build_model`` puts them there). Parameter names follow the
    reference layout: ``input_conv``, ``prelu``,
    ``res_blocks.{i}.{conv1,bn1,prelu,conv2,bn2}``, ``mid_conv``,
    ``bn_mid``, ``upsample.{3s,3s+2}``, ``output_conv``."""

    memory_format = torch.channels_last

    def __init__(self, scale_factor: int = 4, num_channels: int = 64,
                 num_residuals: int = 16):
        super().__init__()
        self.scale_factor = scale_factor
        self.num_residuals = num_residuals
        self.input_conv = Conv(3, num_channels, 9)
        self.prelu = prelu()
        self.res_blocks = nn.ModuleList(
            ResidualBlock(num_channels) for _ in range(num_residuals))
        self.mid_conv = Conv(num_channels, num_channels, 3)
        self.bn_mid = BatchNorm2d(num_channels)
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
        x = initial + self.bn_mid(self.mid_conv(r))
        return self.output_conv(self.upsample(x))
