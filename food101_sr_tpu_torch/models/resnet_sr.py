"""ResNetSR, the post-upsampling SRResNet/EDSR hybrid (counterpart of
``food101_sr_tpu/models/resnet_sr.py``).

conv9x9(3->C) + PReLU -> N residual blocks (BatchNorm) -> conv3x3 + BN ->
global skip -> x2 stages [conv3x3(->4*64) -> PixelShuffle -> PReLU] ->
conv9x9(64->3), or with ``phase_tail`` the same tail in phase space;
``quantize`` applies to the residual blocks' convs and the mid conv (the
BatchNorms, head and tail stay full precision). The BatchNorms keep their parameters and running stats in
float32 in any dtype (``layers.BatchNorm2d``), as the JAX package's do;
``compute_dtype`` runs the convs in that dtype on float32 weights (JAX's
``dtype=``), the BatchNorms normalizing in float32.
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import (BatchNorm2d, Conv, ResidualBlock, prelu,
                     set_compute_dtype, upsample_tail)


class ResNetSR(nn.Module):
    """(N, C, H, W) in and out at ``scale_factor`` times the size, run
    channels-last (the weights should be in the same format;
    ``registry.build_model`` puts them there). Parameter names follow the
    reference layout: ``input_conv``, ``prelu``,
    ``res_blocks.{i}.{conv1,bn1,prelu,conv2,bn2}``, ``mid_conv``,
    ``bn_mid``, ``upsample.{3s,3s+2}``, ``output_conv``."""

    memory_format = torch.channels_last

    def __init__(self, scale_factor: int = 4, num_channels: int = 64,
                 num_residuals: int = 16, quantize: str = "",
                 phase_tail: bool = False,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.scale_factor = scale_factor
        self.num_residuals = num_residuals
        self.quantize = quantize
        self.phase_tail = phase_tail
        self.input_conv = Conv(3, num_channels, 9)
        self.prelu = prelu()
        self.res_blocks = nn.ModuleList(
            ResidualBlock(num_channels, quantize=quantize)
            for _ in range(num_residuals))
        self.mid_conv = Conv(num_channels, num_channels, 3, quantize=quantize)
        self.bn_mid = BatchNorm2d(num_channels)
        self.upsample, self.output_conv = upsample_tail(
            num_channels, scale_factor, phase_tail)
        set_compute_dtype(self, compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        initial = self.prelu(self.input_conv(
            x.contiguous(memory_format=self.memory_format)))
        r = initial
        for block in self.res_blocks:
            r = block(r)
        x = initial + self.bn_mid(self.mid_conv(r))
        return self.output_conv(self.upsample(x))
