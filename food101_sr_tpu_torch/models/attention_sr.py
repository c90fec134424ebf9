"""AttentionSR, the channel-attention SR net (counterpart of
``food101_sr_tpu/models/attention_sr.py``).

``phase_tail`` runs the upsample tail in pixel-shuffle phase space at LR
resolution (``layers.upsample_tail``), the same function with the same
weights; ``quantize`` runs the body convs (the residual blocks' and the
mid conv) in dynamic int8 for inference ("int8", "int8_dot") or
fake-quantized for QAT ("qat"), as in the JAX net; ``compute_dtype``
runs the convs and the SE linears in that dtype on float32 weights (JAX's
``dtype=``, bf16 training with float32 master weights); ``remat``
recomputes each attention block in the backward
(``layers.run_blocks``).
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import (AttentionResidualBlock, Conv, prelu, run_blocks,
                     set_compute_dtype, upsample_tail)


class AttentionSR(nn.Module):
    """conv9 -> PReLU -> N attention residual blocks -> conv3, global skip,
    then x2 stages (conv, pixel shuffle, PReLU) and a conv9 to RGB, or
    with ``phase_tail`` the same tail in phase space.
    (N, C, H, W) in and out, at ``scale_factor`` times the size.

    The net runs in ``memory_format``, channels-last by default: cuDNN's
    bf16 tensor-core convs work in NHWC, so an NCHW net pays a transpose
    into and out of every conv, and the SE squeeze (kernel K2) reads
    channels-last directly. The weights should be in the same format
    (``registry.build_model`` puts them there)."""

    memory_format = torch.channels_last

    def __init__(self, scale_factor: int = 4, num_channels: int = 64,
                 num_residuals: int = 32, quantize: str = "",
                 phase_tail: bool = False,
                 compute_dtype: torch.dtype | None = None,
                 remat: bool = False):
        super().__init__()
        self.scale_factor = scale_factor
        self.num_residuals = num_residuals
        self.remat = remat
        self.quantize = quantize
        self.phase_tail = phase_tail
        self.input_conv = Conv(3, num_channels, 9)
        self.prelu = prelu()
        self.res_blocks = nn.ModuleList(
            AttentionResidualBlock(num_channels, quantize=quantize)
            for _ in range(num_residuals))
        self.mid_conv = Conv(num_channels, num_channels, 3, quantize=quantize)
        self.upsample, self.output_conv = upsample_tail(
            num_channels, scale_factor, phase_tail)
        set_compute_dtype(self, compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        initial = self.prelu(self.input_conv(
            x.contiguous(memory_format=self.memory_format)))
        r = run_blocks(self.res_blocks, initial, self.remat)
        x = initial + self.mid_conv(r)
        return self.output_conv(self.upsample(x))
