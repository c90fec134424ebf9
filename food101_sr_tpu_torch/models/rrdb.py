"""RRDBNet, the ESRGAN residual-in-residual dense block generator
(counterpart of ``food101_sr_tpu/models/rrdb.py``).

conv3 head (no activation) -> N RRDBs (three 5-conv dense blocks each,
LeakyReLU 0.2, residual scale 0.2 inside and outside) -> conv3 -> global
skip -> x2 stages [conv3x3(->4*64) -> PixelShuffle -> PReLU] ->
conv9x9(64->3), or with ``phase_tail`` the same tail in phase space.
``quantize`` applies to the dense convs and the trunk projection
``mid_conv``, which keep the ``concat`` layout as in JAX (per-conv
activation scales are defined on the concatenated input). The registry
size (``RRDB``: 64 channels, growth 32, 23 blocks) has 16,896,453
parameters.

Init as in JAX: the dense convs kaiming-normal x 0.1 (ESRGAN's), and the
trunk projection ``mid_conv`` x 0.01, without which the 23-block trunk
starts ~66x the size of its input.

A dense block runs in one of JAX's two layouts, the same function on the
same parameters (the layout does not show in the state_dict): ``concat``
convolves the growing concatenation ``[x, c1..c_{k-1}]``; ``split``
convolves each source once with a wide kernel that stacks the slices of
every later conv's weight reading it, and accumulates the per-destination
slices of the result, so no activation is ever concatenated. ``auto``
takes split in training passes and concat otherwise, as in JAX.
``compute_dtype`` runs the convs in that dtype on float32 weights (JAX's
``dtype=``); ``remat`` recomputes each RRDB in the backward
(``layers.run_blocks``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (Conv, _cast, leaky_relu, run_blocks, scalar_in,
                     set_compute_dtype, upsample_tail)

LAYOUTS = ("auto", "concat", "split")


def _memory_format(w: torch.Tensor) -> torch.memory_format:
    return (torch.channels_last
            if not w.is_contiguous()
            and w.is_contiguous(memory_format=torch.channels_last)
            else torch.contiguous_format)


class _WideKernels(torch.autograd.Function):
    """The split layout's kernels from the five dense convs' weights (OIHW):
    source ``s`` (``x`` for 0, ``c_s`` after) is read by conv{d+1} for every
    d >= s through the input channels ``segments[s]`` of its weight, and its
    kernel stacks those slices on the output axis, d ascending. The kernels
    keep the weights' memory format, and the backward hands each weight its
    gradient in the weight's own format (CUDA's fused Adam refuses
    another)."""

    @staticmethod
    def forward(ctx, segments, *weights):
        ctx.outs = [w.shape[0] for w in weights]
        ctx.formats = [_memory_format(w) for w in weights]
        fmt = ctx.formats[0]
        return tuple(
            torch.cat([w[:, off:off + n] for w in weights[s:]])
            .contiguous(memory_format=fmt)
            for s, (off, n) in enumerate(segments))

    @staticmethod
    def backward(ctx, *grads):
        parts = [[] for _ in ctx.outs]  # parts[d]: conv{d+1}'s slices by s
        for s, g in enumerate(grads):
            for d, rows in enumerate(g.split(ctx.outs[s:]), start=s):
                parts[d].append(rows)
        return (None, *(torch.cat(p, 1).contiguous(memory_format=fmt)
                        for p, fmt in zip(parts, ctx.formats)))


class ResidualDenseBlock(nn.Module):
    """conv_k sees [x, c1..c_{k-1}] on the channel axis; convs 1-4 emit
    ``growth`` channels through LeakyReLU(0.2), conv5 projects back to
    ``channels``; the residual is scaled by ``res_scale``. ``forward``
    takes the layout, "concat" or "split" (the module docstring)."""

    def __init__(self, channels: int, growth: int = 32,
                 res_scale: float = 0.2, quantize: str = ""):
        super().__init__()
        self.channels = channels
        self.growth = growth
        self.res_scale = res_scale
        for k in range(4):
            setattr(self, f"conv{k + 1}",
                    Conv(channels + k * growth, growth, 3, init_scale=0.1,
                         quantize=quantize))
        self.conv5 = Conv(channels + 4 * growth, channels, 3, init_scale=0.1,
                          quantize=quantize)

    def forward(self, x: torch.Tensor,
                layout: str = "concat") -> torch.Tensor:
        if layout == "split":
            return self._split(x)
        feats = [x]
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4):
            inp = feats[0] if len(feats) == 1 else torch.cat(feats, 1)
            feats.append(leaky_relu(conv(inp), 0.2))
        out = self.conv5(torch.cat(feats, 1))
        return x + out * scalar_in(self.res_scale, out.dtype)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        """JAX's ``ResidualDenseBlock._split``: by linearity
        ``conv(cat(f_s), W) = sum_s conv(f_s, W[seg_s])``; ``acc[d]`` is
        conv{d+1}'s running pre-activation, each source's contribution
        added in turn and the bias last."""
        c, g = self.channels, self.growth
        convs = (self.conv1, self.conv2, self.conv3, self.conv4, self.conv5)
        cd = self.conv1.compute_dtype
        widths = [g, g, g, g, c]  # conv{d+1}'s output channels
        segments = [(0, c)] + [(c + g * k, g) for k in range(4)]
        kernels = _WideKernels.apply(
            segments, *(_cast(m.weight, cd) for m in convs))
        biases = [_cast(m.bias, cd).view(1, -1, 1, 1) for m in convs]
        acc = list(F.conv2d(_cast(x, cd), kernels[0], padding=1)
                   .split(widths, 1))
        for s in range(1, 5):
            src = leaky_relu(acc[s - 1] + biases[s - 1], 0.2)
            outs = F.conv2d(src, kernels[s], padding=1).split(widths[s:], 1)
            for d, p in enumerate(outs, start=s):
                acc[d] = acc[d] + p
        out = acc[4] + biases[4]
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

    def forward(self, x: torch.Tensor,
                layout: str = "concat") -> torch.Tensor:
        r = x
        for dense in (self.dense1, self.dense2, self.dense3):
            r = dense(r, layout)
        return x + r * scalar_in(self.res_scale, r.dtype)


class RRDBNet(nn.Module):
    """(N, C, H, W) in and out at ``scale_factor`` times the size, run
    channels-last. Parameters ``input_conv``, ``rrdb.{i}.dense{j}.conv{k}``,
    ``mid_conv``, ``upsample.{3s,3s+2}``, ``output_conv`` (the layout
    ``convert.params_from_jax`` writes) in every ``dense_layout``: "auto",
    "concat" or "split" (:meth:`resolved_layout`)."""

    memory_format = torch.channels_last

    def __init__(self, scale_factor: int = 4, num_channels: int = 64,
                 growth: int = 32, num_blocks: int = 23,
                 dense_layout: str = "auto", quantize: str = "",
                 phase_tail: bool = False,
                 compute_dtype: torch.dtype | None = None,
                 remat: bool = False):
        super().__init__()
        if dense_layout not in LAYOUTS:
            raise ValueError(f"Unknown dense_layout: {dense_layout!r}")
        self.scale_factor = scale_factor
        self.num_channels = num_channels
        self.growth = growth
        self.num_blocks = num_blocks
        self.dense_layout = dense_layout
        self.quantize = quantize
        self.phase_tail = phase_tail
        self.remat = remat
        self.input_conv = Conv(3, num_channels, 3)
        self.rrdb = nn.ModuleList(RRDB(num_channels, growth, quantize=quantize)
                                  for _ in range(num_blocks))
        self.mid_conv = Conv(num_channels, num_channels, 3, init_scale=0.01,
                             quantize=quantize)
        self.upsample, self.output_conv = upsample_tail(
            num_channels, scale_factor, phase_tail)
        set_compute_dtype(self, compute_dtype)

    def resolved_layout(self, train: bool = False) -> str:
        """JAX's rule: a quantized body and "concat" take concat, "split"
        split, and "auto" split in training passes, concat otherwise."""
        if self.dense_layout not in LAYOUTS:
            raise ValueError(f"Unknown dense_layout: {self.dense_layout!r}")
        if self.quantize or self.dense_layout == "concat":
            return "concat"
        if self.dense_layout == "split":
            return "split"
        return "split" if train else "concat"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        initial = self.input_conv(
            x.contiguous(memory_format=self.memory_format))
        r = run_blocks(self.rrdb, initial, self.remat,
                       self.resolved_layout(self.training))
        x = initial + self.mid_conv(r)
        return self.output_conv(self.upsample(x))
