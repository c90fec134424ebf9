"""Building blocks of the SR generators (counterpart of
``food101_sr_tpu/models/layers.py``), (N, C, H, W) in either memory
format.

Module names follow the reference PyTorch layout, so that a state_dict
exported from a JAX checkpoint (``convert.params_from_jax``) loads with
``strict=True``. Initialization matches the JAX package's distributions
and is drawn from an explicit ``torch.Generator`` (:func:`init_weights`).

A compute dtype (:func:`set_compute_dtype`) follows Flax's ``dtype``: the
parameters stay float32, and each conv and linear casts its input, weight
and bias to the compute dtype at every call, so autograd hands float32
gradients back to the parameters (bf16 training with float32 master
weights). With no compute dtype a layer runs in the dtype of its input
and weights, as a served ``.to(torch.bfloat16)`` net does; on the same
weights the two forwards are the same computation.
"""
from __future__ import annotations

import contextlib
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.quantize import fake_quant_conv2d, int8_conv2d
from ..parallel.distributed import global_sum, world_size
from ..ops.spatial_mean import spatial_mean
from ..ops.subpixel_conv import (grouped_out_map, phase_conv2d,
                                 phase_conv2d_grouped, subpixel_conv2d)


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


@functools.lru_cache(maxsize=64)
def scalar_in(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``: JAX multiplies a tensor by
    ``jnp.asarray(value, x.dtype)`` (or a weakly typed scalar, which it
    rounds alike), PyTorch by the unrounded scalar in float32 arithmetic.
    The same float32 for float32 tensors; for bf16 ones the JAX rounding
    (0.1 -> 0.10009765625)."""
    return float(torch.tensor(value, dtype=dtype))


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """``where(x >= 0, x, slope * x)`` with the slope in ``x.dtype``, as
    JAX's ``nn.leaky_relu``."""
    return F.leaky_relu(x, scalar_in(slope, x.dtype))


class LeakyReLU(nn.LeakyReLU):
    """``nn.LeakyReLU`` through :func:`leaky_relu`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(x, self.negative_slope)


def _cast(t: torch.Tensor | None, dtype: torch.dtype | None):
    return t if t is None or dtype is None else t.to(dtype)


def set_compute_dtype(model: nn.Module,
                      dtype: torch.dtype | None) -> nn.Module:
    """Run every conv and linear of ``model`` in ``dtype`` (None: in the
    dtype of their inputs) with the parameters kept as they are (JAX's
    ``dtype=`` on the modules; the module docstring says how)."""
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype
    return model


def _keep_float32(module: nn.Module, apply, fn, recurse: bool):
    """``module._apply`` that keeps the float32 parameters and buffers in
    float32: ``apply`` (the parent's ``_apply``) runs, then every tensor
    that was float32 and is not any more comes back as float32 on its new
    device (a ``.to(torch.bfloat16)`` moves them but keeps their dtype)."""
    kept = {n: t.detach() for n, t in (*module._parameters.items(),
                                       *module._buffers.items())
            if t is not None and t.dtype == torch.float32}
    apply(fn, recurse)
    for name, old in kept.items():
        new = getattr(module, name)
        if new.dtype != torch.float32:
            f32 = old.to(device=new.device)
            if name in module._parameters:
                module._parameters[name].data = f32
            else:
                module._buffers[name] = f32
    return module


class Conv(nn.Conv2d):
    """2-D conv with symmetric ``(k-1)//2`` padding. Initialized
    kaiming-normal (gain sqrt 2 over ``fan``, "fan_in" or "fan_out",
    times ``init_scale``) with zero bias, or ICNR for ``icnr_scale > 1``
    (a conv that feeds a pixel shuffle).

    The forward picks the compute path, as the JAX package's ``_RawConv``
    does (the weights are the HR conv's OIHW weights on every path, so
    the state_dict is the same):

    - ``phase_in > 1``: the input is ``phase_in``-phase pixel-shuffle
      layout at LR resolution (``phase_in_map``: each input channel's
      canonical index) and the conv runs there: the dense phase form with
      the HR image out when ``subpixel_r > 1`` (a tail's last conv), the
      grouped polyphase form otherwise (``ops.subpixel_conv``);
    - ``quantize``: "qat" the fake-quantized conv (trainable), "int8" or
      "int8_dot" the dynamic-int8 conv (``ops.quantize``; the two JAX
      lowerings are one computation here). A quantized
      conv keeps its weight and bias in float32 in any dtype, as JAX
      quantizes the float32 parameters (a compute dtype casts its input
      only);
    - ``subpixel_r > 1``: the phase decomposition of a stride-1 conv with
      few outputs, where H and W divide by r and ``out*r*r <= 256``;
    - otherwise the direct conv.

    ``compute_dtype`` (:func:`set_compute_dtype`) casts the input, the
    weight and the bias on every route but the quantized ones.
    """

    compute_dtype: torch.dtype | None = None

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, bias: bool = True, icnr_scale: int = 0,
                 fan: str = "fan_in", init_scale: float = 1.0,
                 subpixel_r: int = 0, quantize: str = "",
                 phase_in: int = 0, phase_in_map: tuple | None = None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding=(kernel_size - 1) // 2, bias=bias)
        if fan not in ("fan_in", "fan_out"):
            raise ValueError(f"fan must be fan_in or fan_out, got {fan!r}")
        if quantize not in ("", "int8", "int8_dot", "qat"):
            raise ValueError(f"Unknown quantize mode: {quantize!r}")
        if phase_in > 1 and (stride != 1 or quantize):
            raise ValueError("phase-space convs are stride-1 and full "
                             "precision")
        self.icnr_scale = icnr_scale
        self.fan = fan
        self.init_scale = init_scale
        self.subpixel_r = subpixel_r
        self.quantize = quantize
        self.phase_in = phase_in
        self.phase_in_map = phase_in_map

    def _apply(self, fn, recurse=True):
        if self.quantize:
            return _keep_float32(self, super()._apply, fn, recurse)
        return super()._apply(fn, recurse)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _cast(x, self.compute_dtype)
        if self.quantize == "qat":
            return fake_quant_conv2d(x, self.weight, self.bias,
                                     stride=self.stride[0])
        if self.quantize:
            return int8_conv2d(x, self.weight, self.bias,
                               stride=self.stride[0])
        weight = _cast(self.weight, self.compute_dtype)
        bias = _cast(self.bias, self.compute_dtype)
        if self.phase_in > 1:
            if self.subpixel_r > 1:
                return phase_conv2d(x, weight, bias, self.phase_in,
                                    in_map=self.phase_in_map,
                                    shuffle_out=True)
            return phase_conv2d_grouped(x, weight, bias, self.phase_in,
                                        in_map=self.phase_in_map)
        r = self.subpixel_r
        h, w = x.shape[2], x.shape[3]
        if (r > 1 and self.stride[0] == 1 and h % r == 0 and w % r == 0
                and self.out_channels * r * r <= 256):
            return subpixel_conv2d(x, weight, bias, r)
        return self._conv_forward(x, weight, bias)


class Linear(nn.Linear):
    """``nn.Linear`` with a ``compute_dtype`` (:func:`set_compute_dtype`),
    as JAX's ``nn.Dense(dtype=...)``."""

    compute_dtype: torch.dtype | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return F.linear(_cast(x, cd), _cast(self.weight, cd),
                        _cast(self.bias, cd))


class PReLU(nn.PReLU):
    """``nn.PReLU`` with the slope cast to the input's dtype, as JAX's
    ``PReLU`` (a float32 slope in a bf16 net)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.prelu(x, self.weight.to(x.dtype))


def prelu() -> PReLU:
    """PReLU with one shared slope, initial 0.25."""
    return PReLU(num_parameters=1, init=0.25)


class SEBlock(nn.Module):
    """Squeeze-and-excitation, reduction 16: spatial mean (kernel K2 on
    CUDA) -> Linear(c/r) -> ReLU -> Linear(c) -> sigmoid -> rescale."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        hidden = channels // reduction
        self.fc = nn.Sequential(Linear(channels, hidden, bias=False),
                                nn.ReLU(),
                                Linear(hidden, channels, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.sigmoid(self.fc(spatial_mean(x)))
        return x * y[:, :, None, None]


class AttentionResidualBlock(nn.Module):
    """conv3x3 -> PReLU -> conv3x3 -> SE, no BN, residual scaled by 0.1."""

    def __init__(self, channels: int, res_scale: float = 0.1,
                 quantize: str = ""):
        super().__init__()
        self.conv1 = Conv(channels, channels, 3, quantize=quantize)
        self.prelu = prelu()
        self.conv2 = Conv(channels, channels, 3, quantize=quantize)
        self.se = SEBlock(channels)
        self.res_scale = res_scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = self.se(self.conv2(self.prelu(self.conv1(x))))
        return x + r * scalar_in(self.res_scale, r.dtype)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with the JAX package's ``TorchBatchNorm`` semantics:
    momentum 0.1 (flax's 0.9), eps 1e-5, the biased batch variance to
    normalize and the Bessel-corrected one into ``running_var`` (torch's
    own rule). As in JAX, the scale, the bias and the running stats stay
    in float32 whatever the net's dtype (``.to(torch.bfloat16)`` moves
    them across devices but keeps their dtype), and the normalization runs
    in float32 before the result is cast to the input's dtype.

    In a process group of more than one rank, train mode normalizes by the
    global batch's statistics, as JAX's mesh does: ``E[x^2] - E[x]^2`` in
    float32 from per-rank sums all-reduced by a differentiable collective
    (the backward gets the other ranks' shares), the global n in the
    Bessel factor. A world of 1 runs PyTorch's own batch norm.

    While ``recomputing`` (a block's forward run again in the backward,
    :func:`run_blocks`) train mode normalizes as before and leaves the
    running stats alone: the step's first forward advanced them."""

    recomputing = False

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def _apply(self, fn, recurse=True):
        return _keep_float32(self, super()._apply, fn, recurse)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and world_size() > 1:
            return self._global_batch(x.float()).to(x.dtype)
        if self.training and self.recomputing:
            # the call nn.BatchNorm2d makes, on copies of the running stats
            return F.batch_norm(x.float(), self.running_mean.clone(),
                                self.running_var.clone(), self.weight,
                                self.bias, True, self.momentum,
                                self.eps).to(x.dtype)
        return super().forward(x.float()).to(x.dtype)

    def _global_batch(self, x: torch.Tensor) -> torch.Tensor:
        n = x.numel() // x.shape[1] * world_size()
        sums = global_sum(torch.stack([x.sum((0, 2, 3)),
                                       (x * x).sum((0, 2, 3))]))
        mean = sums[0] / n
        var = sums[1] / n - mean * mean
        with torch.no_grad():
            if not self.recomputing:
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(
                    m * var * (n / max(n - 1, 1)))
                self.num_batches_tracked += 1
        shape = (1, -1, 1, 1)
        y = (x - mean.view(shape)) * torch.rsqrt(var + self.eps).view(shape)
        return y * self.weight.view(shape) + self.bias.view(shape)


class ResidualBlock(nn.Module):
    """conv3x3 -> BN -> PReLU -> conv3x3 -> BN, identity skip, no residual
    scaling (ResNetSR's block)."""

    def __init__(self, channels: int, quantize: str = ""):
        super().__init__()
        self.conv1 = Conv(channels, channels, 3, quantize=quantize)
        self.bn1 = BatchNorm2d(channels)
        self.prelu = prelu()
        self.conv2 = Conv(channels, channels, 3, quantize=quantize)
        self.bn2 = BatchNorm2d(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = self.prelu(self.bn1(self.conv1(x)))
        return x + self.bn2(self.conv2(r))


@contextlib.contextmanager
def _recomputing(block: nn.Module):
    """Within the block, ``block``'s BatchNorms are ``recomputing``."""
    norms = [m for m in block.modules() if isinstance(m, BatchNorm2d)]
    for m in norms:
        m.recomputing = True
    try:
        yield
    finally:
        for m in norms:
            m.recomputing = False


def run_blocks(blocks: nn.ModuleList, x: torch.Tensor, remat: bool,
               *args) -> torch.Tensor:
    """``x`` through each of ``blocks`` in turn (``block(x, *args)``).

    With ``remat``, in a differentiated pass each block keeps only its
    input and runs its forward again in the backward
    (``torch.utils.checkpoint``, non-reentrant), as JAX's ``nn.remat`` per
    block does: the step's activation memory falls by about a block stack
    for one more forward of it. The blocks draw no random numbers, so no
    RNG state is kept; the recompute leaves BatchNorm's running stats
    alone, and a collective inside a block (global-batch BatchNorm) runs
    once more on every rank alike. Without a gradient it is the plain
    loop."""
    for block in blocks:
        if remat and torch.is_grad_enabled():
            x = checkpoint(block, x, *args, use_reentrant=False,
                           preserve_rng_state=False,
                           context_fn=lambda b=block: (
                               contextlib.nullcontext(), _recomputing(b)))
        else:
            x = block(x, *args)
    return x


def upsample_block(in_channels: int, out_channels: int = 64,
                   scale: int = 2, phase_in: int = 0,
                   phase_in_map: tuple | None = None) -> list[nn.Module]:
    """One x``scale`` tail stage: conv3x3 (ICNR) -> PixelShuffle -> PReLU,
    as a flat list so the stages of a tail share one ``nn.Sequential``
    (state_dict keys ``upsample.{3s}`` / ``upsample.{3s+2}``).

    ``phase_in >= 1`` runs the stage in phase space (the JAX
    ``UpsampleBlock``'s phase form): the input is ``phase_in``-phase
    layout at LR resolution (1: the trunk itself, whose conv outputs are
    the stage's own shuffle layout), the conv is the grouped phase conv
    for ``phase_in > 1``, and no shuffle is materialized (an
    ``nn.Identity`` holds its place); PReLU's one slope commutes with any
    channel layout. The same weights either way."""
    conv = Conv(in_channels, out_channels * scale * scale, 3,
                icnr_scale=scale, phase_in=phase_in,
                phase_in_map=phase_in_map)
    shuffle = nn.Identity() if phase_in >= 1 else nn.PixelShuffle(scale)
    return [conv, shuffle, prelu()]


def upsample_tail(in_channels: int, scale_factor: int,
                  phase_tail: bool = False) -> tuple[nn.Sequential, Conv]:
    """The post-upsampling tail of ResNetSR, AttentionSR and RRDBNet: x``s``
    stages from ``scale_stages`` (64 channels each), then the conv9x9 to
    RGB (``output_conv``, ``subpixel_r=scale_factor``). ``phase_tail``
    runs every tail conv at LR resolution in pixel-shuffle phase space and
    shuffles once, at the very end: a stage reads ``r_acc``-phase input
    (the product of the earlier stages' factors), a grouped stage's
    ``(py, px, c, by, bx)`` channel order folds into the next conv's
    gather (``grouped_out_map``), and the output conv is the dense phase
    conv at ``scale_factor`` phases. Returns (``upsample``,
    ``output_conv``)."""
    layers, cin, r_acc, in_map = [], in_channels, 1, None
    for s in scale_stages(scale_factor):
        layers += upsample_block(cin, 64, s, r_acc if phase_tail else 0,
                                 in_map)
        if phase_tail:
            in_map = (grouped_out_map(64 * s * s, r_acc, s=s)
                      if r_acc > 1 else None)
            r_acc *= s
        cin = 64
    return nn.Sequential(*layers), Conv(
        64, 3, 9, subpixel_r=scale_factor,
        phase_in=r_acc if phase_tail else 0, phase_in_map=in_map)


# ---------------------------------------------------------------------------
# Spectral normalization, by hand (counterpart of _SpectralKernel, SNConv and
# SNDense): torch.nn.utils' spectral norms detach u and v, normalize with
# max(||x||, eps) and run 15 power iterations when registered, so they
# compute another function and another gradient.
# ---------------------------------------------------------------------------

def _normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x) + eps)


class _SpectralNorm(nn.Module):
    """Owns ``weight_orig`` (out, ...), the power-iteration buffers
    ``weight_u`` (out) and ``weight_v`` (the product of the other dims, in
    torch's (in, kh, kw) order) and an optional ``bias``; ``weight()``
    returns ``weight_orig / sigma``.

    In train mode one power iteration runs first, ``v = normalize(W^T u)``
    then ``u = normalize(W v)`` on the (out, -1) matrix ``W``, and both are
    stored; sigma is ``u^T W v`` on the updated vectors, and the gradient
    flows through the iteration, as in the JAX package (no stop-gradient).
    In eval mode sigma comes from the stored vectors.

    Inside :func:`chained_power_iterations` a train-mode forward starts
    from the previous forward's ``u`` with its graph, not from the stored
    copy: the JAX package threads the updated vectors from one apply into
    the next inside one differentiated loss (the D step's real then fake
    forward), so the second forward's sigma depends on the weight through
    both iterations.

    The power iteration and sigma run in float32 on the float32
    parameters; ``compute_dtype`` casts the layer's input, normalized
    weight and bias, as JAX's ``SNConv``/``SNDense`` cast theirs."""

    eps = 1e-12
    compute_dtype: torch.dtype | None = None

    def __init__(self, weight_shape: tuple, bias: bool):
        super().__init__()
        out, n = weight_shape[0], math.prod(weight_shape[1:])
        self.weight_orig = nn.Parameter(torch.empty(weight_shape))
        self.bias = nn.Parameter(torch.empty(out)) if bias else None
        self.register_buffer("weight_u", torch.empty(out))
        self.register_buffer("weight_v", torch.empty(n))
        self.chain = False
        self._u_live: torch.Tensor | None = None

    def weight(self) -> torch.Tensor:
        w = self.weight_orig.flatten(1)
        if self.training:
            u = self._u_live if self._u_live is not None else \
                self.weight_u.clone()
            v = _normalize(w.t() @ u, self.eps)
            u = _normalize(w @ v, self.eps)
            with torch.no_grad():
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
            if self.chain:
                self._u_live = u
        else:
            u, v = self.weight_u, self.weight_v
        sigma = torch.dot(v, w.t() @ u)
        return self.weight_orig / sigma


class SNConv2d(_SpectralNorm):
    """Spectral-norm conv, square kernel, ``(k-1)//2`` padding."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, bias: bool = True):
        super().__init__((out_channels, in_channels, kernel_size,
                          kernel_size), bias)
        self.stride, self.padding = stride, (kernel_size - 1) // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return F.conv2d(_cast(x, cd), _cast(self.weight(), cd),
                        _cast(self.bias, cd), self.stride, self.padding)


class SNLinear(_SpectralNorm):
    """Spectral-norm dense layer."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__((out_features, in_features), bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return F.linear(_cast(x, cd), _cast(self.weight(), cd),
                        _cast(self.bias, cd))


@contextlib.contextmanager
def chained_power_iterations(model: nn.Module):
    """Within the block, each spectral-norm layer of ``model`` chains its
    train-mode power iterations through autograd (see ``_SpectralNorm``);
    the graph is dropped on exit."""
    layers = [m for m in model.modules() if isinstance(m, _SpectralNorm)]
    for m in layers:
        m.chain, m._u_live = True, None
    try:
        yield
    finally:
        for m in layers:
            m.chain, m._u_live = False, None


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
    convs over their ``fan`` times their ``init_scale`` (SRCNN's fan_out,
    RRDB's 0.1-scaled dense convs and 0.01-scaled trunk projection; ICNR
    for pixel-shuffle feeders) and spectral-norm kernels, zero biases,
    lecun-normal linears, PReLU slope 0.25, power-iteration vectors
    ``N(0, 1/len)``, BatchNorm at ones, zeros and unit running variance.
    Draws on the CPU in module order."""
    for m in model.modules():
        if isinstance(m, _SpectralNorm):
            w = m.weight_orig
            w.copy_(_normal(w.shape, math.sqrt(2.0 / w[0].numel()),
                            generator))
            for vec in (m.weight_u, m.weight_v):
                vec.copy_(_normal(vec.shape, 1.0 / math.sqrt(vec.numel()),
                                  generator))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
        elif isinstance(m, Conv):
            cout = m.weight.shape[0]
            fan = (m.weight[0].numel() if m.fan == "fan_in"
                   else cout * m.weight[0, 0].numel())
            r2 = m.icnr_scale ** 2
            std = math.sqrt(2.0 / fan) * m.init_scale
            if r2 > 1 and cout % r2 == 0:
                sub = _normal((cout // r2, *m.weight.shape[1:]), std,
                              generator)
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
