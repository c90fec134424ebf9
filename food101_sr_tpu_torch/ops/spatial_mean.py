"""K2: global spatial mean (the SE-block squeeze), CUDA kernels for Hopper
(counterpart of ``food101_sr_tpu/ops/spatial_mean.py``, whose Pallas
``_mean_kernel`` they replace; the kernels are ``f101_nhwc_mean_{f32,bf16}``
and ``f101_plane_mean_{f32,bf16}`` in ``csrc/kernels.cu``).

``spatial_mean(x)`` is ``x.mean((2, 3))`` of an (N, C, H, W) tensor,
accumulated in float32 and returned in ``x.dtype``. The layout of ``x`` in
memory picks the kernel: channels-last (NHWC, the TPU kernel's own layout
and what the port's channels-last AttentionSR hands its SE blocks) goes to
the NHWC kernel, NCHW-contiguous to the plane kernel, and anything else is
refused. The JAX ``SEBlock`` keeps a plain ``jnp.mean`` because the Pallas
kernel lost on the TPU; the port's ``SEBlock`` calls this kernel, and
whether it stays there is for H100 measurements to decide (``PERF.md``).

The op is linear; its backward broadcasts ``g / (H*W)`` in plain PyTorch,
as the JAX VJP leaves it to XLA. ``spatial_mean`` also exists as the
registered operator ``f101::spatial_mean`` (:func:`spatial_mean_op`), which
an exported serving program (``export_serving``) calls.
"""
from __future__ import annotations

import torch

from .. import _build

_NHWC = {torch.float32: "f101_nhwc_mean_f32",
         torch.bfloat16: "f101_nhwc_mean_bf16"}
_PLANE = {torch.float32: "f101_plane_mean_f32",
          torch.bfloat16: "f101_plane_mean_bf16"}
_MAX_N = 65535  # NHWC kernel: one grid row per image
_MAX_C = 8192   # NHWC kernel: a block keeps C float32 sums in shared memory


def spatial_mean_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K2."""
    return x.float().mean((2, 3)).to(x.dtype)


def kernel_layout(x: torch.Tensor) -> str:
    """``"nhwc"`` for a channels-last tensor, ``"nchw"`` for a contiguous
    one, decided from the strides; a tensor that is both (C == 1 or
    H*W == 1: the two layouts are the same bytes) goes to ``"nhwc"``.
    Raises ``ValueError`` for any other layout."""
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
        return "nhwc"
    if x.dim() == 4 and x.is_contiguous():
        return "nchw"
    raise ValueError("mean_kernel: needs a 4-D tensor that is contiguous in "
                     f"channels-last or NCHW memory, got {tuple(x.shape)} "
                     f"strides {x.stride()}")


def _check(x: torch.Tensor, who: str) -> None:
    if not (x.is_cuda or x.device.type == "cpu"):
        raise ValueError(f"{who}: no kernel for device {x.device}")
    if x.dtype not in _NHWC or x.dim() != 4:
        raise ValueError(f"{who}: needs a 4-D float32 or bfloat16 tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if x.numel() == 0:
        raise ValueError(f"{who}: empty tensor {tuple(x.shape)}")


def mean_nhwc_kernel(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) in channels-last memory -> (N, C) mean over H, W: the
    NHWC kernel on CUDA, the plain version on the CPU (same checks on
    both). ``mean_nhwc_kernel.launches`` counts kernel launches."""
    _check(x, "mean_nhwc_kernel")
    n, c, h, w = x.shape
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("mean_nhwc_kernel: needs channels-last contiguous "
                         f"memory, got strides {x.stride()}")
    if n > _MAX_N or c > _MAX_C:
        raise ValueError(f"mean_nhwc_kernel: unsupported shape {tuple(x.shape)}")
    if not x.is_cuda:
        return spatial_mean_plain(x)
    out = torch.empty((n, c), dtype=x.dtype, device=x.device)
    dev = x.get_device()
    err = _build.entry(_NHWC[x.dtype])(x.data_ptr(), out.data_ptr(), n, c,
                                       h * w, dev, _build.current_stream(dev))
    _build.check(err, _NHWC[x.dtype])
    mean_nhwc_kernel.launches += 1
    return out


mean_nhwc_kernel.launches = 0


def mean_plane_kernel(x: torch.Tensor) -> torch.Tensor:
    """Contiguous NCHW (N, C, H, W) -> (N, C) mean over H, W: the plane
    kernel on CUDA, the plain version on the CPU (same checks on both).
    ``mean_plane_kernel.launches`` counts kernel launches."""
    _check(x, "mean_plane_kernel")
    n, c, h, w = x.shape
    if not x.is_contiguous():
        raise ValueError("mean_plane_kernel: needs NCHW contiguous memory, "
                         f"got strides {x.stride()}")
    if not x.is_cuda:
        return spatial_mean_plain(x)
    out = torch.empty((n, c), dtype=x.dtype, device=x.device)
    dev = x.get_device()
    err = _build.entry(_PLANE[x.dtype])(x.data_ptr(), out.data_ptr(), n * c,
                                        h * w, dev, _build.current_stream(dev))
    _build.check(err, _PLANE[x.dtype])
    mean_plane_kernel.launches += 1
    return out


mean_plane_kernel.launches = 0


def mean_kernel(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C) mean over H, W through the kernel for the
    layout of ``x`` (:func:`kernel_layout`)."""
    if kernel_layout(x) == "nhwc":
        return mean_nhwc_kernel(x)
    return mean_plane_kernel(x)


def _mean_backward(g: torch.Tensor, shape) -> torch.Tensor:
    """The mean's backward: ``g / (H*W)`` broadcast over H, W."""
    n, c, h, w = shape
    gx = (g.float() * (1.0 / (h * w))).to(g.dtype)
    return gx[:, :, None, None].expand(n, c, h, w)


class _SpatialMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.shape = x.shape
        return mean_kernel(x)

    @staticmethod
    def backward(ctx, g):
        return _mean_backward(g, ctx.shape)


# K2 as a registered operator, for programs that ``torch.export`` writes:
# a trace sees ``f101::spatial_mean`` (the fake below gives its shape and
# dtype) where it could not follow the ctypes launch, and the exported
# program calls the kernel through it. A loader needs only this module
# imported, which registers the op.
@torch.library.custom_op("f101::spatial_mean", mutates_args=())
def spatial_mean_op(x: torch.Tensor) -> torch.Tensor:
    """``f101::spatial_mean``: :func:`mean_kernel`, the kernel on CUDA
    (counted in its entry's ``launches``) and the plain version on the
    CPU."""
    return mean_kernel(x)


@spatial_mean_op.register_fake
def _spatial_mean_fake(x: torch.Tensor) -> torch.Tensor:
    return x.new_empty((x.shape[0], x.shape[1]))


def _op_setup(ctx, inputs, output) -> None:
    ctx.shape = inputs[0].shape


def _op_backward(ctx, g):
    return _mean_backward(g, ctx.shape)


spatial_mean_op.register_autograd(_op_backward, setup_context=_op_setup)


def spatial_mean(x: torch.Tensor) -> torch.Tensor:
    """Differentiable ``x.mean((2, 3))`` of an (N, C, H, W) tensor in
    channels-last or NCHW memory, with float32 accumulation, in
    ``x.dtype``. Under ``torch.export`` it is the registered op
    (:func:`spatial_mean_op`); eager calls take the
    ``autograd.Function``, which costs the host less per call."""
    if torch.compiler.is_exporting():
        return spatial_mean_op(x)
    return _SpatialMean.apply(x)
