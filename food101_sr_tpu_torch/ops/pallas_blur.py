"""K1: depthwise separable Gaussian blur, a CUDA kernel for Hopper
(counterpart of ``food101_sr_tpu/ops/pallas_blur.py``, whose Pallas
``_blur_kernel`` it replaces; the kernel is ``f101_blur5_f32`` in
``csrc/kernels.cu``).

The blur runs on every (image, channel) plane: a 5-tap pass along H, then
along W, with zero padding, which is exactly ``F.conv2d(padding=2,
groups=C)`` (the taps are symmetric, so correlation equals convolution).
The op is linear and self-adjoint, so its backward pass is the same kernel
applied to the cotangent.

Layers, as in the JAX module:

* :func:`blur_kernel` launches the kernel for a CUDA tensor and counts the
  launch; for a CPU tensor it runs the plain version
  (:func:`~food101_sr_tpu_torch.ops.gaussian.depthwise_blur`). The plain
  version takes any odd ``size``, as JAX's ``depthwise_blur_fast`` does;
  the kernel's tap count is fixed at 5 when it is compiled, so a CUDA
  tensor with another size raises (every caller in the package uses 5).
* :func:`blur` is the differentiable op (``torch.autograd.Function``).
* :func:`depthwise_blur_fast` casts to float32 and back around it.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build
from .gaussian import depthwise_blur, gaussian_kernel_2d

_KERNEL_SIZE = 5  # the kernel's compiled tap count (kTaps in kernels.cu)


@functools.lru_cache(maxsize=8)
def _gaussian_taps(size: int, sigma: float) -> tuple[float, ...]:
    """1-D taps of the separable kernel (outer(g, g) == 2-D kernel)."""
    k2d = gaussian_kernel_2d(size, sigma)
    c = (size - 1) // 2
    g = k2d[:, c] / np.sqrt(k2d[c, c])
    return tuple(float(t) for t in g)


@functools.lru_cache(maxsize=8)
def _taps_c(size: int, sigma: float) -> ctypes.Array:
    """The taps as the float[5] the kernel's entry point reads (made once
    per (size, sigma); the cache keeps the buffer alive)."""
    return (ctypes.c_float * size)(*_gaussian_taps(size, sigma))


def blur_kernel(x: torch.Tensor, size: int = 5,
                sigma: float = 1.0) -> torch.Tensor:
    """Blur every plane of contiguous NCHW float32 ``x``: kernel K1 on
    CUDA, the plain conv on the CPU (same checks on both, but ``size``:
    any odd size on the CPU, the kernel's 5 on CUDA).
    ``blur_kernel.launches`` counts kernel launches."""
    if not (x.is_cuda or x.device.type == "cpu"):
        raise ValueError(f"blur_kernel: no kernel for device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError("blur_kernel: needs a contiguous 4-D float32 "
                         f"tensor, got {x.dtype} {tuple(x.shape)} "
                         f"contiguous={x.is_contiguous()}")
    n, c, h, w = x.shape
    if size < 1 or size % 2 == 0:
        raise ValueError(f"blur_kernel: needs an odd size, got size={size}")
    if n * c == 0 or h == 0 or w == 0:
        raise ValueError(f"blur_kernel: unsupported shape {tuple(x.shape)}")
    if not x.is_cuda:
        return depthwise_blur(x, size, sigma)
    if size != _KERNEL_SIZE:
        raise ValueError(f"blur_kernel: the CUDA kernel has {_KERNEL_SIZE} "
                         f"taps, got size={size}")
    out = torch.empty_like(x)
    dev = x.get_device()
    err = _build.entry("f101_blur5_f32")(
        x.data_ptr(), out.data_ptr(), n * c, h, w, _taps_c(size, sigma), dev,
        _build.current_stream(dev))
    _build.check(err, "f101_blur5_f32")
    blur_kernel.launches += 1
    return out


blur_kernel.launches = 0


class _Blur(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, size, sigma):
        ctx.size, ctx.sigma = size, sigma
        return blur_kernel(x, size, sigma)

    @staticmethod
    def backward(ctx, g):
        # linear and self-adjoint (symmetric taps, zero padding)
        return blur_kernel(g.contiguous(), ctx.size, ctx.sigma), None, None


def blur(x: torch.Tensor, size: int = 5, sigma: float = 1.0) -> torch.Tensor:
    """Differentiable depthwise Gaussian blur of NCHW float32 ``x``."""
    return _Blur.apply(x, size, sigma)


def depthwise_blur_fast(x: torch.Tensor, size: int = 5,
                        sigma: float = 1.0) -> torch.Tensor:
    """Same function as :func:`~food101_sr_tpu_torch.ops.gaussian.
    depthwise_blur`, through K1: computed in float32, returned in
    ``x.dtype``."""
    return blur(x.float().contiguous(), size, sigma).to(x.dtype)
