"""K2: global spatial mean (the SE-block squeeze), a CUDA kernel for Hopper
(counterpart of ``food101_sr_tpu/ops/spatial_mean.py``, whose Pallas
``_mean_kernel`` it replaces; the kernel is ``f101_plane_mean_{f32,bf16}``
in ``csrc/kernels.cu``).

``spatial_mean(x)`` is ``x.mean((2, 3))`` of an NCHW tensor, accumulated in
float32 and returned in ``x.dtype``. The JAX ``SEBlock`` keeps a plain
``jnp.mean`` because the Pallas kernel lost on the TPU; the port's
``SEBlock`` calls this kernel, and whether it stays there is for H100
measurements to decide (``PERF.md``).

The op is linear; its backward broadcasts ``g / (H*W)`` in plain PyTorch,
as the JAX VJP leaves it to XLA.
"""
from __future__ import annotations

import torch

from .. import _build

_ENTRY = {torch.float32: "f101_plane_mean_f32",
          torch.bfloat16: "f101_plane_mean_bf16"}


def spatial_mean_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K2."""
    return x.float().mean((2, 3)).to(x.dtype)


def mean_kernel(x: torch.Tensor) -> torch.Tensor:
    """Contiguous (N, C, H, W) -> (N, C) mean over H, W: kernel K2 on CUDA,
    the plain version on the CPU (same checks on both).
    ``mean_kernel.launches`` counts kernel launches."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mean_kernel: no kernel for device {x.device}")
    if x.dtype not in _ENTRY or x.dim() != 4 or not x.is_contiguous():
        raise ValueError("mean_kernel: needs a contiguous 4-D float32 or "
                         f"bfloat16 tensor, got {x.dtype} {tuple(x.shape)} "
                         f"contiguous={x.is_contiguous()}")
    if x.numel() == 0:
        raise ValueError(f"mean_kernel: empty tensor {tuple(x.shape)}")
    if x.device.type == "cpu":
        return spatial_mean_plain(x)
    n, c, h, w = x.shape
    out = torch.empty((n, c), dtype=x.dtype, device=x.device)
    err = getattr(_build.kernels(), _ENTRY[x.dtype])(
        x.data_ptr(), out.data_ptr(), n * c, h * w, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, _ENTRY[x.dtype])
    mean_kernel.launches += 1
    return out


mean_kernel.launches = 0


class _SpatialMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.shape = x.shape
        return mean_kernel(x)

    @staticmethod
    def backward(ctx, g):
        n, c, h, w = ctx.shape
        gx = (g.float() * (1.0 / (h * w))).to(g.dtype)
        return gx[:, :, None, None].expand(n, c, h, w)


def spatial_mean(x: torch.Tensor) -> torch.Tensor:
    """Differentiable ``x.mean((2, 3))`` of NCHW ``x`` with float32
    accumulation, in ``x.dtype``."""
    return _SpatialMean.apply(x)
