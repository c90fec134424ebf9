"""Full-float32 numerics for measurement ops.

On the GPU, PyTorch runs float32 convolutions through cuDNN in TF32 by
default (about three decimal digits), which is too coarse for metrics:
SSIM's variance term cancels and goes above 1, as the JAX package records
for bf16 passes on the TPU. Measurement code (blur, resize, SSIM, NLPD)
runs inside :func:`full_fp32`.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_fp32():
    """Disable TF32 for cuDNN convolutions and CUDA matmuls in the block."""
    conv, mm = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm
