"""NLPD loss (counterpart of ``food101_sr_tpu/losses/nlpd.py``).

4-level Laplacian pyramid: depthwise 5x5 Gaussian blur (sigma 1, zero
padding; kernel K1 on CUDA), stride-2 subsample, bilinear upsample back
(``align_corners=False``), difference. Loss = alpha * MAE +
(1 - alpha) * sum_i mean|dL_i|, alpha = 0.7. Images are NCHW.
``nlpd_loss_train`` is JAX's training-grade variant (a bf16 pyramid).
"""
from __future__ import annotations

import torch

from ..ops.pallas_blur import depthwise_blur_fast
from ..ops.resize import resize_bilinear_torch


def laplacian_pyramid(img: torch.Tensor, n_levels: int = 4,
                      compute_dtype: torch.dtype = torch.float32) -> list:
    """Per-level difference images (NCHW); the upsample's products run in
    ``compute_dtype`` (bf16 in the training-grade loss)."""
    pyramid = []
    current = img
    for _ in range(n_levels):
        down = depthwise_blur_fast(current, size=5, sigma=1.0)[:, :, ::2, ::2]
        up = resize_bilinear_torch(down, current.shape[2], current.shape[3],
                                   compute_dtype=compute_dtype)
        pyramid.append(current - up)
        current = down
    return pyramid


def nlpd_loss(pred: torch.Tensor, target: torch.Tensor, n_levels: int = 4,
              alpha: float = 0.7) -> torch.Tensor:
    """For inputs of one dtype, one pyramid over ``cat([pred, target])``,
    split at each level: every plane is blurred as in two separate
    pyramids, with half the launches (4 of K1 for 4 levels, and of each
    other pyramid op).

    A bf16 ``pred`` against a float32 ``target`` (a bf16 training step)
    gets a pyramid of its own, in bf16 between the ops as JAX's is (the
    blur and the resize compute in float32 and return the input's dtype),
    so 8 K1 launches forward; ``torch.cat`` would promote it to float32
    and drop those roundings. The differences and the MAE promote to
    float32 and the level means accumulate there, as in JAX."""
    loss_mae = torch.mean(torch.abs(pred - target))
    if pred.dtype != target.dtype:
        pairs = zip(laplacian_pyramid(pred, n_levels),
                    laplacian_pyramid(target, n_levels))
    else:
        n = pred.shape[0]
        pairs = ((lv[:n], lv[n:]) for lv in
                 laplacian_pyramid(torch.cat([pred, target]), n_levels))
    loss_nlpd = sum(torch.mean(torch.abs(p - t)) for p, t in pairs)
    return alpha * loss_mae + (1.0 - alpha) * loss_nlpd


def nlpd_loss_train(pred: torch.Tensor, target: torch.Tensor,
                    n_levels: int = 4, alpha: float = 0.7) -> torch.Tensor:
    """Training-grade NLPD (JAX's ``nlpd_loss_train``): the MAE term in
    the inputs' dtype; the pyramid on bf16 copies of pred and target,
    its upsample products in bf16 and its blur through K1 in float32 on
    the bf16 values, returned in bf16 (JAX's ``depthwise_blur_fast``
    casts alike); the level means of the bf16 differences accumulated in
    float32. One pyramid over ``cat([pred, target])``: 4 K1 launches
    forward. JAX measured no gain from it on the TPU and its train loop
    does not use it; neither does the port's."""
    loss_mae = torch.mean(torch.abs(pred - target))
    n = pred.shape[0]
    both = torch.cat([pred.to(torch.bfloat16), target.to(torch.bfloat16)])
    loss_nlpd = sum(torch.mean(torch.abs(lv[:n] - lv[n:]).float())
                    for lv in laplacian_pyramid(both, n_levels,
                                                torch.bfloat16))
    return alpha * loss_mae + (1.0 - alpha) * loss_nlpd
