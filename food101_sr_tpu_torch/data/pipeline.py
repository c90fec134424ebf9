"""Device-side batch preparation (counterpart of ``prepare_batch`` in
``food101_sr_tpu/data/pipeline.py``; the loader comes with the training
runtime, ROADMAP item 9). Only uint8 crops cross to the device; ToTensor
and the degradation run there."""
from __future__ import annotations

import torch

from ..ops.resize import degrade_bicubic


def prepare_batch(hr_u8: torch.Tensor, scale_factor: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8 NHWC HR batch -> (lr, hr) float32 in [0, 1], (N, C, H, W).
    ``hr`` is the NHWC bytes viewed as NCHW, so channels-last in memory;
    ``lr`` is the antialiased bicubic ``1/scale_factor`` degradation."""
    hr = hr_u8.permute(0, 3, 1, 2).float() / 255.0
    return degrade_bicubic(hr, scale_factor), hr
