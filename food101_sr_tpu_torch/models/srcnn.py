"""SRCNN, the pre-upsampling 3-layer CNN (counterpart of
``food101_sr_tpu/models/srcnn.py``).

A bicubic x``scale`` upsample first (``F.interpolate(mode="bicubic",
align_corners=False)``, the function the JAX package's ``upsample_bicubic``
reproduces), then relu(conv9x9(3->64)) -> relu(conv1x1(64->hidden)) ->
conv5x5(hidden->3) at HR resolution. Kaiming fan_out init. The JAX
``conv3`` may take the ``subpixel_conv2d`` route, an exact rewrite for the
TPU's lanes; the port runs the plain conv.

``compute_dtype`` runs the convs in that dtype on float32 weights (JAX's
``SRCNN(dtype=...)``): the upsample stays float32, the first conv casts,
and the output comes out in the compute dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv, set_compute_dtype


class SRCNN(nn.Module):
    """(N, 3, H, W) in, (N, 3, sH, sW) out; parameters ``conv1``,
    ``conv2``, ``conv3`` (the reference layout). Runs channels-last, as
    the other nets do. The bicubic upsample runs in float32 whatever the
    input's dtype."""

    memory_format = torch.channels_last

    def __init__(self, scale_factor: int = 4, hidden_dim: int = 64,
                 num_channels: int = 3,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.scale_factor = scale_factor
        self.conv1 = Conv(num_channels, 64, 9, fan="fan_out")
        self.conv2 = Conv(64, hidden_dim, 1, fan="fan_out")
        self.conv3 = Conv(hidden_dim, num_channels, 5, fan="fan_out")
        set_compute_dtype(self, compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous(memory_format=self.memory_format)
        h, w = x.shape[-2:]
        s = self.scale_factor
        up = F.interpolate(x.float(), size=(h * s, w * s), mode="bicubic",
                           align_corners=False).to(x.dtype)
        y = F.relu(self.conv1(up))
        y = F.relu(self.conv2(y))
        return self.conv3(y)
