"""VGG19 perceptual loss (counterpart of
``food101_sr_tpu/losses/perceptual.py``): the MSE between the frozen
VGG19 conv5_4 features of prediction and target. The net's parameters do
not require a gradient, so they stay out of every optimizer and
checkpoint; the target's features are computed without a graph. As in
the JAX package the net has no compute dtype of its own: a bf16
prediction meets its float32 weights and is promoted to float32."""
from __future__ import annotations

import torch

from ..models.feature_nets import load_vgg19


class PerceptualLoss:
    """``loss(pred, target) -> scalar`` on (N, 3, H, W) images in [0, 1],
    the net on ``device`` (channels-last there); ``pretrained`` says
    whether ``{weights_dir}/vgg19_features.npz`` was found (else the
    seeded fallback, with a warning)."""

    def __init__(self, weights_dir: str | None = None,
                 device: str | torch.device = "cuda"):
        net, self.pretrained = load_vgg19(weights_dir)
        self.net = net.requires_grad_(False).to(
            device, memory_format=torch.channels_last)

    def __call__(self, pred: torch.Tensor,
                 target: torch.Tensor) -> torch.Tensor:
        fp = self.net(pred.float())
        with torch.no_grad():
            ft = self.net(target.float())
        return torch.mean((fp - ft) ** 2)
