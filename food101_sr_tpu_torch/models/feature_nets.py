"""Frozen feature networks (counterpart of
``food101_sr_tpu/models/feature_nets.py``): VGG19 through conv5_4 for the
perceptual loss, and the AlexNet trunk for LPIPS.

The weights load from ``{weights_dir}/vgg19_features.npz`` and
``alexnet_features.npz`` (flat ``conv_{i}/kernel`` HWIO and
``conv_{i}/bias`` arrays, the files ``tools/convert_torch_weights.py``
writes for the JAX package) and the LPIPS heads from
``lpips_alex_heads.npz`` (``lin_{i}``, one weight per channel), read with
numpy. Without the files a net falls back, with a warning, to a seeded
lecun-normal init (flax ``nn.Conv``'s default distribution, not its bits)
and uniform heads, and says so through ``pretrained=False``.
"""
from __future__ import annotations

import math
import os
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..convert import alexnet_from_jax, vgg19_from_jax
from .layers import _trunc_normal

DEFAULT_WEIGHTS_DIR = os.environ.get("FOOD101_SR_WEIGHTS", "weights")

# LPIPS input normalization (the lpips package's ScalingLayer; inputs in
# [-1, 1]) and the channel widths of the five taps.
LPIPS_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
LPIPS_SCALE = np.array([0.458, 0.448, 0.450], np.float32)
LPIPS_TAP_CHANNELS = (64, 192, 384, 256, 256)

# (in, out, kernel, stride, padding) of torchvision AlexNet's five convs
_ALEX_CONVS = ((3, 64, 11, 4, 2), (64, 192, 5, 1, 2), (192, 384, 3, 1, 1),
               (384, 256, 3, 1, 1), (256, 256, 3, 1, 1))


# VGG19 configuration 'E' through conv5_4 (torchvision's features[:35]):
# (channels, convs) per block, a 2x2 max-pool between blocks
_VGG19_BLOCKS = ((64, 2), (128, 2), (256, 4), (512, 4), (512, 4))


class VGG19Features(nn.Module):
    """torchvision ``vgg19().features[:35]``, NCHW: 16 3x3 convs with a
    ReLU after each but the last (conv5_4), max-pool 2/2 between blocks.
    No ImageNet normalization: the perceptual loss feeds [0, 1] images, as
    the reference does."""

    def __init__(self):
        super().__init__()
        cin, i = 3, 0
        for cout, n in _VGG19_BLOCKS:
            for _ in range(n):
                self.add_module(f"conv_{i}", nn.Conv2d(cin, cout, 3, 1, 1))
                cin, i = cout, i + 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        i = 0
        for b, (_, n) in enumerate(_VGG19_BLOCKS):
            if b:
                x = F.max_pool2d(x, 2, 2)
            for _ in range(n):
                x = getattr(self, f"conv_{i}")(x)
                i += 1
                if i < 16:
                    x = F.relu(x)
        return x


class AlexNetFeatures(nn.Module):
    """torchvision AlexNet ``features`` trunk, NCHW: conv 11x11/4 ->
    max-pool 3/2 -> conv 5x5 -> max-pool 3/2 -> three 3x3 convs, returning
    the ReLU after each conv (the five LPIPS taps)."""

    def __init__(self):
        super().__init__()
        for i, (cin, cout, k, s, p) in enumerate(_ALEX_CONVS):
            self.add_module(f"conv_{i}", nn.Conv2d(cin, cout, k, s, p))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        taps = []
        for i in range(len(_ALEX_CONVS)):
            if i in (1, 2):
                x = F.max_pool2d(x, 3, 2)
            x = F.relu(getattr(self, f"conv_{i}")(x))
            taps.append(x)
        return taps


@torch.no_grad()
def _seeded_init(net: nn.Module, seed: int) -> None:
    gen = torch.Generator().manual_seed(seed)
    for m in net.children():
        fan_in = m.weight[0].numel()
        m.weight.copy_(_trunc_normal(m.weight.shape, math.sqrt(1.0 / fan_in),
                                     gen))
        m.bias.zero_()


def _load_convs(net: nn.Module, npz_name: str, from_jax,
                weights_dir: str | None, seed: int) -> tuple[nn.Module, bool]:
    """(``net`` on the CPU in eval mode, pretrained?): its ``conv_{i}``
    weights from ``{weights_dir}/{npz_name}``, else the seeded init with a
    warning."""
    path = os.path.join(weights_dir or DEFAULT_WEIGHTS_DIR, npz_name)
    if os.path.exists(path):
        with np.load(path) as npz:
            want = {f"{name}/{k}" for name, _ in net.named_children()
                    for k in ("kernel", "bias")}
            if set(npz.files) != want:
                raise ValueError(f"{path}: arrays {sorted(npz.files)} != "
                                 f"{sorted(want)}")
            tree: dict = {}
            for key in npz.files:
                conv, leaf = key.split("/")
                tree.setdefault(conv, {})[leaf] = npz[key]
            net.load_state_dict(from_jax(tree), strict=True)
        return net.eval(), True
    warnings.warn(f"Pretrained weights not found at {path}; falling back to "
                  "a fixed-seed random init.", stacklevel=3)
    _seeded_init(net, seed)
    return net.eval(), False


def load_alexnet(weights_dir: str | None = None,
                 seed: int = 1234) -> tuple[AlexNetFeatures, bool]:
    """(net on the CPU in eval mode, pretrained?) from
    ``{weights_dir}/alexnet_features.npz``, else the seeded init with a
    warning."""
    return _load_convs(AlexNetFeatures(), "alexnet_features.npz",
                       alexnet_from_jax, weights_dir, seed)


def load_vgg19(weights_dir: str | None = None,
               seed: int = 1234) -> tuple[VGG19Features, bool]:
    """(net on the CPU in eval mode, pretrained?) from
    ``{weights_dir}/vgg19_features.npz``, else the seeded init with a
    warning. The file is not committed (``weights/MANIFEST.json``)."""
    return _load_convs(VGG19Features(), "vgg19_features.npz",
                       vgg19_from_jax, weights_dir, seed)


def load_lpips_heads(weights_dir: str | None = None
                     ) -> tuple[list[torch.Tensor], bool]:
    """Per-tap non-negative head weights ``[C_i]`` from
    ``{weights_dir}/lpips_alex_heads.npz``, else uniform heads (1/C)
    with a warning; and whether they were loaded."""
    path = os.path.join(weights_dir or DEFAULT_WEIGHTS_DIR,
                        "lpips_alex_heads.npz")
    if os.path.exists(path):
        with np.load(path) as npz:
            heads = [torch.tensor(np.asarray(npz[f"lin_{i}"], np.float32))
                     for i in range(len(LPIPS_TAP_CHANNELS))
                     if f"lin_{i}" in npz]
        shapes = tuple(tuple(h.shape) for h in heads)
        if shapes != tuple((c,) for c in LPIPS_TAP_CHANNELS):
            raise ValueError(f"{path}: head shapes {shapes} != "
                             f"{LPIPS_TAP_CHANNELS}")
        return heads, True
    warnings.warn(f"LPIPS head weights not found at {path}; using uniform "
                  "heads.", stacklevel=2)
    return [torch.full((c,), 1.0 / c) for c in LPIPS_TAP_CHANNELS], False
