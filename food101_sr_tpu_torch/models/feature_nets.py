"""Frozen feature network for LPIPS: the AlexNet trunk (counterpart of
``AlexNetFeatures`` and its loaders in
``food101_sr_tpu/models/feature_nets.py``). VGG19 and the perceptual loss
come with the GAN slice of the port.

The weights load from ``{weights_dir}/alexnet_features.npz`` (flat
``conv_{i}/kernel`` HWIO and ``conv_{i}/bias`` arrays, the file
``tools/convert_torch_weights.py`` writes for the JAX package) and the
LPIPS heads from ``lpips_alex_heads.npz`` (``lin_{i}``, one weight per
channel), read with numpy. Without the files the net falls back, with a
warning, to a seeded lecun-normal init (flax ``nn.Conv``'s default
distribution, not its bits) and uniform heads, and says so through
``pretrained=False``.
"""
from __future__ import annotations

import math
import os
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..convert import alexnet_from_jax
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
def _seeded_init(net: AlexNetFeatures, seed: int) -> None:
    gen = torch.Generator().manual_seed(seed)
    for m in net.children():
        fan_in = m.weight[0].numel()
        m.weight.copy_(_trunc_normal(m.weight.shape, math.sqrt(1.0 / fan_in),
                                     gen))
        m.bias.zero_()


def load_alexnet(weights_dir: str | None = None,
                 seed: int = 1234) -> tuple[AlexNetFeatures, bool]:
    """(net on the CPU in eval mode, pretrained?) from
    ``{weights_dir}/alexnet_features.npz``, else the seeded init with a
    warning."""
    net = AlexNetFeatures()
    path = os.path.join(weights_dir or DEFAULT_WEIGHTS_DIR,
                        "alexnet_features.npz")
    if os.path.exists(path):
        with np.load(path) as npz:
            want = {f"conv_{i}/{k}" for i in range(len(_ALEX_CONVS))
                    for k in ("kernel", "bias")}
            if set(npz.files) != want:
                raise ValueError(f"{path}: arrays {sorted(npz.files)} != "
                                 f"{sorted(want)}")
            tree: dict = {}
            for key in npz.files:
                conv, leaf = key.split("/")
                tree.setdefault(conv, {})[leaf] = npz[key]
            net.load_state_dict(alexnet_from_jax(tree), strict=True)
        return net.eval(), True
    warnings.warn(f"Pretrained weights not found at {path}; falling back to "
                  "a fixed-seed random init.", stacklevel=2)
    _seeded_init(net, seed)
    return net.eval(), False


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
