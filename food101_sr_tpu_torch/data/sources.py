"""Image sources (counterpart of ``food101_sr_tpu/data/sources.py``).

``SyntheticSource`` makes deterministic procedural images for tests,
benchmarks and smoke runs: the same bytes as the JAX package's source, as
a uint8 (H, W, 3) numpy array instead of a PIL image (the port has no
PIL). ``Food101Source`` and its JPEG region decoder come with the port's
own native decoder (ROADMAP item 9a).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


class SyntheticSource:
    """Deterministic procedural RGB images with SR-relevant structure
    (smooth gradients + hard edges + texture) in a range of sizes."""

    def __init__(
        self,
        n: int = 256,
        sizes: Sequence[tuple[int, int]] = ((240, 320), (512, 384), (160, 200), (256, 256)),
        seed: int = 0,
    ):
        self.n = n
        self.sizes = sizes
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, i: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 1_000_003 + i)
        h, w = self.sizes[i % len(self.sizes)]
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        img = np.zeros((h, w, 3), np.float32)
        # smooth gradient base
        fx, fy = rng.uniform(0.5, 3.0, 2)
        ph = rng.uniform(0, 2 * np.pi, 3)
        for c in range(3):
            img[..., c] = 0.5 + 0.3 * np.sin(
                2 * np.pi * (fx * xx / w + fy * yy / h) + ph[c]
            )
        # hard-edged rectangles (SR cares about edges)
        for _ in range(6):
            y0, x0 = rng.integers(0, h - 8), rng.integers(0, w - 8)
            dy, dx = rng.integers(8, h // 3), rng.integers(8, w // 3)
            img[y0 : y0 + dy, x0 : x0 + dx] = rng.uniform(0, 1, 3)
        # fine texture
        img += rng.normal(0, 0.03, img.shape)
        return np.clip(img * 255.0, 0, 255).astype(np.uint8)
