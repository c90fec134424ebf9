"""Image sources (counterpart of ``food101_sr_tpu/data/sources.py``).

Both return uint8 (H, W, 3) numpy arrays where the JAX package's return
PIL images (the port has no PIL); the pixels are the same.

``Food101Source`` reads the standard Food-101 on-disk layout,
``root/food-101/images/<class>/<id>.jpg`` with the split lists in
``meta/train.txt`` / ``meta/test.txt`` (or the ``.json`` variants), and
decodes with the port's own JPEG codec (``native``). It never touches the
network: provisioning the dataset is a deployment concern.

``SyntheticSource`` makes deterministic procedural images for tests,
benchmarks and smoke runs: the same bytes as the JAX package's source.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Sequence

import numpy as np

from ..native import decode_image


class Food101Source:
    def __init__(self, root: str = "./data", split: str = "train"):
        base = os.path.join(root, "food-101")
        meta_txt = os.path.join(base, "meta", f"{split}.txt")
        meta_json = os.path.join(base, "meta", f"{split}.json")
        images = os.path.join(base, "images")
        if os.path.exists(meta_txt):
            with open(meta_txt) as f:
                rel = [line.strip() for line in f if line.strip()]
        elif os.path.exists(meta_json):
            with open(meta_json) as f:
                payload = json.load(f)
            rel = [p for paths in payload.values() for p in paths]
        else:
            raise FileNotFoundError(
                f"Food-101 metadata not found under {base}/meta — provision "
                f"the dataset (e.g. `dvc pull` / bucket sync) first."
            )
        self.paths = [os.path.join(images, r + ".jpg") for r in sorted(rel)]

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i: int) -> np.ndarray:
        return decode_image(self.bytes_at(i))

    def bytes_at(self, i: int) -> bytes:
        """The file's raw bytes: the loader decodes only the crop region
        from them (``data.pipeline.load_sample``)."""
        with open(self.paths[i], "rb") as f:
            return f.read()

    def fingerprint(self) -> str:
        """Stable identity of the split: its file list (the JAX package's
        string)."""
        h = hashlib.sha1()
        for p in self.paths:
            h.update(p.encode())
        return f"food101:{len(self.paths)}:{h.hexdigest()[:16]}"


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

    def fingerprint(self) -> str:
        return f"synthetic:{self.n}:{self.seed}:{tuple(self.sizes)}"

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
