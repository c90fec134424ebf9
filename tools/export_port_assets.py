#!/usr/bin/env python
"""Export trained weights that the PyTorch port can read on a host without
JAX or Orbax, with goldens from the JAX package to hold them against.

Runs here, on the CPU, with the JAX package (the port never imports this
file). For the committed SRCNN winner (``weights/winner_srcnn_best``,
24,579 parameters) it writes, under ``food101_sr_tpu_torch/assets/``:

- ``winner_srcnn.pth``: the reference-layout state_dict
  (``tools/export_sr_checkpoint.py::export_state_dict``), float32, which
  loads with ``strict=True`` into the port's registry SRCNN;
- ``winner_srcnn_goldens.npz``: four seeded uint8 LR inputs (``lr_0``..
  ``lr_3``: three 32x32 and one 96x80, which takes the tiled path at the
  server's tile 64 and SRCNN's halo 8) and the JAX package's float32
  served outputs for them (``sr_0``..``sr_3``: ``serve.SRServer("auto",
  checkpoint, dtype=float32).upscale``).

    python tools/export_port_assets.py      # JAX_PLATFORMS=cpu is set here

The directory is not called ``weights``: files under any ``weights``
directory are kept out of the copy sent to the GPU host.
"""
from __future__ import annotations

import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

from food101_sr_tpu.training import load_checkpoint  # noqa: E402
from tools.export_sr_checkpoint import export_state_dict  # noqa: E402

CHECKPOINT = os.path.join(ROOT, "weights", "winner_srcnn_best")
ASSETS = os.path.join(ROOT, "food101_sr_tpu_torch", "assets")
LR_SHAPES = [(32, 32), (32, 32), (32, 32), (96, 80)]
SEED = 0


def golden_inputs(seed: int = SEED) -> list[np.ndarray]:
    """The seeded uint8 LR inputs, (h, w, 3) each."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), np.uint8) for h, w in LR_SHAPES]


def jax_served(inputs, checkpoint: str = CHECKPOINT) -> list[np.ndarray]:
    """The JAX package's float32 server's outputs for ``inputs``."""
    import serve

    server = serve.SRServer("auto", checkpoint, dtype=jnp.float32)
    return [np.asarray(server.upscale(Image.fromarray(x)), np.uint8)
            for x in inputs]


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--out_dir", default=ASSETS)
    a = p.parse_args()
    jax.config.update("jax_platforms", "cpu")

    sd, arch = export_state_dict(load_checkpoint(CHECKPOINT))
    if arch != "SRCNN":
        raise SystemExit(f"{CHECKPOINT} holds {arch}, not SRCNN")
    os.makedirs(a.out_dir, exist_ok=True)
    pth = os.path.join(a.out_dir, "winner_srcnn.pth")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}, pth)
    inputs = golden_inputs()
    outputs = jax_served(inputs)
    npz = os.path.join(a.out_dir, "winner_srcnn_goldens.npz")
    np.savez_compressed(npz, **{f"lr_{i}": x for i, x in enumerate(inputs)},
                        **{f"sr_{i}": y for i, y in enumerate(outputs)})
    for path in (pth, npz):
        print(f"{path}: {os.path.getsize(path):,} bytes")


if __name__ == "__main__":
    main()
