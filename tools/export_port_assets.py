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

For the port's JPEG codec it writes ``assets/jpeg/`` (``--what jpeg``),
under 500 KB:

- ``food-101/``: a mini Food-101 tree (``images/<class>/<id>.jpg``,
  ``meta/train.txt`` and ``meta/test.txt``) of 16 train and 4 test images
  made by ``tools/make_fake_food101.py``'s ``make_image`` and saved by PIL
  at that tool's quality 92; most have both sides at 200-280 px (the
  loader's region path at crop 200), two are smaller (its resize path);
- ``streams/``: one stream per decoder feature, written by PIL: 4:4:4,
  4:2:2, 4:2:0, grayscale, progressive, optimized Huffman, restart
  markers, EXIF, 16-bit DQT, odd sizes, and a CMYK stream the codec
  refuses;
- ``goldens.json``: sha256 digests (not pixels, to stay small) of the JAX
  package's ``decode_jpeg_rgb8`` of each stream; of its
  ``encode_jpeg_rgb8`` at q90 on a seeded 256x256 image and at q92 on a
  seeded 800x608 one (``chip_smoke.jpeg_test_image``); and of the first
  two batches of its ``SRDataLoader`` over the mini tree's train split
  (seed 0, crop 200, batch 8; train and eval).

    python tools/export_port_assets.py      # JAX_PLATFORMS=cpu is set here
    python tools/export_port_assets.py --what jpeg

The directory is not called ``weights``: files under any ``weights``
directory are kept out of the copy sent to the GPU host.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import shutil
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

from chip_smoke import jpeg_test_image, sha256  # noqa: E402
from food101_sr_tpu import native as jax_native  # noqa: E402
from food101_sr_tpu.data import Food101Source, SRDataLoader  # noqa: E402
from food101_sr_tpu.training import load_checkpoint  # noqa: E402
from tools.export_sr_checkpoint import export_state_dict  # noqa: E402
from tools.make_fake_food101 import CLASSES, make_image  # noqa: E402

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


# (h, w) of the mini tree's images: 16 train (two below the crop of 200),
# then 4 test
FOOD_SHAPES = [(212, 236), (240, 204), (200, 200), (226, 251), (150, 260),
               (205, 222), (263, 210), (231, 231), (201, 248), (230, 170),
               (244, 219), (209, 203), (218, 265), (257, 228), (203, 241),
               (236, 207), (224, 214), (210, 245), (248, 202), (216, 233)]
N_FOOD_TRAIN = 16
LOADER = dict(seed=0, crop_size=200, batch_size=8, batches=2)
ENCODE = [(256, 256, 90, 1), (608, 800, 92, 2)]  # h, w, quality, seed


def _pil_jpeg(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _streams() -> dict:
    """name -> JPEG bytes, one per decoder feature."""
    rng = np.random.default_rng(11)
    photo = Image.fromarray(make_image(rng, 72, 88))
    exif = Image.Exif()
    exif[0x010E] = "a plate of food"
    out = {
        "444": _pil_jpeg(photo, quality=90, subsampling=0),
        "422": _pil_jpeg(photo, quality=90, subsampling=1),
        "420": _pil_jpeg(photo, quality=90, subsampling=2),
        "gray": _pil_jpeg(photo.convert("L"), quality=90),
        "progressive": _pil_jpeg(photo, quality=85, progressive=True),
        "progressive_444": _pil_jpeg(photo, quality=85, progressive=True,
                                     subsampling=0),
        "optimized": _pil_jpeg(photo, quality=85, optimize=True),
        "restart": _pil_jpeg(photo, quality=85, restart_marker_blocks=2),
        "exif": _pil_jpeg(photo, quality=85, exif=exif.tobytes()),
        "dqt16": _pil_jpeg(photo, qtables=[list(range(200, 264)),
                                           [300] * 64]),
        "cmyk": _pil_jpeg(photo.convert("CMYK"), quality=85),
    }
    for h, w in ((1, 1), (13, 7), (97, 131)):
        out[f"odd_{h}x{w}"] = _pil_jpeg(
            Image.fromarray(make_image(rng, h, w)), quality=88)
    return out


def export_jpeg(out_dir: str) -> dict:
    """Write assets/jpeg/ (module docstring) and return its goldens."""
    root = os.path.join(out_dir, "jpeg")
    shutil.rmtree(root, ignore_errors=True)
    base = os.path.join(root, "food-101")
    os.makedirs(os.path.join(base, "meta"))
    os.makedirs(os.path.join(root, "streams"))
    rng = np.random.default_rng(0)
    rel = {"train": [], "test": []}
    for n, (h, w) in enumerate(FOOD_SHAPES):
        cls = CLASSES[n % len(CLASSES)]
        os.makedirs(os.path.join(base, "images", cls), exist_ok=True)
        name = f"{cls}/{1000000 + n}"
        Image.fromarray(make_image(rng, h, w)).save(
            os.path.join(base, "images", name + ".jpg"), quality=92)
        rel["train" if n < N_FOOD_TRAIN else "test"].append(name)
    for split, names in rel.items():
        with open(os.path.join(base, "meta", f"{split}.txt"), "w") as f:
            f.write("\n".join(names) + "\n")

    goldens = {"streams": {}, "encode": [], "loader": {}}
    for name, data in _streams().items():
        path = os.path.join(root, "streams", name + ".jpg")
        with open(path, "wb") as f:
            f.write(data)
        entry = {"file": f"streams/{name}.jpg"}
        if name == "cmyk":
            entry["refused"] = "CMYK"
        else:
            px = jax_native.decode_jpeg_rgb8(data)
            entry.update(shape=list(px.shape), sha256=sha256(px))
        goldens["streams"][name] = entry
    for h, w, q, seed in ENCODE:
        data = jax_native.encode_jpeg_rgb8(jpeg_test_image(h, w, seed), q)
        goldens["encode"].append({"h": h, "w": w, "quality": q, "seed": seed,
                                  "bytes": len(data), "sha256": sha256(data)})
    src = Food101Source(root, "train")
    goldens["loader"] = {**LOADER, "split": "train"}
    for mode, train in (("train", True), ("eval", False)):
        loader = SRDataLoader(src, crop_size=LOADER["crop_size"],
                              batch_size=LOADER["batch_size"], train=train,
                              seed=LOADER["seed"])
        loader.set_epoch(0)
        batches = [np.asarray(b, np.uint8) for b in loader]
        goldens["loader"][mode] = [sha256(b) for b in
                                   batches[:LOADER["batches"]]]
    with open(os.path.join(root, "goldens.json"), "w") as f:
        json.dump(goldens, f, indent=1)
        f.write("\n")
    return goldens


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--out_dir", default=ASSETS)
    p.add_argument("--what", default="all", choices=["all", "srcnn", "jpeg"])
    a = p.parse_args()
    jax.config.update("jax_platforms", "cpu")

    if a.what in ("all", "jpeg"):
        export_jpeg(a.out_dir)
        total = sum(os.path.getsize(os.path.join(d, f))
                    for d, _, fs in os.walk(os.path.join(a.out_dir, "jpeg"))
                    for f in fs)
        print(f"{os.path.join(a.out_dir, 'jpeg')}: {total:,} bytes")
    if a.what == "jpeg":
        return
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
