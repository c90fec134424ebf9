#!/usr/bin/env python3
"""Differential sweeps of the port's TIFF decoder against PIL (the JAX
server's decoder), on the CPU: where does ``native.decode_image`` answer
otherwise than ``Image.open(...).convert("RGB")``?

    python3 tools/tiff_differential.py [--what cuts,flips,dirs] \\
        [--seeds 21,22,...] [--files_per_seed 400] [--streams a,b,...]

* ``cuts``: CCITT T.4 (1-D and 2-D) files PIL writes, 8 seeded bilevel
  images (random and text-like, one strip and several), and ZSTD,
  raw-16, ThunderScan and old-style JPEG files (4 seeded images each,
  several strips), the first and the second strip's byte count cut at
  every length;
* ``flips``: 1-3 seeded bit flips in the strips of multi-strip T.4 1-D,
  T.4 2-D, T.6 and Modified Huffman files, 720 files a compression, and
  of the ZSTD (with and without predictor 2), raw-16, ThunderScan and
  old-style JPEG files (three layouts) and PIL's LZMA files, 240 files
  each;
* ``dirs``: 1-3 seeded bit flips of the committed TIFF streams
  (``food101_sr_tpu_torch/assets/jpeg/``; ``--streams`` names which, all
  by default), 70% of them in the first directory, ``--files_per_seed``
  files a seed.

A file differs in outcome where one side decodes and the other raises
(or answers 415), in pixels where both decode to other pixels. Prints one
JSON line per sweep: files, outcome and pixel differences, and the first
few differing cases. PIL is the yardstick; nothing here is the port's.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import struct
import sys

import numpy as np
from PIL import Image, TiffImagePlugin

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from food101_sr_tpu_torch import native  # noqa: E402
from tools.raster_writers import (ojpeg, pil_tiff, raw16,  # noqa: E402
                                  thunderscan, tiff_file, tiff_image)

JPEG_ASSETS = os.path.join(ROOT, "food101_sr_tpu_torch", "assets", "jpeg")
CUT_IMAGES = [(24, 45, "random", 6), (40, 61, "random", 8),
              (33, 97, "text", 11), (17, 13, "random", 17),
              (20, 200, "text", 5), (12, 30, "random", 4),
              (10, 40, "random", 10), (9, 77, "text", 9)]
FLIP_IMAGES = [(24, 45, "random", 6), (40, 61, "random", 8),
               (33, 97, "text", 11), (20, 200, "text", 5)]


def outcome(fn, data):
    """fn's pixels, "415", or "raises"."""
    try:
        return np.asarray(fn(data))
    except native.UnsupportedImage:
        return "415"
    except Exception:  # PIL raises OSError, ValueError, EOFError, ...
        return "raises"


def difference(data) -> str | None:
    """None where the port answers as PIL does, else "outcome" or
    "pixels"."""
    a = outcome(lambda d: Image.open(io.BytesIO(d)).convert("RGB"), data)
    b = outcome(native.decode_image, data)
    if isinstance(a, str) or isinstance(b, str):
        same = (a if isinstance(a, str) else "px") == \
            (b if isinstance(b, str) else "px")
        return None if same else "outcome"
    return None if a.shape == b.shape and np.array_equal(a, b) else "pixels"


def bilevel(h, w, seed, kind) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.random((h, w)) > 0.5
    img = np.zeros((h, w), bool)  # text-like: strokes and blocks
    for _ in range(max(1, h * w // 400)):
        y, x = rng.integers(0, h), rng.integers(0, w)
        img[y:y + rng.integers(1, 4), x:x + rng.integers(2, 40)] = True
    return img


def ccitt(h, w, seed, kind, rows, compression, info) -> bytes:
    im = Image.fromarray(bilevel(h, w, seed, kind).astype(np.uint8)
                         * 255).convert("1")
    old = TiffImagePlugin.STRIP_SIZE
    TiffImagePlugin.STRIP_SIZE = rows * ((w + 7) // 8)
    try:
        return pil_tiff(im, compression=compression, tiffinfo=info)
    finally:
        TiffImagePlugin.STRIP_SIZE = old


def photo(h, w, seed) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(xx / 5.0 + c) * 60 + np.cos(yy / 7.0 - c) * 50
                     + 128 for c in range(3)], 2)
    return np.clip(base + rng.normal(0, 10, (h, w, 3)), 0, 255).astype(
        np.uint8)


def codec_file(kind, seed) -> bytes:
    """A seeded 40x48 TIFF of several strips in one of the compressions
    libtiff decodes with its own code or libzstd's (or PIL's LZMA TIFF,
    one strip)."""
    img = photo(40, 48, seed)
    if kind == "lzma":  # PIL's writer: libtiff's delta + LZMA2 chain
        return pil_tiff(Image.fromarray(img), compression="lzma")
    if kind in ("zstd", "zstd_pred2"):
        return tiff_image(img, 8, 2, compression=50000, rows_per_strip=8,
                          predictor=2 if kind == "zstd_pred2" else 1)
    if kind == "raw16":
        bw = Image.fromarray(img).convert("1")
        return tiff_file({256: (4, (48,)), 257: (4, (40,)), 258: (3, (1,)),
                          259: (3, (32771,)), 262: (3, (1,)), 277: (3, (1,)),
                          278: (4, (8,))},
                         [raw16(bw.crop((0, y, 48, y + 8)))
                          for y in range(0, 40, 8)])
    if kind == "thunderscan":
        g = np.asarray(Image.fromarray(img).convert("L")) >> 4
        return tiff_file({256: (4, (48,)), 257: (4, (40,)), 258: (3, (4,)),
                          259: (3, (32809,)), 262: (3, (1,)), 277: (3, (1,)),
                          278: (4, (8,))},
                         [thunderscan(g[y:y + 8]) for y in range(0, 40, 8)])
    layout, sub = {"ojpeg_tables": ("tables", 2),
                   "ojpeg_header": ("jif_header", 1),
                   "ojpeg_stream": ("stream", 0)}[kind]
    return ojpeg(img, layout, sub, rows_per_strip=16 if sub == 2 else 8)


CODECS = ("zstd", "raw16", "thunderscan", "ojpeg_tables")
FLIP_CODECS = ("zstd", "zstd_pred2", "raw16", "thunderscan", "ojpeg_tables",
               "ojpeg_header", "ojpeg_stream", "lzma")


def codec_cuts(kind):
    for s in range(4):
        data = codec_file(kind, s)
        counts = Image.open(io.BytesIO(data)).tag_v2[279]
        packed = struct.pack(f"<{len(counts)}L", *counts)
        at = data.index(packed)
        for strip in (0, 1):
            for n in range(1, counts[strip] + 1):
                c = list(counts)
                c[strip] = n
                yield ([kind, s, strip, n],
                       data[:at] + struct.pack(f"<{len(c)}L", *c)
                       + data[at + len(packed):])


def codec_flips(kind):
    for s in range(4):
        data = codec_file(kind, s)
        t = Image.open(io.BytesIO(data)).tag_v2
        lo = min(t[273])
        hi = max(o + c for o, c in zip(t[273], t[279]))
        rng = np.random.default_rng(s)
        for k in range(60):
            b = bytearray(data)
            for _ in range(1 + k % 3):
                b[int(rng.integers(lo, hi))] ^= 1 << int(rng.integers(0, 8))
            yield [kind, s, k], bytes(b)


def tally(name, cases) -> dict:
    out = {"sweep": name, "files": 0, "outcome": 0, "pixels": 0,
           "first": []}
    for label, data in cases:
        out["files"] += 1
        d = difference(data)
        if d:
            out[d] += 1
            if len(out["first"]) < 8:
                out["first"].append([label, d])
    return out


def cuts(twod: bool):
    for h, w, kind, rows in CUT_IMAGES:
        for s in range(4):
            data = ccitt(h, w, s * 100 + h, kind, rows, "group3",
                         {292: 1} if twod else {})
            counts = Image.open(io.BytesIO(data)).tag_v2[279]
            packed = struct.pack(f"<{len(counts)}L", *counts)
            at = data.index(packed)
            for strip in (0, 1) if rows < h else (0,):
                for n in range(1, counts[strip] + 1):
                    c = list(counts)
                    c[strip] = n
                    yield ([h, w, s, strip, n],
                           data[:at] + struct.pack(f"<{len(c)}L", *c)
                           + data[at + len(packed):])


def flips(compression, info):
    for h, w, kind, rows in FLIP_IMAGES:
        for s in range(3):
            data = ccitt(h, w, s * 7 + h, kind, rows, compression, info)
            t = Image.open(io.BytesIO(data)).tag_v2
            lo = min(t[273])
            hi = max(o + c for o, c in zip(t[273], t[279]))
            rng = np.random.default_rng(s + h)
            for k in range(60):
                b = bytearray(data)
                for _ in range(1 + k % 3):
                    b[int(rng.integers(lo, hi))] ^= \
                        1 << int(rng.integers(0, 8))
                yield [h, w, s, k], bytes(b)


def dirs(seeds, per_seed, streams=None):
    with open(os.path.join(JPEG_ASSETS, "goldens.json")) as f:
        goldens = json.load(f)["streams"]
    names = sorted(n for n, g in goldens.items()
                   if g["file"].endswith(".tif")
                   and (streams is None or n in streams))
    for sd in seeds:
        rng = np.random.default_rng(sd)
        for k in range(per_seed):
            name = names[k % len(names)]
            with open(os.path.join(JPEG_ASSETS,
                                   goldens[name]["file"]), "rb") as f:
                b = bytearray(f.read())
            off = int.from_bytes(b[4:8],
                                 "little" if b[:2] == b"II" else "big")
            for _ in range(1 + int(rng.integers(0, 3))):
                if rng.random() < 0.7 and off < len(b):
                    i = int(rng.integers(off, min(len(b), off + 242)))
                else:
                    i = int(rng.integers(0, len(b)))
                b[i] ^= 1 << int(rng.integers(0, 8))
            yield [sd, k, name], bytes(b)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--what", default="cuts,flips,dirs")
    p.add_argument("--seeds", default="21,22,23,24,25,26,27,28")
    p.add_argument("--files_per_seed", type=int, default=400)
    p.add_argument("--streams", default=None,
                   help="the committed TIFF streams the dirs sweep flips")
    a = p.parse_args(argv)
    what = a.what.split(",")
    if "cuts" in what:
        for twod in (False, True):
            print(json.dumps(tally(f"T.4 {'2' if twod else '1'}-D cuts",
                                   cuts(twod))), flush=True)
        for kind in CODECS:
            print(json.dumps(tally(f"{kind} cuts", codec_cuts(kind))),
                  flush=True)
    if "flips" in what:
        for comp, info, name in (("group3", {}, "T.4 1-D"),
                                 ("group3", {292: 1}, "T.4 2-D"),
                                 ("group4", {}, "T.6"),
                                 ("tiff_ccitt", {}, "MH")):
            print(json.dumps(tally(f"{name} flips", flips(comp, info))),
                  flush=True)
        for kind in FLIP_CODECS:
            print(json.dumps(tally(f"{kind} flips", codec_flips(kind))),
                  flush=True)
    if "dirs" in what:
        seeds = [int(x) for x in a.seeds.split(",")]
        streams = a.streams.split(",") if a.streams else None
        print(json.dumps(tally("directory flips",
                               dirs(seeds, a.files_per_seed, streams))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
