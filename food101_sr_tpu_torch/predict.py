"""Offline bulk super-resolution CLI, directory in, directory out
(counterpart of the JAX package's ``predict.py``, with its flags).

    python -m food101_sr_tpu_torch.predict photos/ --out_dir sr_out \\
        --architecture auto --checkpoint w/attentionsr_best.pth
    python -m food101_sr_tpu_torch.predict "shots/*.png" --out_dir out \\
        --tta --format jpeg

The same engine as the HTTP server (:class:`~food101_sr_tpu_torch.serving.
SRServer`: checkpoint or seeded weights, fixed-shape device batches, exact
halo tiling for large images, optional x8 self-ensemble) without the HTTP
layer: a pool of submitter threads keeps the micro-batcher full, so
same-bucket images coalesce into device batches as concurrent requests
would. Images are read and written with the port's codecs (``native``:
PNG and JPEG, neither needing a library); a file that does not decode is
a counted failure, reported by name on stderr.

Prints one JSON summary line (``n_images``, ``failed``, ``wall_s``,
``images_per_s``, ...). Exits 1 when every image failed, or with
``--strict`` when any did.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from . import native
from .serving import SRServer

EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}


def collect_inputs(patterns):
    """(paths, empty_patterns): every input that matched nothing is
    reported, since silently dropping a typoed directory while other
    inputs match would let a run claim success on part of the request."""
    paths, empty = [], []
    for pat in patterns:
        if os.path.isdir(pat):
            hits = []
            for root, _, files in os.walk(pat):
                hits.extend(os.path.join(root, f) for f in files
                            if os.path.splitext(f)[1].lower() in EXTS)
        else:
            hits = glob.glob(pat)
            if not hits and os.path.splitext(pat)[1].lower() in EXTS:
                hits = [pat]  # let the read below report the miss
        if not hits:
            empty.append(pat)
        paths.extend(hits)
    return sorted(dict.fromkeys(paths)), empty  # stable order, deduped


def output_names(paths, suffix, ext):
    """Collision-free output filename per input: recursive walks can
    yield duplicate stems (a/cat.png, b/cat.png), so duplicates get _2,
    _3, ... in input order instead of overwriting each other."""
    names, used = {}, set()
    for path in paths:
        stem = os.path.splitext(os.path.basename(path))[0]
        name, n = stem + suffix + ext, 2
        while name in used:
            name = f"{stem}_{n}{suffix}{ext}"
            n += 1
        used.add(name)
        names[path] = name
    return names


def build_parser() -> argparse.ArgumentParser:
    """The CLI's flags: the JAX ``predict.py``'s, plus ``--device``."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("inputs", nargs="+",
                   help="image files, directories (recursed), or globs")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--architecture", default="AttentionSR",
                   help="registry name, or 'auto' to infer from --checkpoint")
    p.add_argument("--checkpoint", default=None,
                   help="the port's torch checkpoint file; none = seeded "
                        "random weights")
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--tile", type=int, default=64)
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--concurrency", type=int, default=8,
                   help="submitter threads (same-bucket images coalesce "
                        "into one device batch, as in the server)")
    p.add_argument("--tta", action="store_true",
                   help="x8 geometric self-ensemble (quality mode)")
    p.add_argument("--format", default="png", choices=["png", "jpeg"])
    p.add_argument("--jpeg_quality", type=int, default=92)
    p.add_argument("--suffix", default="_x{scale}",
                   help="appended to each stem; {scale} is substituted")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--quantize", default="", choices=["", "int8", "int8_dot"],
                   help="dynamic-int8 body convs (see the server's "
                        "--quantize)")
    p.add_argument("--warmup", action="store_true",
                   help="run each shape bucket once before timing")
    p.add_argument("--strict", action="store_true",
                   help="exit 1 if ANY image fails (default: per-file "
                        "failure isolation: exit 0 with a nonzero 'failed' "
                        "count in the JSON summary unless every image "
                        "failed)")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda; cpu for tests)")
    return p


def main(argv=None) -> None:
    p = build_parser()
    args = p.parse_args(argv)

    paths, empty = collect_inputs(args.inputs)
    if empty:
        p.error(f"these inputs matched no images: {empty!r}")
    if not paths:
        p.error(f"no images found under {args.inputs!r}")
    os.makedirs(args.out_dir, exist_ok=True)

    server = SRServer(args.architecture, checkpoint=args.checkpoint,
                      scale=args.scale, tile=args.tile,
                      max_batch=args.max_batch, dtype=getattr(torch,
                                                              args.dtype),
                      tta=args.tta, device=args.device,
                      quantize=args.quantize)
    try:
        if args.warmup:
            server.warmup()
        suffix = args.suffix.format(scale=server.scale)
        ext = ".png" if args.format == "png" else ".jpg"
        names = output_names(paths, suffix, ext)

        def run_one(path):
            try:
                with open(path, "rb") as f:
                    img = native.decode_image(f.read())
                out = server.upscale(img)
                payload = (native.encode_png_rgb8(out, level=1)
                           if args.format == "png" else
                           native.encode_jpeg_rgb8(out, args.jpeg_quality))
                with open(os.path.join(args.out_dir, names[path]), "wb") as f:
                    f.write(payload)
                return path, None
            except Exception as e:  # noqa: BLE001 - one bad file must not sink the batch
                return path, f"{type(e).__name__}: {e}"

        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=max(1, args.concurrency)) as pool:
            results = list(pool.map(run_one, paths))
        wall = time.perf_counter() - t0
    finally:
        server.close()

    failures = [(p_, err) for p_, err in results if err]
    for path, err in failures:
        print(f"FAILED {path}: {err}", file=sys.stderr)
    n_ok = len(results) - len(failures)
    print(json.dumps({
        "n_images": n_ok,
        "failed": len(failures),
        "wall_s": round(wall, 3),
        "images_per_s": round(n_ok / wall, 2) if wall > 0 else None,
        "out_dir": args.out_dir,
        "architecture": server.architecture,
        "scale": server.scale,
        "tta": bool(args.tta),
        "device": str(server.device),
    }), flush=True)
    if failures and (args.strict or not n_ok):
        sys.exit(1)


if __name__ == "__main__":
    main()
