"""AOT-export the serving forward as self-contained ``torch.export``
programs (counterpart of the JAX package's ``tools/export_serving.py``).

Each program is ``SRServer.forward_u8`` (uint8 NHWC in, ToTensor, the
net, clip and 255-quantization, uint8 NHWC out) at one LR bucket, with
the weights inside, written by ``torch.export.save``. The SE blocks'
spatial mean appears in it as the registered op ``f101::spatial_mean``
(kernel K2 on CUDA), so a loader imports ``food101_sr_tpu_torch.ops`` and
no model code.

    python -m food101_sr_tpu_torch.export_serving --architecture SRCNN \\
        --out /tmp/aot --shapes 64x64,128x128 --batch 8 --check
    python -m food101_sr_tpu_torch.export_serving --architecture auto \\
        --checkpoint w/attentionsr_best.pth --out /tmp/aot --check

Artifact layout:
    <out>/manifest.json              arch/scale/dtype/buckets/hashes
    <out>/sr_<h>x<w>_b<batch>.pt2    torch.export.save of one bucket

Deploying:
    from food101_sr_tpu_torch.export_serving import load_bucket
    sr_u8 = load_bucket(path)        # on "cuda"; device="cpu" for CPU ones
    y = sr_u8(batch_u8)              # (B,H,W,3) uint8 -> (B,sH,sW,3)

A program always runs its ``batch`` rows: cuDNN picks its algorithms by
shape, and in bf16 two algorithms round differently, so the exported
shape is the server's device batch (``max_batch`` = ``--batch``). It
runs on the device it was exported for (``platforms`` in the manifest).

``--check`` re-reads every file, checks its sha256, loads the program and
holds it byte-equal to the live ``forward_u8`` on seeded uint8 input.
The last stdout line is a JSON summary.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np
import torch

KIND = "food101-sr-tpu serving AOT artifact"
IO = "uint8 NHWC in [B,H,W,3] -> uint8 NHWC [B,H*s,W*s,3]"
OPS_MODULE = "food101_sr_tpu_torch.ops"


def parse_shapes(text: str) -> list[tuple[int, int]]:
    """``"64x64,128x96"`` -> [(64, 64), (128, 96)]; ``SystemExit`` on an
    entry that is not HxW with positive sides, or on nothing at all."""
    out = []
    for part in text.split(","):
        part = part.strip().lower()
        if not part:
            continue
        try:
            h, w = (int(v) for v in part.split("x"))
        except ValueError:
            raise SystemExit(f"bad --shapes entry {part!r}: want HxW, e.g. 64x64")
        if h <= 0 or w <= 0:
            raise SystemExit(f"bad --shapes entry {part!r}: dims must be positive")
        out.append((h, w))
    if not out:
        raise SystemExit("--shapes parsed to nothing")
    return out


def load_bucket(path: str, device: str | torch.device = "cuda"):
    """The program saved at ``path`` as a callable from a (B, H, W, 3)
    uint8 batch (a numpy array, or a tensor on ``device``) to the (B, sH,
    sW, 3) uint8 result of the same kind. Imports the ops module (which
    registers ``f101::spatial_mean``) and nothing of the models or the
    server. Raises ``ValueError`` when the program was exported for
    another device."""
    import food101_sr_tpu_torch.ops  # noqa: F401  (registers the K2 op)

    device = torch.device(device)
    ep = torch.export.load(path)
    have = next(iter(ep.state_dict.values())).device  # where its weights are
    if have.type != device.type:
        raise ValueError(f"{path} was exported for {have.type}; export it "
                         f"again for {device.type}")
    module = ep.module()

    @torch.inference_mode()
    def call(x8):
        if isinstance(x8, np.ndarray):
            return module(torch.from_numpy(x8).to(device)).cpu().numpy()
        return module(x8)

    call.program = ep
    return call


class ServingProgram(torch.nn.Module):
    """``server.forward_u8`` as a module whose parameters are the served
    net's, so that an export keeps them as the program's weights."""

    def __init__(self, server):
        super().__init__()
        self.net = server.model
        self._forward = server.forward_u8

    def forward(self, x8: torch.Tensor) -> torch.Tensor:
        return self._forward(x8)


def export_bucket(server, h: int, w: int, batch: int):
    """``torch.export`` of ``server.forward_u8`` at (batch, h, w, 3)
    uint8 on the server's device. Warm the server's bucket first: the
    trace then finds the caches filled by real calls."""
    x8 = torch.zeros((batch, h, w, 3), dtype=torch.uint8, device=server.device)
    return torch.export.export(ServingProgram(server), (x8,))


def _sha256(path: str) -> tuple[str, int]:
    with open(path, "rb") as f:
        blob = f.read()
    return hashlib.sha256(blob).hexdigest(), len(blob)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--architecture", default="AttentionSR",
                   help="registry name, or 'auto' to infer from --checkpoint")
    p.add_argument("--checkpoint", default=None,
                   help="a torch checkpoint file of the port")
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--out", required=True, help="artifact directory")
    p.add_argument("--shapes", default="64x64",
                   help="comma-separated LR bucket shapes, e.g. 64x64,128x128")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--quantize", default="", choices=["", "int8", "int8_dot"])
    p.add_argument("--tta", action="store_true",
                   help="bake the x8 self-ensemble into the program")
    p.add_argument("--no_phase_tail", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="export for the CPU (tests); the card otherwise")
    p.add_argument("--check", action="store_true",
                   help="load every program and assert byte-exact "
                        "agreement with the live serving forward")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    shapes = parse_shapes(args.shapes)
    from .serving import SRServer  # the engine whose program is exported

    device = torch.device("cpu" if args.cpu else "cuda")
    server = SRServer(args.architecture, checkpoint=args.checkpoint,
                      scale=args.scale, device=device,
                      dtype=(torch.bfloat16 if args.dtype == "bfloat16"
                             else torch.float32),
                      tta=args.tta, quantize=args.quantize,
                      phase_tail=not args.no_phase_tail, max_batch=args.batch)
    try:
        return _export(args, shapes, server, device)
    finally:
        server.close()


def _export(args, shapes, server, device) -> dict:
    os.makedirs(args.out, exist_ok=True)
    n_params = (sum(p.numel() for p in server.model.parameters())
                + sum(b.numel() for b in server.model.buffers()
                      if b.is_floating_point()))
    server.warmup(shapes)
    buckets = []
    for h, w in shapes:
        name = f"sr_{h}x{w}_b{args.batch}.pt2"
        path = os.path.join(args.out, name)
        torch.export.save(export_bucket(server, h, w, args.batch), path)
        digest, nbytes = _sha256(path)
        buckets.append({
            "file": name,
            "lr_shape": [args.batch, h, w, 3],
            "sr_shape": [args.batch, h * server.scale, w * server.scale, 3],
            "bytes": nbytes,
            "sha256": digest,
            "platforms": [device.type],
        })
        print(f"exported {name}: {nbytes / 1e6:.2f} MB, platforms "
              f"{[device.type]}", file=sys.stderr)

    manifest = {
        "kind": KIND,
        "architecture": server.architecture,
        "scale": server.scale,
        "dtype": args.dtype,
        "quantize": args.quantize,
        "tta": bool(args.tta),
        "phase_tail": not args.no_phase_tail,
        "checkpoint": args.checkpoint,
        "n_params": n_params,
        "torch_version": torch.__version__,
        "ops_module": OPS_MODULE,
        "io": IO,
        "buckets": buckets,
    }
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)

    checked = 0
    if args.check:
        rng = np.random.default_rng(0)
        for b in buckets:
            path = os.path.join(args.out, b["file"])
            if _sha256(path) != (b["sha256"], b["bytes"]):
                raise SystemExit(f"CHECK FAILED for {b['file']}: the file "
                                 "changed after it was written")
            program = load_bucket(path, device)
            x = rng.integers(0, 256, b["lr_shape"], dtype=np.uint8)
            got = program(x)
            if list(got.shape) != b["sr_shape"]:
                raise SystemExit(f"CHECK FAILED for {b['file']}: shape "
                                 f"{got.shape}, manifest {b['sr_shape']}")
            want = server.forward_u8(torch.from_numpy(x).to(device)) \
                .cpu().numpy()
            if not np.array_equal(got, want):
                diff = np.abs(got.astype(int) - want.astype(int)).max()
                raise SystemExit(
                    f"CHECK FAILED for {b['file']}: the loaded program "
                    f"disagrees with the live serving forward (max abs "
                    f"diff {diff})")
            checked += 1
        print(f"check: {checked}/{len(buckets)} buckets byte-exact vs the "
              f"live serving forward", file=sys.stderr)

    summary = {"out": args.out, "architecture": server.architecture,
               "scale": server.scale, "buckets": len(buckets),
               "checked": checked,
               "total_mb": round(sum(b["bytes"] for b in buckets) / 1e6, 2)}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
