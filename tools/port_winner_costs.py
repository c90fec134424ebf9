#!/usr/bin/env python3
"""The bf16 and int8 PSNR costs of the port's servers on the committed
winners, beside the JAX package's from their goldens.

    python3 tools/port_winner_costs.py [--winners attentionsr_gan,...] \\
        [--device cpu|cuda] [--cudnn_bias] [--threads N]

For each winner of ``chip_smoke.WINNERS`` named (all by default): the
port's float32, bfloat16 and bfloat16 ``--quantize int8`` servers
(``SRServer("auto")`` on its packed weights file) on the goldens' four
small LR inputs; each server's cost, the mean over the inputs of the
float32 PSNR less its own against the HR (as ``chip_smoke.py``'s winner
phase measures it), beside JAX's cost from the goldens, and the int8
outputs' SNR against the float32 ones. ``--cudnn_bias`` adds each bf16
conv's bias after the sum, as cuDNN (and JAX's ``y + b``) does, where
the CPU's oneDNN adds it inside: on the CPU the costs then read as the
card's. Prints one JSON line per winner.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def cudnn_bias() -> None:
    """Route bf16 convs through a bias-less conv plus the bias."""
    conv = torch.nn.functional.conv2d

    def conv2d(x, w, b=None, *a, **k):
        if b is not None and x.dtype == torch.bfloat16:
            return conv(x, w, None, *a, **k) + b.view(1, -1, 1, 1)
        return conv(x, w, b, *a, **k)

    torch.nn.functional.conv2d = conv2d


def costs(name: str, device: str) -> dict:
    from food101_sr_tpu_torch.serving import SRServer

    spec = chip_smoke.WINNERS[name]
    lrs, _, hrs, gold = chip_smoke._winner_goldens(spec)
    n = chip_smoke.WINNER_SMALL
    asset = os.path.join(chip_smoke.ASSETS, f"winner_{name}.f101w")
    out = {}
    for mode, dtype, q in (("f32", torch.float32, ""),
                           ("bf16", torch.bfloat16, ""),
                           ("int8", torch.bfloat16, "int8")):
        srv = SRServer("auto", checkpoint=asset, dtype=dtype, quantize=q,
                       device=device)
        try:
            with cf.ThreadPoolExecutor(n) as pool:
                out[mode] = list(pool.map(srv.upscale, lrs[:n]))
        finally:
            srv.close()
    psnr = {m: np.array([chip_smoke._psnr_u8(y, h)
                         for y, h in zip(ys, hrs)]) for m, ys in out.items()}
    jax_f32 = np.array([chip_smoke._psnr_u8(s, h) for s, h in
                        zip(chip_smoke._winner_goldens(spec)[1], hrs)])
    ref = np.concatenate([x.ravel() for x in out["f32"]]).astype(np.float64)
    q8 = np.concatenate([x.ravel() for x in out["int8"]]).astype(np.float64)
    res = {"winner": name}
    for m in ("bf16", "int8"):
        res[f"{m}_cost_db"] = float(np.mean(psnr["f32"] - psnr[m]))
        res[f"jax_{m}_cost_db"] = float(np.mean(jax_f32 - gold[f"psnr_{m}"]))
    res["int8_snr_db"] = float(10 * np.log10(np.mean(ref * ref)
                                             / np.mean((q8 - ref) ** 2)))
    res["jax_int8_snr_db"] = float(gold["snr_int8"])
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--winners", default=",".join(chip_smoke.WINNERS))
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    p.add_argument("--cudnn_bias", action="store_true")
    p.add_argument("--threads", type=int, default=0)
    a = p.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device (use --device cpu)", file=sys.stderr)
        return 1
    if a.threads:
        torch.set_num_threads(a.threads)
    if a.cudnn_bias:
        cudnn_bias()
    for name in a.winners.split(","):
        print(json.dumps(costs(name, a.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
