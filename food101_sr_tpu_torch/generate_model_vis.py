"""Model graph export (counterpart of the JAX package's root
``generate_model_vis.py``, which dumps each net's jaxpr and HLO).

    python -m food101_sr_tpu_torch.generate_model_vis --out runs/all_models_viz
    python -m food101_sr_tpu_torch.generate_model_vis --models AttentionSR --cpu

For each net (the registry generators at their sizes, in float32 eval
mode, and the Discriminator) this writes ``{out}/{name}/``:

* ``export_graph.txt``: the ``torch.export`` program of the forward at
  (1, 3, 50, 50) (the Discriminator at 200 px), the architecture graph in
  place of JAX's jaxpr. AttentionSR's SE squeezes show as the registered
  op ``f101::spatial_mean`` (kernel K2 on CUDA), one per block;
* ``flops.json``: the forward's floating point operations counted by
  ``torch.utils.flop_counter.FlopCounterMode`` while it runs on the
  device, in place of XLA's cost analysis: the total and the count per
  operator (a convolution counts 2 x its multiply-adds). ``--no-optimized``
  skips the count, as JAX's flag skips the compile.
"""
from __future__ import annotations

import argparse
import json
import os

import torch
from torch.utils.flop_counter import FlopCounterMode

from .models import Discriminator, build_model
from .models.registry import _REGISTRY

SCALE = 4
# (directory name, registry key or None for the Discriminator, input side)
CONFIGS = (("SRCNN", "SRCNN", 50), ("ResNetSR", "RESNET", 50),
           ("AttentionSR", "AttentionSR", 50), ("RRDB", "RRDB", 50),
           ("Discriminator", None, 200))


def _net(key: str | None, device: torch.device) -> torch.nn.Module:
    fn = Discriminator if key is None else (lambda: _REGISTRY[key](SCALE))
    return build_model(fn, device=device)


def count_flops(model: torch.nn.Module, x: torch.Tensor) -> dict:
    """``{"flops": total, "by_op": {operator: flops}}`` of one forward."""
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(x)
    by_op = {str(op).split(".")[-1]: n  # aten.convolution -> convolution
             for op, n in counter.get_flop_counts()["Global"].items()}
    return {"flops": counter.get_total_flops(), "by_op": by_op}


def visualize_all_models(out_root: str = "runs/all_models_viz",
                         optimized: bool = True, device="cuda",
                         models=None) -> dict:
    """Write each net's files (module docstring); ``models`` picks
    directory names (all by default). Returns {name: its directory}."""
    device = torch.device(device)
    written = {}
    for name, key, side in CONFIGS:
        if models and name not in models:
            continue
        model = _net(key, device)
        x = torch.zeros((1, 3, side, side), device=device) \
            .contiguous(memory_format=torch.channels_last)
        out_dir = os.path.join(out_root, name)
        os.makedirs(out_dir, exist_ok=True)
        ep = torch.export.export(model, (x,))
        with open(os.path.join(out_dir, "export_graph.txt"), "w") as f:
            f.write(str(ep))
        written[name] = out_dir
        if optimized:
            flops = count_flops(model, x)
            with open(os.path.join(out_dir, "flops.json"), "w") as f:
                json.dump(flops, f, indent=1)
            print(f"{name}: {flops['flops'] / 1e9:.2f} GFLOP/forward -> "
                  f"{out_dir}")
            continue
        print(f"{name}: -> {out_dir}")
    return written


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default="runs/all_models_viz")
    p.add_argument("--no-optimized", action="store_true",
                   help="skip the FLOP count (the graphs only)")
    p.add_argument("--models", nargs="+", default=None,
                   choices=[c[0] for c in CONFIGS],
                   help="the nets to write (all by default)")
    p.add_argument("--cpu", action="store_true",
                   help="trace and count on the CPU; the card otherwise")
    a = p.parse_args(argv)
    return visualize_all_models(a.out, optimized=not a.no_optimized,
                                device="cpu" if a.cpu else "cuda",
                                models=a.models)


if __name__ == "__main__":
    main()
