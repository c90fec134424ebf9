"""Sweep runner (counterpart of the JAX package's root ``sweep.py``): a
local search over the ``configs/sweep_*.yaml`` spaces, maximizing
``val_psnr``, with trials run through the port's ``training.train``.

    python -m food101_sr_tpu_torch.sweep configs/sweep_attentionSR.yaml \\
        --trials 2 --dataset synthetic --epochs 1 --set synthetic_size=96
    python -m food101_sr_tpu_torch.sweep configs/sweep_srcnn.yaml --asha \\
        --trials 4 --eta 2 --rung_epochs 1 --dataset synthetic

``method: bayes`` in a YAML runs the local TPE sampler, anything else
random search; ``--asha`` runs successive halving, promoted trials
resuming from their rolling ``*_last.pth`` checkpoints. Selection uses
``val_psnr`` only; test metrics are recorded and never select.

The sweep files are read by :func:`read_sweep_yaml`, a reader of the
YAML subset they use (nested block mappings, scalars, flow and block
lists of scalars, comments), so the port needs no YAML library.
"""
from __future__ import annotations

import argparse
import json
import os
import re

import numpy as np

from .training import train

# PyYAML's (YAML 1.1) resolvers for the scalars a sweep file holds
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
_BOOL = {"true": True, "yes": True, "on": True,
         "false": False, "no": False, "off": False}


def _scalar(text: str):
    """One YAML 1.1 scalar as ``yaml.safe_load`` types it: quoted
    strings, null, booleans, ints, floats (a dot required, as in PyYAML),
    else the plain string."""
    t = text.strip()
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "\"'":
        return t[1:-1]
    low = t.lower()
    if low in ("", "~", "null"):
        return None
    if low in _BOOL:
        return _BOOL[low]
    if _INT.match(t):
        return int(t.replace("_", ""))
    if _FLOAT.match(t) and t not in (".", "+.", "-."):
        return float(t.replace("_", ""))
    return t


def _strip_comment(line: str) -> str:
    """``line`` without a ``#`` comment outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _value(text: str):
    """A value on a key's line: a flow list ``[a, b]`` or a scalar."""
    t = text.strip()
    if t.startswith("[") and t.endswith("]"):
        inner = t[1:-1].strip()
        return [_scalar(v) for v in inner.split(",")] if inner else []
    return _scalar(t)


def read_sweep_yaml(text: str) -> dict:
    """The mapping a sweep YAML describes: block mappings nested by
    indentation, ``key: value`` with a scalar or a flow list, and block
    lists (``- value``) of scalars. Raises ``ValueError`` on anything
    else."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        body = _strip_comment(raw).rstrip()
        if body.strip():
            lines.append((n, len(body) - len(body.lstrip(" ")), body.strip()))
    pos = 0

    def block(indent: int):
        nonlocal pos
        out: dict | list | None = None
        while pos < len(lines):
            n, ind, body = lines[pos]
            if ind < indent:
                break
            if ind > indent:
                raise ValueError(f"line {n}: unexpected indentation")
            if body.startswith("- ") or body == "-":
                if out is None:
                    out = []
                if not isinstance(out, list):
                    raise ValueError(f"line {n}: a list item in a mapping")
                out.append(_value(body[1:]))
                pos += 1
                continue
            key, sep, rest = body.partition(":")
            if not sep or (rest and not rest.startswith(" ")):
                raise ValueError(f"line {n}: want 'key: value', got {body!r}")
            if out is None:
                out = {}
            if not isinstance(out, dict):
                raise ValueError(f"line {n}: a mapping key in a list")
            pos += 1
            if rest.strip():
                out[_scalar(key)] = _value(rest)
            elif pos < len(lines) and (
                    lines[pos][1] > indent or (lines[pos][1] == indent and
                                               lines[pos][2].startswith("-"))):
                child = lines[pos][1]
                out[_scalar(key)] = block(child)
            else:
                out[_scalar(key)] = None
        return {} if out is None else out

    result = block(0)
    if pos != len(lines):
        raise ValueError(f"line {lines[pos][0]}: unexpected indentation")
    return result


def load_sweep(path: str) -> dict:
    with open(path) as f:
        return read_sweep_yaml(f.read())


def sample_config(space: dict, rng: np.random.Generator) -> dict:
    cfg = {}
    for key, spec in space.items():
        if "value" in spec:
            cfg[key] = spec["value"]
        elif "values" in spec:
            cfg[key] = spec["values"][int(rng.integers(len(spec["values"])))]
        elif "min" in spec and "max" in spec:
            # log-uniform for lr-like ranges
            lo, hi = float(spec["min"]), float(spec["max"])
            cfg[key] = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        else:
            raise ValueError(f"Unsupported sweep spec for {key}: {spec}")
    return cfg


# Local Bayes search (TPE), honoring the YAMLs' ``method: bayes``:
# Parzen models of p(x|good) and p(x|bad) from the trial history, and the
# candidate with the best density ratio (Bergstra et al. 2011).

def _log_density(cfg, trials, space):
    """Sum of per-key log densities of ``cfg`` under a Parzen model fit to
    ``trials``. Continuous keys: log-space KDE; categorical: Laplace-
    smoothed counts; constants contribute nothing."""
    total = 0.0
    for key, spec in space.items():
        if "value" in spec:
            continue
        if "values" in spec:
            vals = [t[key] for t in trials]
            n_opt = len(spec["values"])
            count = sum(1 for v in vals if v == cfg[key])
            total += np.log((count + 1.0) / (len(vals) + n_opt))
        else:
            lo, hi = np.log(float(spec["min"])), np.log(float(spec["max"]))
            pts = np.log([float(t[key]) for t in trials])
            bw = max((hi - lo) / max(np.sqrt(len(pts)), 1.0), 1e-3)
            x = np.log(float(cfg[key]))
            dens = np.mean(np.exp(-0.5 * ((x - pts) / bw) ** 2)) / (
                bw * np.sqrt(2 * np.pi))
            total += np.log(dens + 1e-12)
    return total


def tpe_sample(space: dict, history: list, rng: np.random.Generator,
               gamma: float = 0.25, n_candidates: int = 24,
               n_startup: int = 4) -> dict:
    """Next config by TPE: random while history < n_startup, then the
    candidate with the best l(x|good)/l(x|bad) ratio. ``history`` is a
    list of (cfg, score) with score = val_psnr (maximized)."""
    if len(history) < n_startup:
        return sample_config(space, rng)
    ranked = sorted(history, key=lambda h: -h[1])
    n_good = max(1, int(np.ceil(len(ranked) * gamma)))
    good = [c for c, _ in ranked[:n_good]]
    bad = [c for c, _ in ranked[n_good:]] or good
    best, best_ratio = None, -np.inf
    for _ in range(n_candidates):
        cand = sample_config(space, rng)
        ratio = _log_density(cand, good, space) - _log_density(cand, bad, space)
        if ratio > best_ratio:
            best, best_ratio = cand, ratio
    return best


def run_asha(sweep_yaml: str, trials: int, seed: int = 0,
             overrides: dict | None = None,
             out: str = "runs/sweep_results.jsonl",
             eta: int = 2, rung_epochs: int = 1, device="cuda"):
    """Successive halving with synchronous rungs: every trial trains
    ``rung_epochs`` epochs, the best 1/eta by ``val_psnr`` resume from
    their rolling full-state checkpoints for eta times the budget, and so
    on; the winner is the best trial of the final rung."""
    sweep = load_sweep(sweep_yaml)
    assert sweep["metric"]["name"] == "val_psnr"
    if sweep.get("method") == "bayes":
        print("ASHA note: the YAML declares method: bayes, but ASHA samples "
              "its whole cohort up-front (random); run without --asha for "
              "the sequential TPE sampler.")
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)

    alive = [(t, sample_config(sweep["parameters"], rng))
             for t in range(trials)]
    epochs, rung = rung_epochs, 0
    tag = os.path.splitext(os.path.basename(sweep_yaml))[0]
    results = []
    with open(out, "a") as fh:
        while alive:
            results = []
            for t, cfg in alive:
                c = dict(cfg)
                c.update(overrides or {})
                c["epochs"] = epochs
                c["save_name"] = f"asha_{tag}_{t}"
                c["run_name"] = f"asha_{tag}_{t}_rung{rung}"
                if rung > 0:
                    c["resume"] = os.path.join(
                        c.get("weights_dir", "weights"),
                        f"{c['save_name']}_last.pth")
                print(f"\n=== ASHA rung {rung} (epochs<= {epochs}) "
                      f"trial {t}: {cfg} ===")
                final = train(c, device=device)
                results.append((t, cfg, final))
                fh.write(json.dumps({"trial": t, "rung": rung,
                                     "epochs": epochs, "config": c,
                                     "val_psnr": final.get("val_psnr"),
                                     "test_metrics": final}) + "\n")
                fh.flush()
            if len(alive) == 1:
                break
            results.sort(key=lambda r: -r[2]["val_psnr"])
            alive = [(t, cfg) for t, cfg, _ in
                     results[: max(1, len(results) // eta)]]
            epochs *= eta
            rung += 1
    winner_t, w_cfg, w_final = max(results, key=lambda r: r[2]["val_psnr"])
    print(f"\nWINNER (trial {winner_t}): {w_cfg}\n"
          f"  val_psnr: {w_final['val_psnr']:.3f} | test metrics: "
          f"{ {k: v for k, v in w_final.items() if k != 'val_psnr'} }")
    return w_cfg, w_final


def run_sweep(sweep_yaml: str, trials: int, seed: int = 0,
              overrides: dict | None = None,
              out: str = "runs/sweep_results.jsonl",
              method: str | None = None, device="cuda"):
    """Equal-budget search. ``method``: None = honor the YAML's declared
    method ('bayes' -> local TPE, anything else -> random); 'random' /
    'bayes' override it."""
    sweep = load_sweep(sweep_yaml)
    assert sweep["metric"]["name"] == "val_psnr"
    method = method or sweep.get("method", "random")
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)

    best = None
    history = []  # (sampled cfg, val_psnr) pairs feeding the TPE model
    with open(out, "a") as fh:
        for t in range(trials):
            if method == "bayes":
                cfg = tpe_sample(sweep["parameters"], history, rng)
            else:
                cfg = sample_config(sweep["parameters"], rng)
            sampled = dict(cfg)
            cfg.update(overrides or {})
            cfg.setdefault("save_name",
                           f"sweep_{os.path.basename(sweep_yaml)}_{t}")
            cfg.setdefault("run_name", cfg["save_name"])
            print(f"\n=== Trial {t + 1}/{trials}: {cfg} ===")
            final = train(cfg, device=device)
            history.append((sampled, final["val_psnr"]))
            fh.write(json.dumps({"trial": t, "method": method, "config": cfg,
                                 "val_psnr": final.get("val_psnr"),
                                 "test_metrics": final}) + "\n")
            fh.flush()
            # selection on val_psnr only; test metrics are report-only
            if best is None or final["val_psnr"] > best[1]["val_psnr"]:
                best = (cfg, final)
    print(f"\nWINNER: {best[0]}\n  val_psnr: {best[1]['val_psnr']:.3f} | "
          f"test metrics: "
          f"{ {k: v for k, v in best[1].items() if k != 'val_psnr'} }")
    return best


def parse_overrides(pairs) -> dict:
    """``["KEY=VALUE", ...]`` -> {KEY: VALUE}, each value read as JSON
    where it parses (numbers, booleans, quoted strings) and kept as the
    string otherwise."""
    out = {}
    for kv in pairs:
        k, _, v = kv.partition("=")
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("sweep_yaml")
    p.add_argument("--trials", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dataset", default=None, help="override dataset")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="generic config override (repeatable), e.g. "
                        "--set subset=1.0 --set batch_size=8")
    p.add_argument("--method", default=None, choices=["random", "bayes"],
                   help="override the YAML's search method (default: honor "
                        "it; 'bayes' runs the local TPE sampler)")
    p.add_argument("--asha", action="store_true",
                   help="successive halving instead of equal-budget random "
                        "search: all trials run --rung_epochs, the top "
                        "1/eta resume for eta x the budget, repeat")
    p.add_argument("--eta", type=int, default=2,
                   help="ASHA promotion factor (keep top 1/eta per rung)")
    p.add_argument("--rung_epochs", type=int, default=1,
                   help="epoch budget of the first ASHA rung")
    p.add_argument("--cpu", action="store_true",
                   help="train on the CPU; the card otherwise")
    a = p.parse_args(argv)
    overrides = {}
    if a.dataset:
        overrides["dataset"] = a.dataset
    if a.epochs:
        overrides["epochs"] = a.epochs
    overrides.update(parse_overrides(a.set))
    device = "cpu" if a.cpu else "cuda"
    if a.asha:
        # ASHA samples its whole cohort up-front: no history for TPE
        if a.method == "bayes":
            p.error("--method bayes is incompatible with --asha: ASHA's "
                    "trial cohort is sampled up-front; drop --asha to use "
                    "the sequential TPE sampler")
        return run_asha(a.sweep_yaml, a.trials, a.seed, overrides,
                        eta=a.eta, rung_epochs=a.rung_epochs, device=device)
    return run_sweep(a.sweep_yaml, a.trials, a.seed, overrides,
                     method=a.method, device=device)


if __name__ == "__main__":
    main()
