"""The port's train() in two OS processes (mirroring
tests/test_multihost.py): a gloo group brought up by train() itself from
the explicit flags (parallel/distributed.py), each rank loading its
interleaved share of every batch, the steps averaging over the ranks,
rank 0 alone writing checkpoints and the run log, and the preemption
agreement of PreemptionGuard.poll stopping both ranks at the same update.

Each rank writes its output to a file (tests/torch_ranks.py). One launch
of two ranks runs every train() of the module in turn (a rank's start-up
costs more than a run); the tests read their runs' results. Tolerances
are stated per test."""
import json

import jax
import jax.numpy as jnp
import pytest
import torch
from torch_threads import one_thread  # noqa: F401
from torch_ranks import launch

from food101_sr_tpu.models import get_model as jax_get_model
from food101_sr_tpu.training import save_checkpoint as jax_save_checkpoint
from food101_sr_tpu.training import train as jax_train
from food101_sr_tpu_torch.convert import params_from_jax
from test_torch_loop import lpips_weights  # noqa: F401 (a fixture)

_RANK = r'''
import json
import os
import sys

rank, port, tmp = int(sys.argv[1]), sys.argv[2], sys.argv[3]
with open(sys.argv[4]) as f:
    runs = json.load(f)
os.environ["FOOD101_SR_RUN_DIR"] = os.path.join(tmp, "runs")
import torch

torch.set_num_threads(1)
from food101_sr_tpu_torch.training import train

for tag, extra in runs.items():
    cfg = {"architecture": "SRCNN", "loss_function": "mse",
           "dataset": "synthetic", "synthetic_size": 64, "crop_size": 32,
           "batch_size": 8, "epochs": 1, "subset": 1.0, "patience": 5,
           "weights_dir": os.path.join(tmp, "w"), "save_name": "mh",
           "use_wandb": False, "coordinator": "localhost:" + port,
           "num_processes": 2, "process_id": rank}
    cfg.update(extra.get("common", {}))
    cfg.update(extra.get(str(rank), {}))
    print(f"RUN {tag}", flush=True)
    final = train(cfg, device="cpu")
    print("FINAL_JSON " + json.dumps(final), flush=True)
'''

# the preemption drill's runs: 170 synthetic images (153 train, 19 global
# batches of 8 an epoch), uninterrupted, preempted on rank 0 alone at
# update 10, resumed
_DRILL = {"synthetic_size": 170, "seed": 11}
# the lr-0 run: SRCNN, MSE, 96 images, batch 8, one epoch
_LR0 = dict(architecture="SRCNN", loss_function="mse", dataset="synthetic",
            synthetic_size=96, crop_size=32, batch_size=8, lr=0.0, epochs=1,
            patience=5, log_every=1, seed=2, use_wandb=False)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, lpips_weights):
    """One launch of two ranks running, in turn, the port's lr-0 run from
    JAX's initial weights and the preemption drill, and meanwhile JAX's
    one-process train() at lr 0 (its run log under ``jax_runs``). Returns
    the tmp directory, JAX's final metrics and, per run, each rank's final
    metrics and output."""
    tmp = tmp_path_factory.mktemp("mh")
    net = jax_get_model("SRCNN", scale_factor=4)
    params = jax.jit(net.init)(jax.random.PRNGKey(3),
                               jnp.zeros((1, 8, 8, 3)))["params"]
    jax_save_checkpoint({"params": params}, str(tmp / "init_jax"))
    torch.save(params_from_jax(params), tmp / "init.pth")
    cfg = {**_LR0, "weights_dir": str(lpips_weights)}
    want = {}

    def jax_side():
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("FOOD101_SR_RUN_DIR", str(tmp / "jax_runs"))
            want.update(jax_train({
                **cfg, "pretrained_weights": str(tmp / "init_jax"),
                "save_name": "mh_jax", "run_name": "jax"}))

    runs = {
        "lr0": {"common": {**cfg, "pretrained_weights": str(tmp / "init.pth"),
                           "save_name": "mh_port", "run_name": "port"}},
        "full": {"common": {**_DRILL, "save_name": "mhA", "run_name": "mhA"}},
        "part": {"common": {**_DRILL, "save_name": "mhB", "run_name": "mhB"},
                 "0": {"preempt_after_updates": 10}},
        "resume": {"common": {**_DRILL, "save_name": "mhC",
                              "run_name": "mhC",
                              "resume": str(tmp / "w" / "mhB_last.pth")}}}
    (tmp / "runs.json").write_text(json.dumps(runs))
    outs = launch(_RANK, tmp, "mh", args=[tmp, tmp / "runs.json"],
                  timeout=240.0, meanwhile=jax_side)
    got = {tag: ([], []) for tag in runs}
    for out in outs:
        parts = out.split("RUN ")[1:]
        assert [p.split("\n", 1)[0] for p in parts] == list(runs), out[-2000:]
        for part in parts:
            tag, text = part.split("\n", 1)
            line = [ln for ln in text.splitlines()
                    if ln.startswith("FINAL_JSON ")]
            assert line, text[-2000:]
            got[tag][0].append(json.loads(line[-1][len("FINAL_JSON "):]))
            got[tag][1].append(text)
    return tmp, want, got


def _records(path):
    return [json.loads(ln) for ln in path.read_text().splitlines()]


def test_two_process_train_matches_jax_at_lr0(ranks, lpips_weights):
    """SRCNN, MSE, 96 synthetic images, batch 8, one epoch at lr 0 from
    shared weights: the two ranks' results equal, each epoch's val_psnr
    within 1e-4 dB and val_loss 1e-5 relative of JAX's one-process
    train() on its 8-device CPU mesh, the final test metrics within 1e-5
    relative (SSIM 1e-5 absolute): the bounds of
    test_torch_loop.py::test_loop_matches_jax_train_at_lr0. The eval
    batches are 8 on both sides (10 val and 24 test images; JAX rounds
    to its 8 devices, the port to its 2 ranks). Rank 0 alone writes the
    best checkpoint and the one run log."""
    tmp_path, want, got_runs = ranks
    finals, outs = got_runs["lr0"]

    assert finals[0] == finals[1]
    got = finals[0]
    assert set(got) == set(want)
    for k in ("psnr", "lpips", "nlpd"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    assert abs(got["ssim"] - want["ssim"]) <= 1e-5
    assert abs(got["val_psnr"] - want["val_psnr"]) <= 1e-4
    theirs = [r for r in _records(tmp_path / "jax_runs" / "jax" /
                                  "log.jsonl") if "epoch" in r]
    logs = list((tmp_path / "runs").glob("*/log.jsonl"))
    assert sorted(p.parent.name for p in logs) == ["mhA", "mhB", "mhC",
                                                   "port"]
    rows = _records(tmp_path / "runs" / "port" / "log.jsonl")
    assert sum("_config" in r for r in rows) == 1
    ours = [r for r in rows if "epoch" in r]
    assert [r["epoch"] for r in ours] == [r["epoch"] for r in theirs] == [0]
    for a, b in zip(ours, theirs):
        assert abs(a["val_psnr"] - b["val_psnr"]) <= 1e-4
        assert a["val_loss"] == pytest.approx(b["val_loss"], rel=1e-5)
    # one record per update (log_every 1): 10 global batches an epoch
    assert sum("train_loss" in r for r in rows) == 10
    assert (lpips_weights / "mh_port_best.pth").is_file()
    assert all("Running on 2 device(s) cpu | 2 process(es)" in out
               for out in outs)
    assert all("backend gloo" in out for out in outs)


def test_two_process_preemption_agreement(ranks):
    """The request lands on rank 0 alone, at update 10; the agreement
    every 16 cumulative updates stops both ranks after batch 15 (170
    synthetic images: 153 train, 19 global batches of 8 an epoch), rank 0
    saves the state, and the resumed run ends with a full-state checkpoint
    equal, leaf for leaf, to the uninterrupted run's; one run log per
    run."""
    tmp_path, _, got = ranks
    finals_a, outs_a = got["full"]
    assert "preempted" not in finals_a[0]
    assert not any("after batch" in out for out in outs_a)
    finals_b, outs_b = got["part"]
    assert all(f.get("preempted") is True for f in finals_b), finals_b
    assert all("after batch 15" in out for out in outs_b)
    part = torch.load(tmp_path / "w" / "mhB_last.pth", weights_only=True)
    assert (part["host"]["epoch"], part["host"]["batch"]) == (0, 16)

    finals_c, _ = got["resume"]
    assert finals_c[0] == finals_c[1] == finals_a[0]
    full = torch.load(tmp_path / "w" / "mhA_last.pth", weights_only=True)
    resumed = torch.load(tmp_path / "w" / "mhC_last.pth", weights_only=True)
    assert resumed["host"]["batch"] == 0
    fa, fc = _leaves(full["g"]), _leaves(resumed["g"])
    assert fa.keys() == fc.keys()
    for k in fa:
        a, c = fa[k], fc[k]
        assert (torch.equal(a, c) if isinstance(a, torch.Tensor)
                else a == c), k
    logs = sorted(p.parent.name for p in (tmp_path / "runs").glob(
        "*/log.jsonl"))
    assert logs == ["mhA", "mhB", "mhC", "port"]


def _leaves(tree, path="") -> dict:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _leaves(sub, f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _leaves(sub, f"{path}/{i}").items()}
    return {path: tree}
