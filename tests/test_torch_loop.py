"""The port's training runtime (food101_sr_tpu_torch.training: train(),
checkpoints, resume, preemption, grad accumulation; and the CLI) on the
CPU, against the JAX package where both can run the same thing, on
synthetic data and on a Food-101-layout JPEG tree.

Both registries' AttentionSR are narrowed to 2 blocks x 16 channels for
the module. Per CLAUDE.md's numerics rule nothing is compared after an
Adam step across the two frameworks: the loop parity runs at lr = 0 from
shared weights, grad accumulation compares raw averaged gradients, and
the resume checks compare the port with itself, bit for bit."""
import importlib.util
import json
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401
from PIL import Image

import food101_sr_tpu.models.registry as jax_registry
import food101_sr_tpu_torch.models.registry as registry
from food101_sr_tpu.losses import get_loss_function as jax_get_loss_function
from food101_sr_tpu.metrics.metrics import LPIPSAlex as JaxLPIPSAlex
from food101_sr_tpu.models.attention_sr import AttentionSR as JaxAttentionSR
from food101_sr_tpu.training import save_checkpoint as jax_save_checkpoint
from food101_sr_tpu.training import train as jax_train
from food101_sr_tpu.training.state import SRTrainState as JaxState
from food101_sr_tpu.training.state import make_adam as jax_make_adam
from food101_sr_tpu.training.steps import make_accum_apply as jax_accum_apply
from food101_sr_tpu.training.steps import make_grad_step as jax_grad_step
from food101_sr_tpu_torch.convert import params_from_jax
from food101_sr_tpu_torch.losses import get_loss_function
from food101_sr_tpu_torch.models import AttentionSR, build_model
from food101_sr_tpu_torch.models.feature_nets import LPIPS_TAP_CHANNELS
import food101_sr_tpu_torch.train as cli
from food101_sr_tpu_torch.train import build_parser, main
from food101_sr_tpu_torch.training import (FIRST_LAST, EarlyStopping,
                                           ReduceLROnPlateau, SRTrainState,
                                           load_checkpoint,
                                           load_train_checkpoint, make_adam,
                                           make_accum_apply, make_grad_step,
                                           make_train_step,
                                           save_train_checkpoint, train,
                                           warm_start_params)

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from tools.make_fake_food101 import make_image  # noqa: E402

SCALE, BLOCKS, CHANNELS = 4, 2, 16
FIRST, LAST = FIRST_LAST["AttentionSR"]


@pytest.fixture(scope="module", autouse=True)
def narrow_nets():
    """Both registries' AttentionSR at 2 blocks x 16 channels."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(registry._REGISTRY, "AttentionSR",
                   lambda scale, **flags: AttentionSR(scale, CHANNELS, BLOCKS,
                                                     **flags))
        mp.setitem(jax_registry._REGISTRY, "AttentionSR",
                   lambda scale, dtype, remat, quantize, phase_tail:
                   JaxAttentionSR(scale_factor=scale, num_residuals=BLOCKS,
                                  num_channels=CHANNELS, dtype=dtype,
                                  remat=remat, quantize=quantize,
                                  phase_tail=phase_tail))
        yield


def _jax_params(seed=0):
    net = JaxAttentionSR(scale_factor=SCALE, num_residuals=BLOCKS,
                         num_channels=CHANNELS)
    return net, net.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, 8, 8, 3)))["params"]


def _port_model(params=None):
    model = build_model(lambda: AttentionSR(SCALE, CHANNELS, BLOCKS),
                        device="cpu")
    if params is not None:
        model.load_state_dict(params_from_jax(params), strict=True)
    return model


def _batch(n=8, crop=32, seed=3):
    return np.random.default_rng(seed).integers(0, 256, (n, crop, crop, 3),
                                                dtype=np.uint8)


COMMON = dict(dataset="synthetic", architecture="AttentionSR",
              synthetic_size=96, crop_size=32, batch_size=8, use_wandb=False)


# ---------------------------------------------------------------------------
# (f) the loop against JAX's train() at lr = 0 from shared weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lpips_weights(tmp_path_factory):
    """JAX's seeded AlexNet and seeded heads as .npz files, so that both
    metric calculators score with the same LPIPS weights."""
    d = tmp_path_factory.mktemp("weights")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        params = JaxLPIPSAlex(weights_dir=str(d)).variables["params"]
    np.savez(d / "alexnet_features.npz",
             **{f"{k}/{leaf}": np.asarray(v[leaf]) for k, v in params.items()
                for leaf in ("kernel", "bias")})
    rng = np.random.default_rng(7)
    np.savez(d / "lpips_alex_heads.npz",
             **{f"lin_{i}": rng.uniform(0, 0.1, c).astype(np.float32)
                for i, c in enumerate(LPIPS_TAP_CHANNELS)})
    return d


def _epoch_records(run_dir: Path, name: str) -> list[dict]:
    lines = (run_dir / name / "log.jsonl").read_text().splitlines()
    return [r for r in map(json.loads, lines) if "epoch" in r]


def test_loop_matches_jax_train_at_lr0(tmp_path, lpips_weights, monkeypatch):
    """Both train()s warm-start from the same weights (JAX's Orbax
    checkpoint, and its params_from_jax .pth) at lr 0: per-epoch lr and
    the early-stop epoch identical, val_psnr within 1e-4 dB, val_loss
    within 1e-5 relative, and the final test metrics within the metrics
    tests' 1e-5 relative; SSIM within 1e-5 absolute: a random-init net's
    SSIM is near 0 (0.027 here), where float32 cancellation in the
    variance terms is absolute (the two packages' SSIM of one same image
    pair differ by 3e-7 at SSIM 0.004), so a relative bound would measure
    the conditioning, not the loop. 96 images at batch 8: val 10 and test 24 images
    give batches of 8 under both packages' eval clamps (JAX's rounds to
    its 8 CPU devices, the port's takes min(batch, n))."""
    monkeypatch.setenv("FOOD101_SR_RUN_DIR", str(tmp_path / "runs"))
    _, params = _jax_params()
    jax_save_checkpoint({"params": params}, str(tmp_path / "init_jax"))
    torch.save(params_from_jax(params), tmp_path / "init.pth")
    cfg = dict(COMMON, lr=0.0, epochs=3, patience=1, log_every=1, seed=2,
               weights_dir=str(lpips_weights))
    want = jax_train({**cfg, "pretrained_weights": str(tmp_path / "init_jax"),
                      "save_name": "jax", "run_name": "jax"})
    got = train({**cfg, "pretrained_weights": str(tmp_path / "init.pth"),
                 "save_name": "port", "run_name": "port"}, device="cpu")

    theirs = _epoch_records(tmp_path / "runs", "jax")
    ours = _epoch_records(tmp_path / "runs", "port")
    assert [r["epoch"] for r in ours] == [r["epoch"] for r in theirs] == [0, 1]
    assert [r["lr"] for r in ours] == [r["lr"] for r in theirs]
    for a, b in zip(ours, theirs):
        assert abs(a["val_psnr"] - b["val_psnr"]) <= 1e-4
        assert a["val_loss"] == pytest.approx(b["val_loss"], rel=1e-5)
    assert set(got) == set(want) == {"psnr", "ssim", "lpips", "nlpd",
                                     "val_psnr"}
    for k in ("psnr", "lpips", "nlpd"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    assert abs(got["ssim"] - want["ssim"]) <= 1e-5
    assert abs(got["val_psnr"] - want["val_psnr"]) <= 1e-4
    # per-step records: one per update at log_every 1, the step's keys
    steps = [json.loads(line) for line in
             (tmp_path / "runs" / "port" / "log.jsonl").read_text().splitlines()
             if "train_loss" in line]
    assert len(steps) == 2 * 10 and all(r["nonfinite_steps"] == 0
                                        for r in steps)
    assert all(r["time/images_per_s"] > 0 for r in ours)


@pytest.fixture(scope="module")
def food_root(tmp_path_factory):
    """A Food-101-layout tree (make_fake_food101's images at its quality
    92): 96 train and 24 test JPEGs of 28-56 px at crop 32, so that a few
    take the resize path; as in the synthetic run, the val split (10
    images) and the test split give eval batches of 8 under both
    packages' clamps."""
    root = tmp_path_factory.mktemp("food")
    base = root / "food-101"
    (base / "meta").mkdir(parents=True)
    rng = np.random.default_rng(5)
    n = 0
    for split, count in (("train", 96), ("test", 24)):
        rel = []
        for _ in range(count):
            cls = ("pizza", "sushi", "ramen")[n % 3]
            (base / "images" / cls).mkdir(parents=True, exist_ok=True)
            h, w = (int(v) for v in rng.integers(28, 57, 2))
            Image.fromarray(make_image(rng, h, w)).save(
                base / "images" / cls / f"{1000000 + n}.jpg", quality=92)
            rel.append(f"{cls}/{1000000 + n}")
            n += 1
        (base / "meta" / f"{split}.txt").write_text("\n".join(rel) + "\n")
    return root


def test_food101_loop_matches_jax_train_at_lr0(tmp_path, food_root,
                                               lpips_weights, monkeypatch):
    """train(dataset="food101") against JAX's train() on the same JPEG
    tree, from shared weights at lr 0, one epoch: the tolerances of
    test_loop_matches_jax_train_at_lr0 (its docstring says why SSIM's is
    absolute). The loaders' batches are byte-equal (test_torch_data.py),
    so this holds the rest of the loop on Food-101 data."""
    monkeypatch.setenv("FOOD101_SR_RUN_DIR", str(tmp_path / "runs"))
    _, params = _jax_params(seed=1)
    jax_save_checkpoint({"params": params}, str(tmp_path / "init_jax"))
    torch.save(params_from_jax(params), tmp_path / "init.pth")
    cfg = dict(COMMON, dataset="food101", data_root=str(food_root), lr=0.0,
               epochs=1, log_every=5, seed=4, weights_dir=str(lpips_weights))
    want = jax_train({**cfg, "pretrained_weights": str(tmp_path / "init_jax"),
                      "save_name": "jax", "run_name": "jax"})
    got = train({**cfg, "pretrained_weights": str(tmp_path / "init.pth"),
                 "save_name": "port", "run_name": "port"}, device="cpu")
    (theirs,) = _epoch_records(tmp_path / "runs", "jax")
    (ours,) = _epoch_records(tmp_path / "runs", "port")
    assert ours["lr"] == theirs["lr"]
    assert abs(ours["val_psnr"] - theirs["val_psnr"]) <= 1e-4
    assert ours["val_loss"] == pytest.approx(theirs["val_loss"], rel=1e-5)
    for k in ("psnr", "lpips", "nlpd"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    assert abs(got["ssim"] - want["ssim"]) <= 1e-5
    assert abs(got["val_psnr"] - want["val_psnr"]) <= 1e-4


def test_cli_default_dataset_trains_on_a_food101_tree(tmp_path, food_root,
                                                      monkeypatch):
    """``python -m food101_sr_tpu_torch.train --data_root DIR`` with no
    --dataset reads the Food-101 tree (here on the CPU, cut by
    --subset)."""
    monkeypatch.setenv("FOOD101_SR_RUN_DIR", str(tmp_path / "runs"))
    seen = {}

    def on_cpu(config):
        seen.update(config)
        return train(config, device="cpu")

    monkeypatch.setattr(cli, "train", on_cpu)
    out = cli.main(["--architecture", "AttentionSR", "--data_root",
                    str(food_root), "--subset", "0.5", "--crop_size", "32",
                    "--batch_size", "8", "--epochs", "1", "--weights_dir",
                    str(tmp_path / "w"), "--use_wandb", "false"])
    assert seen["dataset"] == "food101"
    assert set(out) == {"psnr", "ssim", "lpips", "nlpd", "val_psnr"}
    assert all(np.isfinite(v) for v in out.values())
    (run,) = (tmp_path / "runs").iterdir()
    (rec,) = _epoch_records(tmp_path / "runs", run.name)
    assert rec["time/images_per_s"] > 0
    with pytest.raises(FileNotFoundError, match="Food-101 metadata"):
        cli.main(["--data_root", str(tmp_path / "nothing"), "--epochs", "1",
                  "--weights_dir", str(tmp_path / "w"), "--use_wandb",
                  "false"])


# ---------------------------------------------------------------------------
# (g) gradient accumulation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loss_name", ["mse", "nlpd"])
def test_accumulated_gradients_match_jax(loss_name):
    """make_grad_step over 2 microbatches of 4 + make_accum_apply: the
    averaged gradients (left in each parameter's .grad) equal JAX's
    make_grad_step average per leaf within 1e-5 of the leaf's max abs, and
    the update's loss and gradient norm equal JAX's make_accum_apply
    metrics within 1e-5 relative. No params are compared after Adam."""
    accum, mb = 2, 4
    net, params = _jax_params()
    hr = _batch(8)
    jstep = jax.jit(jax_grad_step(net, jax_get_loss_function(loss_name), SCALE))
    jsum, jloss = None, 0.0
    for i in range(accum):
        loss_i, g_i, _ = jstep(params, {}, jnp.asarray(hr[i * mb:(i + 1) * mb]))
        jsum = g_i if jsum is None else jax.tree_util.tree_map(jnp.add, jsum, g_i)
        jloss = jloss + loss_i
    jstate = JaxState.create({"params": params}, jax_make_adam(1e-3))
    _, jm = jax_accum_apply(accum, FIRST, LAST)(jstate, jsum, {}, jloss)
    want = params_from_jax(jax.tree_util.tree_map(lambda g: g / accum, jsum))

    model = _port_model(params)
    state = SRTrainState.create(model, make_adam(1e-3))
    step = make_grad_step(model, get_loss_function(loss_name), SCALE)
    gsum = lsum = None
    for i in range(accum):
        loss_i, g_i = step(torch.from_numpy(hr[i * mb:(i + 1) * mb]))
        if gsum is None:
            gsum, lsum = g_i, loss_i
        else:
            torch._foreach_add_(gsum, g_i)
            lsum = lsum + loss_i
    state, m = make_accum_apply(accum, FIRST, LAST)(state, gsum, lsum)
    for name, p in model.named_parameters():
        w = want[name].numpy()
        scale = np.abs(w).max() + 1e-12
        np.testing.assert_allclose(p.grad.numpy() / scale, w / scale,
                                   atol=1e-5, rtol=0, err_msg=name)
    for k in ("train_loss", "dynamics/grad_norm"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    assert int(state.step) == 1 and int(state.skipped) == 0


def _bits(state) -> list[torch.Tensor]:
    return ([p.detach().clone() for p in state.params]
            + [v.clone() for s in state.optimizer.state.values()
               for v in s.values()]
            + [e.clone() for e in state.ema] + [state.step.clone()])


def test_nan_microbatch_skips_the_whole_group():
    model = _port_model(_jax_params()[1])
    state = SRTrainState.create(model, make_adam(1e-3), ema=True)
    loss_fn = get_loss_function("mse")
    train_step = make_train_step(model, loss_fn, SCALE, FIRST, LAST,
                                 ema_decay=0.9)
    state, _ = train_step(state, torch.from_numpy(_batch(4)))  # Adam state
    before = _bits(state)
    good = make_grad_step(model, loss_fn, SCALE)
    bad = make_grad_step(model, lambda sr, hr: loss_fn(sr, hr) * np.nan, SCALE)
    l1, g1 = good(torch.from_numpy(_batch(4, seed=5)))
    l2, g2 = bad(torch.from_numpy(_batch(4, seed=6)))
    torch._foreach_add_(g1, g2)
    state, m = make_accum_apply(2, FIRST, LAST, ema_decay=0.9)(state, g1,
                                                               l1 + l2)
    after = _bits(state)
    assert len(before) == len(after)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert int(state.skipped) == 1 and float(m["nonfinite_steps"]) == 1.0


# ---------------------------------------------------------------------------
# (h) the full-state checkpoint
# ---------------------------------------------------------------------------

def _trained_state(ema: bool, seed=0, steps=2):
    model = _port_model(_jax_params(seed)[1])
    state = SRTrainState.create(model, make_adam(1e-3), ema=ema)
    step = make_train_step(model, get_loss_function("mse"), SCALE, FIRST,
                           LAST, ema_decay=0.9 if ema else None)
    for i in range(steps):
        state, _ = step(state, torch.from_numpy(_batch(4, seed=i)))
    return state


def _flat(tree, prefix=""):
    """Leaves of nested dicts/lists by path."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _assert_same(a: dict, b: dict):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k


def test_train_checkpoint_round_trip_is_bit_exact(tmp_path):
    state = _trained_state(ema=True)
    state.skipped.fill_(3)
    sched, stop = ReduceLROnPlateau(1e-3), EarlyStopping(patience=3)
    for v in (20.0, 10.0, 9.0, 8.0):  # one decay, then one bad epoch
        sched.step(v)
        stop.update(v)
    state.set_learning_rate(sched.lr)
    path = str(tmp_path / "x_last.pth")
    save_train_checkpoint(state, 4, sched, stop, path, batch=3)
    saved = load_checkpoint(path)

    fresh = _trained_state(ema=True, seed=1, steps=1)  # other weights, moments
    sched2, stop2 = ReduceLROnPlateau(1e-3), EarlyStopping(patience=3)
    fresh, epoch, batch = load_train_checkpoint(path, fresh, sched2, stop2)
    assert (epoch, batch) == (4, 3)  # mid-epoch save: re-enter epoch 4
    _assert_same(fresh.state_dict(), saved["g"])
    _assert_same(fresh.state_dict(), state.state_dict())
    assert sched2.state_dict() == sched.state_dict() == saved["host"]["scheduler"]
    assert stop2.state_dict() == stop.state_dict() == saved["host"]["stopper"]
    assert fresh.learning_rate == sched.lr == 5e-4
    assert set(saved["g"]) == {"params", "opt_state", "step", "skipped",
                               "ema_params"}
    assert saved["host"]["epoch"] == 4 and saved["host"]["batch"] == 3
    # fused Adam keeps its step per parameter as float32 on the device
    steps = [s["step"] for s in fresh.optimizer.state.values()]
    assert all(s.dtype == torch.float32 and float(s) == 2.0 for s in steps)


def test_train_checkpoint_optional_state_drift(tmp_path):
    """EMA switched on at resume: seeded from the restored params; switched
    off: dropped; a checkpoint without ``skipped``: the counter restarts
    at 0. An epoch-boundary save resumes at the next epoch."""
    with_ema, plain = _trained_state(ema=True), _trained_state(ema=False)
    sched, stop = ReduceLROnPlateau(1e-3), EarlyStopping()
    save_train_checkpoint(with_ema, 2, sched, stop, str(tmp_path / "e.pth"))
    save_train_checkpoint(plain, 2, sched, stop, str(tmp_path / "p.pth"))

    off, epoch, batch = load_train_checkpoint(
        str(tmp_path / "e.pth"), _trained_state(ema=False, seed=1),
        ReduceLROnPlateau(1e-3), EarlyStopping())
    assert (epoch, batch) == (3, 0) and off.ema is None
    _assert_same(off.state_dict()["params"], with_ema.state_dict()["params"])

    on, _, _ = load_train_checkpoint(
        str(tmp_path / "p.pth"), _trained_state(ema=True, seed=1),
        ReduceLROnPlateau(1e-3), EarlyStopping())
    for e, p in zip(on.ema, plain.params):
        assert torch.equal(e, p) and e.data_ptr() != p.data_ptr()

    tree = load_checkpoint(str(tmp_path / "p.pth"))
    del tree["g"]["skipped"]
    torch.save(tree, tmp_path / "old.pth")
    fresh = _trained_state(ema=False, seed=1)
    fresh.skipped.fill_(5)
    fresh, _, _ = load_train_checkpoint(str(tmp_path / "old.pth"), fresh,
                                        ReduceLROnPlateau(1e-3),
                                        EarlyStopping())
    assert int(fresh.skipped) == 0


def test_ema_evaluation_leaves_live_state_bit_equal():
    from food101_sr_tpu_torch.training import make_eval_step

    state = _trained_state(ema=True)
    before = _bits(state)
    eval_step = make_eval_step(state.model, get_loss_function("mse"), SCALE)
    hr = torch.from_numpy(_batch(2, seed=9))
    on_ema = eval_step(hr, state.ema_params())
    on_live = eval_step(hr)
    assert float(on_ema["psnr"]) != float(on_live["psnr"])
    assert all(torch.equal(a, b) for a, b in zip(before, _bits(state)))
    # the EMA evaluation is that of a model holding the EMA weights
    other = _port_model()
    other.load_state_dict({**state.model.state_dict(), **state.ema_params()})
    want = make_eval_step(other, get_loss_function("mse"), SCALE)(hr)
    assert float(on_ema["psnr"]) == float(want["psnr"])


# ---------------------------------------------------------------------------
# (i), (j) preempted + resumed == uninterrupted; zero epochs is eval-only
# ---------------------------------------------------------------------------

RESUME = dict(COMMON, epochs=2, patience=10, seed=11, lr=1e-4, ema=0.999)


@pytest.fixture(scope="module")
def full_run(tmp_path_factory):
    """One uninterrupted 2-epoch run with the EMA on (10 updates/epoch)."""
    w = tmp_path_factory.mktemp("resume")
    out = train({**RESUME, "weights_dir": str(w), "save_name": "full",
                 "run_name": "full"}, device="cpu")
    return w, out


def test_preempted_resume_equals_uninterrupted(full_run):
    """--preempt_after_updates 14 stops inside epoch 1 after 4 batches
    (the SIGTERM path); --resume finishes it. The resumed run's rolling
    checkpoint equals the uninterrupted one's, every tensor bit for bit
    (params, fused Adam state, step, skipped, EMA) and the host state."""
    w, _ = full_run
    out = train({**RESUME, "weights_dir": str(w), "save_name": "part",
                 "run_name": "part", "preempt_after_updates": 14},
                device="cpu")
    assert out["preempted"] is True
    part = load_checkpoint(str(w / "part_last.pth"))
    assert (part["host"]["epoch"], part["host"]["batch"]) == (1, 4)
    assert int(part["g"]["step"]) == 14

    train({**RESUME, "weights_dir": str(w), "save_name": "part2",
           "run_name": "part2", "resume": str(w / "part_last.pth")},
          device="cpu")
    full = load_checkpoint(str(w / "full_last.pth"))
    resumed = load_checkpoint(str(w / "part2_last.pth"))
    assert resumed["host"]["batch"] == 0 and resumed["host"]["epoch"] == 1
    _assert_same(resumed, full)
    assert int(full["g"]["step"]) == 20 and "ema_params" in full["g"]


def test_resume_refuses_a_batch_outside_the_accum_grouping(full_run):
    w, _ = full_run
    tree = load_checkpoint(str(w / "full_last.pth"))
    tree["host"]["batch"] = 3
    torch.save(tree, w / "odd_last.pth")
    with pytest.raises(ValueError, match="grad_accum"):
        train({**RESUME, "weights_dir": str(w), "save_name": "odd",
               "run_name": "odd", "batch_size": 8, "grad_accum": 2,
               "resume": str(w / "odd_last.pth")}, device="cpu")


def test_grad_accum_and_profile_through_train(tmp_path):
    """--grad_accum 2 at batch 8: 43 train images give 10 microbatches of
    4, grouped into 5 updates (the 11th would be a partial group), as many
    as the unsplit batch makes; --profile_steps writes a trace of the
    window after the first group."""
    out = train({**COMMON, "epochs": 1, "grad_accum": 2, "log_every": 1,
                 "synthetic_size": 48,
                 "weights_dir": str(tmp_path), "save_name": "acc",
                 "run_name": "acc", "profile_steps": 1,
                 "profile_dir": str(tmp_path / "prof")}, device="cpu")
    assert np.isfinite(out["psnr"])
    last = load_checkpoint(str(tmp_path / "acc_last.pth"))
    assert int(last["g"]["step"]) == 5 and int(last["g"]["skipped"]) == 0
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    with pytest.raises(ValueError, match="divisible"):
        train({**COMMON, "batch_size": 8, "grad_accum": 3,
               "weights_dir": str(tmp_path)}, device="cpu")


def test_zero_epochs_is_eval_only(full_run, tmp_path):
    """epochs 0 warm-started from the best checkpoint: no training, no
    checkpoint written, the first run's final test metrics exactly (its
    test pass evaluated that same checkpoint), val_psnr 0."""
    w, out = full_run
    best = w / "full_best.pth"
    sd = load_checkpoint(str(best))
    fresh = registry.get_model("AttentionSR", device="cpu")
    fresh.load_state_dict(sd, strict=True)  # the reference key layout
    got = train({**RESUME, "epochs": 0, "pretrained_weights": str(best),
                 "weights_dir": str(tmp_path), "save_name": "eval",
                 "run_name": "eval"}, device="cpu")
    assert got == {**{k: out[k] for k in ("psnr", "ssim", "lpips", "nlpd")},
                   "val_psnr": 0.0}
    assert not any(p.suffix == ".pth" for p in tmp_path.iterdir())


# ---------------------------------------------------------------------------
# (k) partial warm start
# ---------------------------------------------------------------------------

def test_qat_trains_and_its_checkpoint_loads_for_int8(tmp_path,
                                                      monkeypatch):
    """``quantize="qat"`` (ROADMAP item 8; the CLI's ``--quantize qat``)
    trains on the CPU: every body conv of the step runs fake-quantized
    (2 blocks x 2 convs + the mid conv per forward), the losses and final
    metrics are finite, and the best checkpoint, the float tree, loads
    strictly into the int8 net."""
    from food101_sr_tpu_torch.models import layers, model_for_params

    monkeypatch.setenv("FOOD101_SR_RUN_DIR", str(tmp_path / "runs"))
    calls = []
    fq = layers.fake_quant_conv2d
    monkeypatch.setattr(layers, "fake_quant_conv2d",
                        lambda *a, **k: calls.append(1) or fq(*a, **k))
    cfg = {**vars(build_parser().parse_args(
        ["--architecture", "AttentionSR", "--dataset", "synthetic",
         "--quantize", "qat", "--epochs", "1", "--lr", "1e-3",
         "--crop_size", "32", "--batch_size", "8", "--log_every", "1",
         "--weights_dir", str(tmp_path / "w"), "--save_name", "qat",
         "--run_name", "qat"])),
           "synthetic_size": 96, "use_wandb": False}
    got = train(cfg, device="cpu")
    assert all(np.isfinite(v) for v in got.values())
    # 10 train steps, one val and 3 test batches, the best checkpoint's
    # test pass: each forward runs the 5 body convs
    assert len(calls) % (2 * BLOCKS + 1) == 0 and len(calls) >= 50
    steps = [json.loads(line) for line in
             (tmp_path / "runs" / "qat" / "log.jsonl").read_text()
             .splitlines() if "train_loss" in line]
    assert len(steps) == 10 and all(np.isfinite(r["train_loss"])
                                    for r in steps)
    sd = torch.load(tmp_path / "w" / "qat_best.pth")
    q = model_for_params(sd, device="cpu", quantize="int8")
    assert q.res_blocks[1].conv2.quantize == "int8"

def test_partial_warm_start_keeps_init_where_shapes_differ(tmp_path):
    init = _port_model(_jax_params(0)[1]).state_dict()
    donor = _port_model(_jax_params(1)[1]).state_dict()
    donor["output_conv.weight"] = torch.zeros(3, 64, 5, 5)  # another shape
    del donor["mid_conv.bias"]
    donor["extra.weight"] = torch.ones(2)
    merged = warm_start_params(init, donor)
    assert merged.keys() == init.keys()
    for k, v in merged.items():
        src = init if k in ("output_conv.weight", "mid_conv.bias") else donor
        assert torch.equal(v, src[k]), k
    # through train(): an epochs-0 run warm-started from the donor file
    # loads it strictly into the model and evaluates without error
    torch.save(donor, tmp_path / "donor.pth")
    out = train({**COMMON, "epochs": 0, "weights_dir": str(tmp_path),
                 "pretrained_weights": str(tmp_path / "donor.pth"),
                 "run_name": "warm"}, device="cpu")
    assert np.isfinite(out["psnr"])


# ---------------------------------------------------------------------------
# (l) the CLI
# ---------------------------------------------------------------------------

def _root_cli_args(monkeypatch, argv):
    spec = importlib.util.spec_from_file_location("root_train_cli",
                                                  ROOT / "train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["train.py", *argv])
    return vars(mod.parse_args())


@pytest.mark.parametrize("argv", [
    [],
    ["--architecture", "AttentionSR", "--dataset", "synthetic", "--epochs",
     "2", "--ema", "0.999", "--grad_accum", "2", "--no_phase_tail",
     "--use_wandb", "false", "--resume", "w/x_last", "--preempt_after_updates",
     "7", "--profile_steps", "3", "--log_every", "1", "--lr", "1e-3"],
])
def test_cli_dests_and_defaults_equal_the_root_cli(monkeypatch, argv):
    assert vars(build_parser().parse_args(argv)) == _root_cli_args(
        monkeypatch, argv)


# the bf16 and cache flags, each reaching train() and running an epoch:
# SRCNN on 24 synthetic images (2 steps of 8), crop 32; the cache flags
# after the one that turns their cache on
@pytest.mark.parametrize("flags", [
    ["--dtype", "bfloat16"], ["--cache_device"],
    ["--cache_device", "--cache_canvas", "48"],
    ["--cache_device", "--cache_budget_gb", "2"],
    ["--cache_host", "{store}"],
    ["--cache_host", "{store}", "--cache_host_budget_gb", "8"],
    ["--cache_host", "{store}", "--cache_host_reuse", "4"],
    ["--cache_host", "{store}", "--cache_host_reuse", "2", "--cache_window",
     "8"],
], ids=lambda f: f[-2].lstrip("-") if len(f) > 1 and f[-1] != "{store}"
    else f[0].lstrip("-"))
def test_cli_bf16_and_cache_flags_train(flags, tmp_path, monkeypatch):
    monkeypatch.setenv("FOOD101_SR_RUN_DIR", str(tmp_path / "runs"))
    seen = {}

    def on_cpu(config):
        seen.update(config)
        return train({**config, "synthetic_size": 24}, device="cpu")

    monkeypatch.setattr(cli, "train", on_cpu)
    flags = [f.format(store=tmp_path / "store") for f in flags]
    out = main(["--dataset", "synthetic", "--crop_size", "32",
                "--batch_size", "8", "--epochs", "1", "--log_every", "1",
                "--weights_dir", str(tmp_path / "w"), "--use_wandb",
                "false", *flags])
    assert all(np.isfinite(v) for v in out.values())
    for flag, value in zip(flags, [*flags[1:], None]):
        key = flag[2:]
        if flag.startswith("--") and key != "cache_device":
            assert seen[key] == type(seen[key])(value), key
    assert seen["cache_device"] == ("--cache_device" in flags)
    if "--cache_host" in flags:
        assert any(p.name.startswith("canvas_")
                   for p in (tmp_path / "store").iterdir())
