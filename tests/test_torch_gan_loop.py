"""The port's train() with loss_function "gan" and "perceptual"
(food101_sr_tpu_torch.training.loop and the CLI) on the CPU: against the
JAX package's train() at lr 0 from shared weights, preempted and resumed
bit for bit (the discriminator's state included), and the CLI.

Both registries' AttentionSR are narrowed to 2 blocks x 16 channels; the
discriminator is the loop's own, full width (nf=64), and VGG19 is
complete, loaded by both packages from one seeded weights file."""
import json
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

import food101_sr_tpu.models.registry as jax_registry
import food101_sr_tpu_torch.models.registry as registry
import food101_sr_tpu_torch.train as cli
from food101_sr_tpu.metrics.metrics import LPIPSAlex as JaxLPIPSAlex
from food101_sr_tpu.models.attention_sr import AttentionSR as JaxAttentionSR
from food101_sr_tpu.models.discriminator import Discriminator as JaxD
from food101_sr_tpu.training import save_checkpoint as jax_save_checkpoint
from food101_sr_tpu.training import train as jax_train
from food101_sr_tpu_torch.convert import discriminator_from_jax, params_from_jax
from food101_sr_tpu_torch.models import AttentionSR, Discriminator
from food101_sr_tpu_torch.models.feature_nets import LPIPS_TAP_CHANNELS
from food101_sr_tpu_torch.training import load_checkpoint, loop, train
from test_torch_gan import write_vgg_npz

SCALE, BLOCKS, CHANNELS = 4, 2, 16
COMMON = dict(dataset="synthetic", architecture="AttentionSR",
              synthetic_size=96, crop_size=32, batch_size=8, use_wandb=False)


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


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """One weights directory both packages read: seeded VGG19, AlexNet and
    LPIPS heads as .npz files."""
    d = tmp_path_factory.mktemp("weights")
    write_vgg_npz(d)
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


def _records(run_dir: Path, name: str) -> list[dict]:
    return [json.loads(line) for line in
            (run_dir / name / "log.jsonl").read_text().splitlines()]


def _jax_discriminator_into_the_port(monkeypatch, seed: int):
    """The port's loop builds its discriminator with JAX's weights: the
    init JAX's train() draws from PRNGKey(seed + 2) at crop 32."""
    v = jax.jit(lambda k: JaxD().init(k, jnp.zeros((1, 32, 32, 3)),
                                      train=False))(
        jax.random.PRNGKey(seed + 2))
    sd = discriminator_from_jax(v["params"],
                                {k: v[k] for k in v if k != "params"})
    build = loop.build_model

    def build_model(module_fn, **kw):
        model = build(module_fn, **kw)
        if module_fn is Discriminator:
            model.load_state_dict(sd, strict=True)
        return model

    monkeypatch.setattr(loop, "build_model", build_model)


def lr0_parity(loss, tmp_path, weights, monkeypatch):
    """One epoch of ``loss`` from shared weights (G warm-started from JAX's init; for
    gan, D carries JAX's init too) at lr 0, d_update_every 5: per-step G
    losses within 1e-4 relative (at lr 0 neither net moves, and the
    spectral vectors advance alike on both sides: two D forwards per step,
    whatever the data); val_psnr within 1e-4 dB and val_loss (the MAE for
    gan) 1e-5 relative; the final test metrics 1e-5 relative, SSIM 1e-5
    absolute (as test_torch_loop.py's parity). The D step's loss differs
    by its instance noise, so for it only the cadence is held: its
    metrics change on batches 0 and 5. (test_torch_perceptual_loop.py
    runs it for "perceptual", in a file of its own for the time.)"""
    monkeypatch.setenv("FOOD101_SR_RUN_DIR", str(tmp_path / "runs"))
    seed = 2
    net = JaxAttentionSR(scale_factor=SCALE, num_residuals=BLOCKS,
                         num_channels=CHANNELS)
    params = jax.jit(net.init)(jax.random.PRNGKey(0),
                               jnp.zeros((1, 8, 8, 3)))["params"]
    jax_save_checkpoint({"params": params}, str(tmp_path / "init_jax"))
    torch.save(params_from_jax(params), tmp_path / "init.pth")
    if loss == "gan":
        _jax_discriminator_into_the_port(monkeypatch, seed)
    cfg = dict(COMMON, loss_function=loss, lr=0.0, epochs=1, log_every=1,
               seed=seed, weights_dir=str(weights))
    want = jax_train({**cfg, "pretrained_weights": str(tmp_path / "init_jax"),
                      "save_name": "jax", "run_name": "jax"})
    got = train({**cfg, "pretrained_weights": str(tmp_path / "init.pth"),
                 "save_name": "port", "run_name": "port"}, device="cpu")

    ours, theirs = (_records(tmp_path / "runs", n) for n in ("port", "jax"))
    steps = [r for r in ours if "train_loss" in r]
    jsteps = [r for r in theirs if "train_loss" in r]
    assert len(steps) == len(jsteps) == 10
    np.testing.assert_allclose([r["train_loss"] for r in steps],
                               [r["train_loss"] for r in jsteps], rtol=1e-4)
    assert all(r["nonfinite_steps"] == 0 for r in steps)
    if loss == "gan":
        for recs in (steps, jsteps):
            d_loss = [r["train_loss_D"] for r in recs]
            changed = [i for i in range(10) if i == 0
                       or d_loss[i] != d_loss[i - 1]]
            assert changed == [0, 5] and np.all(np.isfinite(d_loss))
            assert all(r["nonfinite_steps_D"] == 0 for r in recs)
    (a,), (b,) = ([r for r in recs if "epoch" in r]
                  for recs in (ours, theirs))
    assert abs(a["val_psnr"] - b["val_psnr"]) <= 1e-4
    assert a["val_loss"] == pytest.approx(b["val_loss"], rel=1e-5)
    for k in ("psnr", "lpips", "nlpd"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    assert abs(got["ssim"] - want["ssim"]) <= 1e-5
    last = load_checkpoint(str(weights / "port_last.pth"))
    assert ("d" in last) == (loss == "gan")


def test_gan_loop_matches_jax_train_at_lr0(tmp_path, weights, monkeypatch):
    lr0_parity("gan", tmp_path, weights, monkeypatch)


RESUME = dict(COMMON, loss_function="gan", synthetic_size=48, epochs=2,
              patience=10, seed=11, lr=1e-4, ema=0.999, d_update_every=2)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


def test_preempted_gan_resume_equals_uninterrupted(tmp_path, weights,
                                                   monkeypatch):
    """Two epochs of 5 updates, a D step every 2 batches: a run preempted
    after 7 updates (epoch 1, batch 2) and resumed ends with a full-state
    checkpoint equal, every tensor bit for bit, to the uninterrupted
    run's: G (params, fused Adam with its clip, step, skipped, EMA), D
    (params, spectral vectors, running stats, Adam, step) and the host
    state. The noise generator is keyed by (seed, epoch, batch), so the
    resumed epoch replays the same noise."""
    monkeypatch.setenv("FOOD101_SR_RUN_DIR", str(tmp_path / "runs"))
    w = tmp_path / "w"
    for name in ("vgg19_features.npz",):
        w.mkdir(exist_ok=True)
        (w / name).write_bytes((weights / name).read_bytes())
    train({**RESUME, "weights_dir": str(w), "save_name": "full",
           "run_name": "full"}, device="cpu")
    out = train({**RESUME, "weights_dir": str(w), "save_name": "part",
                 "run_name": "part", "preempt_after_updates": 7},
                device="cpu")
    assert out["preempted"] is True
    part = load_checkpoint(str(w / "part_last.pth"))
    assert (part["host"]["epoch"], part["host"]["batch"]) == (1, 2)
    assert int(part["d"]["step"]) == 3 + 1  # batches 0, 2, 4; then 0
    train({**RESUME, "weights_dir": str(w), "save_name": "part2",
           "run_name": "part2", "resume": str(w / "part_last.pth")},
          device="cpu")
    full = _flat(load_checkpoint(str(w / "full_last.pth")))
    resumed = _flat(load_checkpoint(str(w / "part2_last.pth")))
    assert full.keys() == resumed.keys()
    assert any(k.startswith("/d/params/net.3.running_var") for k in full)
    for k, v in full.items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == resumed[k].dtype and torch.equal(v, resumed[k]), k
        else:
            assert v == resumed[k], k
    assert int(full["/g/step"]) == 10 and int(full["/d/step"]) == 6


def test_resume_of_a_gan_run_needs_the_d_state(tmp_path, weights):
    from food101_sr_tpu_torch.training import (EarlyStopping,
                                               ReduceLROnPlateau,
                                               SRTrainState, make_adam,
                                               save_train_checkpoint)
    from food101_sr_tpu_torch.training.checkpoint import \
        load_train_checkpoint

    g = registry.get_model("AttentionSR", device="cpu")
    d = registry.build_model(Discriminator, device="cpu")
    gs, ds = (SRTrainState.create(m, make_adam(1e-3)) for m in (g, d))
    path = str(tmp_path / "g_last.pth")
    save_train_checkpoint(gs, 0, ReduceLROnPlateau(1e-3), EarlyStopping(),
                          path)
    with pytest.raises(ValueError, match="no discriminator state"):
        load_train_checkpoint(path, gs, ReduceLROnPlateau(1e-3),
                              EarlyStopping(), ds)


def test_gan_refuses_grad_accum(tmp_path):
    with pytest.raises(ValueError, match="supervised losses only"):
        train({**COMMON, "loss_function": "gan", "grad_accum": 2,
               "weights_dir": str(tmp_path)}, device="cpu")


@pytest.mark.parametrize("loss", ["gan", "perceptual"])
def test_cli_runs_both_losses(loss, tmp_path, weights, monkeypatch):
    """``--loss_function gan|perceptual`` reach train() and run an epoch
    (the CLI's train on the CPU here)."""
    monkeypatch.setenv("FOOD101_SR_RUN_DIR", str(tmp_path / "runs"))
    seen = {}

    def on_cpu(config):
        seen.update(config)
        return train(config, device="cpu")

    monkeypatch.setattr(cli, "train", on_cpu)
    out = cli.main(["--architecture", "AttentionSR", "--dataset",
                    "synthetic", "--subset", "0.1", "--crop_size", "32",
                    "--batch_size", "8", "--epochs", "1",
                    "--loss_function", loss, "--weights_dir", str(weights),
                    "--save_name", f"cli_{loss}", "--use_wandb", "false"])
    assert seen["loss_function"] == loss
    assert all(np.isfinite(v) for v in out.values())
    last = load_checkpoint(str(weights / f"cli_{loss}_last.pth"))
    assert ("d" in last) == (loss == "gan")
