"""The port's train() and CLI around SRCNN, ResNetSR and RRDBNet
(food101_sr_tpu_torch.training) on the CPU: against the JAX package's
train() at lr 0 from shared weights (ResNetSR supervised, RRDB in the
GAN), the BatchNorm buffers through the warm start and a preempted
resume, and the CLI on its default ``--architecture SRCNN``.

Both registries' RESNET are narrowed to 2 blocks x 16 channels and their
RRDB to 2 blocks x 16 channels, growth 8; SRCNN runs at registry size.
Nothing is compared after an Adam step across the two frameworks (Adam
amplifies reduction-order noise on near-zero gradients): the parity runs
at lr 0."""
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
from food101_sr_tpu.models.resnet_sr import ResNetSR as JaxResNetSR
from food101_sr_tpu.models.rrdb import RRDBNet as JaxRRDBNet
from food101_sr_tpu.training import save_checkpoint as jax_save_checkpoint
from food101_sr_tpu.training import train as jax_train
from food101_sr_tpu_torch.convert import params_from_jax
from food101_sr_tpu_torch.models import ResNetSR, RRDBNet, SRCNN
from food101_sr_tpu_torch.models.feature_nets import LPIPS_TAP_CHANNELS
from food101_sr_tpu_torch.training import load_checkpoint, loop, train
from test_torch_gan import write_vgg_npz
from test_torch_gan_loop import _jax_discriminator_into_the_port

SCALE = 4
COMMON = dict(dataset="synthetic", synthetic_size=96, crop_size=32,
              batch_size=8, use_wandb=False)
JAX_NETS = {
    "RESNET": lambda: JaxResNetSR(scale_factor=SCALE, num_channels=16,
                                  num_residuals=2),
    "RRDB": lambda: JaxRRDBNet(scale_factor=SCALE, num_channels=16, growth=8,
                               num_blocks=2),
}


@pytest.fixture(scope="module", autouse=True)
def narrow_nets():
    """Both registries' RESNET at 2 x 16 and RRDB at 2 x 16, growth 8."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(registry._REGISTRY, "RESNET",
                   lambda scale, **flags: ResNetSR(scale, 16, 2, **flags))
        mp.setitem(registry._REGISTRY, "RRDB",
                   lambda scale, **flags: RRDBNet(scale, 16, 8, 2, **flags))
        mp.setitem(jax_registry._REGISTRY, "RESNET",
                   lambda scale, dtype, remat, quantize, phase_tail:
                   JaxResNetSR(scale_factor=scale, num_channels=16,
                               num_residuals=2, dtype=dtype))
        mp.setitem(jax_registry._REGISTRY, "RRDB",
                   lambda scale, dtype, remat, quantize, phase_tail:
                   JaxRRDBNet(scale_factor=scale, num_channels=16, growth=8,
                              num_blocks=2, dtype=dtype))
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


def _shared_init(arch: str, tmp_path: Path):
    """JAX's init of the narrow net as an Orbax checkpoint (params only,
    as JAX's warm start reads) and as the port's .pth (with JAX's initial
    running stats, which are the port's too)."""
    net = JAX_NETS[arch]()
    variables = jax.jit(net.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 8, 8, 3)))
    jax_save_checkpoint({"params": variables["params"]},
                        str(tmp_path / "init_jax"))
    extra = {k: v for k, v in variables.items() if k != "params"}
    torch.save(params_from_jax(variables["params"], extra or None),
               tmp_path / "init.pth")


@pytest.mark.parametrize("arch,loss", [("RESNET", "nlpd"), ("RRDB", "gan")])
def test_loop_matches_jax_train_at_lr0(arch, loss, tmp_path, weights,
                                       monkeypatch):
    """One epoch (10 steps of 8) from shared weights at lr 0, for ResNetSR
    on NLPD (its BatchNorms update their running stats in every train-mode
    forward on both sides, and validation and the test run on them) and
    for RRDB in the GAN (D carries JAX's init; a D step every 5 batches):
    per-step G losses within 1e-4 relative; val_psnr within 1e-4 dB and
    val_loss 1e-5 relative; the final test metrics 1e-5 relative, SSIM
    1e-5 absolute (test_torch_loop.py's and test_torch_gan_loop.py's
    parities). The D step's loss differs by its instance noise, so for it
    only the cadence is held."""
    monkeypatch.setenv("FOOD101_SR_RUN_DIR", str(tmp_path / "runs"))
    seed = 2
    _shared_init(arch, tmp_path)
    if loss == "gan":
        _jax_discriminator_into_the_port(monkeypatch, seed)
    cfg = dict(COMMON, architecture=arch, loss_function=loss, lr=0.0,
               epochs=1, log_every=1, seed=seed, weights_dir=str(weights))
    want = jax_train({**cfg, "pretrained_weights": str(tmp_path / "init_jax"),
                      "save_name": f"jax_{arch}", "run_name": "jax"})
    got = train({**cfg, "pretrained_weights": str(tmp_path / "init.pth"),
                 "save_name": f"port_{arch}", "run_name": "port"},
                device="cpu")

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
    (a,), (b,) = ([r for r in recs if "epoch" in r]
                  for recs in (ours, theirs))
    assert abs(a["val_psnr"] - b["val_psnr"]) <= 1e-4
    assert a["val_loss"] == pytest.approx(b["val_loss"], rel=1e-5)
    for k in ("psnr", "lpips", "nlpd"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    assert abs(got["ssim"] - want["ssim"]) <= 1e-5
    last = load_checkpoint(str(weights / f"port_{arch}_last.pth"))
    assert ("d" in last) == (loss == "gan")
    if arch == "RESNET":  # 10 train-mode forwards counted in the state
        assert int(last["g"]["params"]["bn_mid.num_batches_tracked"]) == 10


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


def test_resume_and_warm_start_carry_batchnorm_buffers(tmp_path,
                                                       monkeypatch):
    """ResNetSR, 2 epochs of 5 updates: a run preempted after 7 updates
    and resumed ends with a full-state checkpoint bit-equal to the
    uninterrupted run's, BatchNorm running stats and counts included; the
    best checkpoint holds the trained running stats, and an epochs-0 run
    warm-started from it evaluates with them (test metrics equal to the
    first run's, 1e-6 relative; with the initial stats they differ)."""
    monkeypatch.setenv("FOOD101_SR_RUN_DIR", str(tmp_path / "runs"))
    cfg = dict(COMMON, architecture="RESNET", synthetic_size=48, epochs=2,
               patience=10, seed=11, lr=1e-3, loss_function="mae",
               weights_dir=str(tmp_path / "w"))
    final = train({**cfg, "save_name": "full", "run_name": "full"},
                  device="cpu")
    out = train({**cfg, "save_name": "part", "run_name": "part",
                 "preempt_after_updates": 7}, device="cpu")
    assert out["preempted"] is True
    train({**cfg, "save_name": "part2", "run_name": "part2",
           "resume": str(tmp_path / "w" / "part_last.pth")}, device="cpu")
    full = _flat(load_checkpoint(str(tmp_path / "w" / "full_last.pth")))
    resumed = _flat(load_checkpoint(str(tmp_path / "w" / "part2_last.pth")))
    assert full.keys() == resumed.keys()
    assert int(full["/g/params/bn_mid.num_batches_tracked"]) == 10
    for k, v in full.items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == resumed[k].dtype and torch.equal(v, resumed[k]), k
        else:
            assert v == resumed[k], k

    best = load_checkpoint(str(tmp_path / "w" / "full_best.pth"))
    assert not torch.equal(best["bn_mid.running_var"], torch.ones(16))
    evald = train({**cfg, "epochs": 0, "save_name": "eval",
                   "run_name": "eval", "pretrained_weights":
                   str(tmp_path / "w" / "full_best.pth")}, device="cpu")
    for k in ("psnr", "ssim", "lpips", "nlpd"):
        assert evald[k] == pytest.approx(final[k], rel=1e-6), k
    fresh = {k: (torch.ones_like(v) if k.endswith("running_var") else
                 torch.zeros_like(v) if k.endswith("running_mean") else v)
             for k, v in best.items()}
    torch.save(fresh, tmp_path / "fresh.pth")
    other = train({**cfg, "epochs": 0, "save_name": "fresh",
                   "run_name": "fresh", "pretrained_weights":
                   str(tmp_path / "fresh.pth")}, device="cpu")
    assert other["psnr"] != pytest.approx(final["psnr"], rel=1e-6)


def test_cli_runs_with_its_default_architecture_srcnn(tmp_path, weights,
                                                      monkeypatch):
    """``python -m food101_sr_tpu_torch.train --dataset synthetic`` runs
    the registry SRCNN (the CLI's default, as JAX's), here on the CPU."""
    monkeypatch.setenv("FOOD101_SR_RUN_DIR", str(tmp_path / "runs"))
    seen = {}
    built = []
    get = loop.get_model

    def on_cpu(config):
        seen.update(config)
        return train(config, device="cpu")

    def get_model(name, **kw):
        built.append(get(name, **kw))
        return built[-1]

    monkeypatch.setattr(cli, "train", on_cpu)
    monkeypatch.setattr(loop, "get_model", get_model)
    out = cli.main(["--dataset", "synthetic", "--subset", "0.1",
                    "--crop_size", "32", "--batch_size", "8", "--epochs",
                    "1", "--weights_dir", str(weights), "--save_name",
                    "cli_srcnn", "--use_wandb", "false"])
    assert seen["architecture"] == "SRCNN"
    assert isinstance(built[0], SRCNN) and built[0].conv2.out_channels == 64
    assert all(np.isfinite(v) for v in out.values())
    best = load_checkpoint(str(weights / "cli_srcnn_best.pth"))
    assert set(best) == {f"conv{i}.{t}" for i in (1, 2, 3)
                         for t in ("weight", "bias")}
