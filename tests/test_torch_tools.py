"""The port's training-grade NLPD and its four offline tools on the CPU,
held against the JAX package: ``losses.nlpd_loss_train`` (value and input
gradient against JAX's, 4 K1 calls a loss), ``analyze_models`` (the six
rows' parameter counts), ``generate_model_vis`` (its files, the K2 op per
block, SRCNN's FLOPs), ``sweep`` (the YAML reader against PyYAML,
``sample_config`` and ``tpe_sample`` against JAX's, ``run_sweep`` and
``run_asha`` through the port's ``train()``) and ``visualize`` (PSNR,
the report layout and its baseline images against the JAX tool's, the
bucketed runner, ``parse_weight_specs``)."""
import glob
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image
from torch_threads import one_thread  # noqa: F401

from food101_sr_tpu_torch import (analyze_models, generate_model_vis,
                                  native, sweep, visualize)
from food101_sr_tpu_torch.losses import nlpd_loss, nlpd_loss_train
from food101_sr_tpu_torch.models import registry
from food101_sr_tpu_torch.models.attention_sr import AttentionSR
from food101_sr_tpu_torch.models.rrdb import RRDBNet
from food101_sr_tpu_torch.models.resnet_sr import ResNetSR
from food101_sr_tpu_torch.ops import pallas_blur

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import sweep as jax_sweep  # noqa: E402
import visualize as jax_visualize  # noqa: E402

# nlpd_loss_train against JAX's, both on bf16 pyramids: the value within
# 2^-10 relative (the level means of bf16 differences, accumulated in
# float32 on both sides); the input gradient within a cosine of 0.995 and
# 1% in norm. Not elementwise: an |a - b| whose bf16 difference sits near
# 0 takes the other sign when a blur rounds one bf16 ulp the other way
# (K1's separable sums against JAX's 2-D conv), which flips that
# element's gradient; measured cosine 0.998 on uniform noise
NLPD_VALUE_RTOL = 2.0**-10
NLPD_GRAD_COS, NLPD_GRAD_NORM = 0.995, 0.01


def _pair(seed, smooth):
    rng = np.random.default_rng(seed)
    p, t = (rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
            for _ in range(2))
    if smooth:  # photograph-like, as JAX's own parity test smooths
        for _ in range(3):
            p = (p + np.roll(p, 1, 1) + np.roll(p, 1, 2)) / 3
            t = (t + np.roll(t, 1, 1) + np.roll(t, 1, 2)) / 3
    return p, t


def _torch_value_grad(loss, p, t):
    pt = torch.from_numpy(p).permute(0, 3, 1, 2).clone().requires_grad_(True)
    v = loss(pt, torch.from_numpy(t).permute(0, 3, 1, 2))
    v.backward()
    return v.item(), pt.grad.permute(0, 2, 3, 1).numpy()


def _cos(a, b):
    return float((a * b).sum() / np.linalg.norm(a) / np.linalg.norm(b))


@pytest.mark.parametrize("smooth", [False, True], ids=["noise", "smooth"])
def test_nlpd_loss_train_matches_jax(smooth):
    """Eager JAX on the CPU (a jitted one keeps fused intermediates in
    float32, not bf16); the port's loss also keeps its direction against
    the metric-grade loss, as JAX's test pins JAX's."""
    from food101_sr_tpu.losses import nlpd_loss_train as jax_loss

    p, t = _pair(3, smooth)
    jv, jg = jax.value_and_grad(lambda a: jax_loss(a, jnp.asarray(t)))(
        jnp.asarray(p))
    jv, jg = float(jv), np.asarray(jg)
    v, g = _torch_value_grad(nlpd_loss_train, p, t)
    assert abs(v - jv) <= NLPD_VALUE_RTOL * abs(jv)
    assert _cos(g, jg) > NLPD_GRAD_COS
    assert abs(np.linalg.norm(g) / np.linalg.norm(jg) - 1) < NLPD_GRAD_NORM
    mv, mg = _torch_value_grad(nlpd_loss, p, t)
    assert abs(v - mv) / mv < 2e-2 and _cos(g, mg) > 0.99


def test_nlpd_loss_train_makes_four_k1_calls(monkeypatch):
    """One pyramid over cat([pred, target]): 4 K1 wrapper calls forward
    (all float32, the bf16 levels cast around the kernel), 4 backward."""
    calls = []
    plain = pallas_blur.blur_kernel

    def counting(x, *a):
        calls.append(x.dtype)
        return plain(x, *a)

    monkeypatch.setattr(pallas_blur, "blur_kernel", counting)
    p, t = (torch.rand(2, 3, 32, 32) for _ in range(2))
    p.requires_grad_(True)
    loss = nlpd_loss_train(p, t)
    assert calls == [torch.float32] * 4 and loss.dtype == torch.float32
    loss.backward()
    assert len(calls) == 8 and p.grad.dtype == torch.float32


def test_analyze_models_counts_equal_jax(capsys):
    """The six rows, counted exactly as JAX's param_count counts its
    params (JAX's shapes from eval_shape: nothing is run)."""
    from food101_sr_tpu.models import AttentionSR as JaxAttentionSR
    from food101_sr_tpu.models import Discriminator, get_model, param_count

    rows = analyze_models.analyze_models()
    jax_models = [(get_model("SRCNN"), 50), (get_model("RESNET"), 50),
                  (get_model("AttentionSR"), 50),
                  (JaxAttentionSR(num_channels=64, num_residuals=32), 50),
                  (get_model("RRDB"), 50), (Discriminator(), 200)]
    want = []
    for model, side in jax_models:
        shapes = jax.eval_shape(
            lambda m=model, s=side: m.init(
                {"params": jax.random.PRNGKey(0)},
                jnp.zeros((1, s, s, 3)), train=False))
        want.append(param_count(shapes["params"]))
    assert [n for _, n in rows] == want
    assert [name for name, _ in rows][3] == "AttentionSR (64ch variant)"
    assert "5,842,630" in capsys.readouterr().out


@pytest.fixture()
def narrow_registry(monkeypatch):
    """The registry's nets narrowed, so the graphs and counts run fast."""
    nets = {"AttentionSR": lambda scale, **f: AttentionSR(scale, 16, 3, **f),
            "RESNET": lambda scale, **f: ResNetSR(scale, 2, 16, **f),
            "RRDB": lambda scale, **f: RRDBNet(scale, 16, 8, 1, **f)}
    for name, fn in nets.items():
        monkeypatch.setitem(registry._REGISTRY, name, fn)


def test_generate_model_vis_writes_graphs_and_flops(narrow_registry,
                                                    tmp_path):
    written = generate_model_vis.main(["--out", str(tmp_path), "--cpu"])
    assert list(written) == ["SRCNN", "ResNetSR", "AttentionSR", "RRDB",
                             "Discriminator"]
    for name, d in written.items():
        graph = Path(d, "export_graph.txt").read_text()
        assert "ExportedProgram" in graph and "aten.conv2d" in graph, name
        flops = json.loads(Path(d, "flops.json").read_text())
        assert flops["flops"] == sum(flops["by_op"].values()) > 0
    # the SE squeeze is the registered K2 op, once per block
    attn = Path(written["AttentionSR"], "export_graph.txt").read_text()
    assert attn.count("torch.ops.f101.spatial_mean.default(") == 3
    # SRCNN: 2 x the multiply-adds of its three convs at 200 x 200
    model = registry.get_model("SRCNN", device="cpu")
    macs = sum(m.weight.numel() * 200 * 200 for m in
               (model.conv1, model.conv2, model.conv3))
    srcnn = json.loads(Path(written["SRCNN"], "flops.json").read_text())
    assert srcnn["by_op"]["convolution"] == 2 * macs
    assert generate_model_vis.main(["--out", str(tmp_path / "g"), "--cpu",
                                    "--no-optimized", "--models", "SRCNN"]) \
        == {"SRCNN": str(tmp_path / "g" / "SRCNN")}
    assert not (tmp_path / "g" / "SRCNN" / "flops.json").exists()


_TINY = {"program": "train.py", "method": "random",
         "metric": {"name": "val_psnr", "goal": "maximize"},
         "parameters": {"architecture": {"value": "SRCNN"},
                        "loss_function": {"value": "mse"},
                        "lr": {"min": 1e-4, "max": 1e-3},
                        "batch_size": {"values": [8]}}}


@pytest.mark.parametrize("path", sorted(glob.glob(
    str(ROOT / "configs" / "sweep_*.yaml"))) + ["tiny"],
    ids=lambda p: os.path.basename(p))
def test_yaml_reader_equals_pyyaml(path):
    text = (yaml.safe_dump(_TINY) if path == "tiny"
            else Path(path).read_text())
    assert sweep.read_sweep_yaml(text) == yaml.safe_load(text)


def test_yaml_reader_scalars_and_refusals():
    text = ("a: 'x # y'  # c\nb: [1, 2.5, \"s\", true, null]\nc:\n"
            "  - 1e-4\n  - .5\n  - -3\nd: ~\n")
    assert sweep.read_sweep_yaml(text) == yaml.safe_load(text)
    for bad in ("a: 1\n  b: 2\n", "a:1\n", "- 1\nb: 2\n"):
        with pytest.raises(ValueError):
            sweep.read_sweep_yaml(bad)


def test_samplers_match_jax():
    """sample_config over every configs/sweep_*.yaml space and tpe_sample
    over a history give JAX's configs for the same seed."""
    for path in sorted(glob.glob(str(ROOT / "configs" / "sweep_*.yaml"))):
        space = sweep.load_sweep(path)["parameters"]
        a, b = np.random.default_rng(5), np.random.default_rng(5)
        for _ in range(6):
            assert sweep.sample_config(space, a) == \
                jax_sweep.sample_config(space, b)
        hist_rng = np.random.default_rng(1)
        history = [(jax_sweep.sample_config(space, hist_rng),
                    float(hist_rng.uniform(20, 30))) for _ in range(9)]
        a, b = np.random.default_rng(2), np.random.default_rng(2)
        for n in (0, 3, 9):  # startup (random), then TPE
            assert sweep.tpe_sample(space, history[:n], a) == \
                jax_sweep.tpe_sample(space, history[:n], b)


@pytest.fixture()
def tiny_sweep(tmp_path):
    path = tmp_path / "sweep.yaml"
    path.write_text(yaml.safe_dump(_TINY))
    return str(path)


_OVERRIDES = {"dataset": "synthetic", "subset": 1.0, "epochs": 1,
              "crop_size": 32, "scale_factor": 4, "patience": 10,
              "synthetic_size": 24, "use_wandb": False}


def test_asha_promotes_and_resumes(tiny_sweep, tmp_path):
    """JAX's ASHA test on the port's train(): 3 trials -> 1 survivor at
    twice the budget, chosen by val PSNR, resumed from its rolling
    checkpoint, reported from the final rung."""
    out = str(tmp_path / "results.jsonl")
    cfg, final = sweep.run_asha(
        tiny_sweep, trials=3, seed=0, out=out, eta=2, rung_epochs=1,
        overrides={**_OVERRIDES, "weights_dir": str(tmp_path / "w")},
        device="cpu")
    assert final["psnr"] > 0 and final["val_psnr"] > 0
    rows = [json.loads(line) for line in open(out)]
    rung0 = [r for r in rows if r["rung"] == 0]
    rung1 = [r for r in rows if r["rung"] == 1]
    assert len(rung0) == 3 and len(rung1) == 1
    assert rung1[0]["epochs"] == 2
    assert rung1[0]["trial"] == max(rung0, key=lambda r: r["val_psnr"])["trial"]
    assert final["val_psnr"] == rung1[0]["val_psnr"]
    t = rung1[0]["trial"]
    assert rung1[0]["config"]["resume"] == str(
        tmp_path / "w" / f"asha_sweep_{t}_last.pth")
    assert os.path.isfile(rung1[0]["config"]["resume"])


def test_run_sweep_trains_and_selects_on_val_psnr(tiny_sweep, tmp_path,
                                                  monkeypatch):
    """One real trial through train(), then JAX's selection test: the
    trial with the better val PSNR wins over a better test PSNR."""
    cfg, final = sweep.run_sweep(
        tiny_sweep, trials=1, seed=0, out=str(tmp_path / "r0.jsonl"),
        overrides={**_OVERRIDES, "weights_dir": str(tmp_path / "w")},
        device="cpu")
    assert final["val_psnr"] > 0 and cfg["architecture"] == "SRCNN"
    assert os.path.isfile(tmp_path / "w" / f"{cfg['save_name']}_best.pth")

    fakes = [{"psnr": 99.0, "ssim": 1.0, "lpips": 0.0, "nlpd": 0.0,
              "val_psnr": 10.0},
             {"psnr": 5.0, "ssim": 0.5, "lpips": 0.5, "nlpd": 1.0,
              "val_psnr": 30.0}]
    calls = []

    def fake_train(c, device):
        calls.append((dict(c), device))
        return dict(fakes[len(calls) - 1])

    monkeypatch.setattr(sweep, "train", fake_train)
    cfg, final = sweep.run_sweep(tiny_sweep, trials=2, seed=0,
                                 overrides={"weights_dir": "w"},
                                 out=str(tmp_path / "r.jsonl"), device="cpu")
    assert final["val_psnr"] == 30.0 and final["psnr"] == 5.0
    assert [d for _, d in calls] == ["cpu", "cpu"]


def test_sweep_cli_overrides(monkeypatch, tiny_sweep):
    seen = {}
    monkeypatch.setattr(sweep, "run_asha", lambda *a, **k: seen.update(
        args=a, kwargs=k))
    sweep.main([tiny_sweep, "--asha", "--trials", "3", "--dataset",
                "synthetic", "--epochs", "2", "--set", "subset=0.5",
                "--set", "loss_function=\"nlpd\"", "--set", "note=x y",
                "--cpu"])
    assert seen["args"][3] == {"dataset": "synthetic", "epochs": 2,
                               "subset": 0.5, "loss_function": "nlpd",
                               "note": "x y"}
    assert seen["kwargs"]["device"] == "cpu"
    with pytest.raises(SystemExit):
        sweep.main([tiny_sweep, "--asha", "--method", "bayes"])


def test_calculate_psnr_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (16, 24, 3), np.uint8)
    b = rng.integers(0, 256, (16, 24, 3), np.uint8)
    assert visualize.calculate_psnr(a, b) == jax_visualize.calculate_psnr(a, b)
    assert visualize.calculate_psnr(a, a) == 100.0
    np.testing.assert_allclose(
        visualize.calculate_psnr(np.full((4, 4, 3), 100, np.uint8),
                                 np.full((4, 4, 3), 101, np.uint8)),
        48.1308, atol=1e-3)


def test_report_layout_matches_jax(tmp_path, capsys):
    """Two synthetic images: the port's report with the committed SRCNN
    asset (a missing RESNET row is skipped with a warning) has JAX's
    layout, and its ground truth, nearest and bicubic PNGs hold the JAX
    report's pixels (PIL there, the port's own resize and codec here)."""
    times = visualize.run_comparison(
        dataset="synthetic", num_examples=2, out_dir=str(tmp_path / "port"),
        seed=0, device="cpu",
        weights={"SRCNN": visualize.WEIGHTS["SRCNN"],
                 "RESNET": str(tmp_path / "nope.pth")})
    out = capsys.readouterr().out
    assert "Warning: could not load weights for RESNET" in out
    assert "INFERENCE TIME SUMMARY" in out
    assert set(times) == {"SRCNN"} and len(times["SRCNN"]) == 2
    jax_visualize.run_comparison(
        dataset="synthetic", num_examples=2, out_dir=str(tmp_path / "jax"),
        seed=0, weights={"SRCNN": str(tmp_path / "nope")})
    port_dirs = sorted(p.name for p in (tmp_path / "port").glob("image_*"))
    assert port_dirs == sorted(p.name for p in
                               (tmp_path / "jax").glob("image_*"))
    assert len(port_dirs) == 2
    for d in port_dirs:
        for f in ("ground_truth.png", "input_lr_resized.png", "bicubic.png"):
            got = native.decode_png_rgb8((tmp_path / "port" / d / f)
                                         .read_bytes())
            want = np.asarray(Image.open(tmp_path / "jax" / d / f)
                              .convert("RGB"))
            np.testing.assert_array_equal(got, want, err_msg=f"{d}/{f}")
        sr = native.decode_png_rgb8((tmp_path / "port" / d / "srcnn.png")
                                    .read_bytes())
        assert sr.shape == want.shape


def test_model_runner_buckets_and_skips(tmp_path, capsys):
    """A missing checkpoint leaves no model; a loaded runner pads a
    30 x 45 LR image to the 32-multiple bucket and crops the SR back."""
    assert visualize.ModelRunner("SRCNN", str(tmp_path / "x"),
                                 device="cpu").model is None
    r = visualize.ModelRunner("SRCNN", visualize.WEIGHTS["SRCNN"],
                              device="cpu")
    lr = np.random.default_rng(1).uniform(0, 1, (30, 45, 3)).astype(np.float32)
    sr, dt = r.predict(lr, bucket=True)
    assert sr.shape == (120, 180, 3) and sr.dtype == np.uint8 and dt > 0
    assert r._warm_shapes == {((1, 3, 32, 64), False)}


def test_parse_weight_specs():
    assert visualize.parse_weight_specs(None) is None
    assert visualize.parse_weight_specs([]) is None
    specs = ["RESNET=w/resnet.pth", "SRCNN=w/s"]
    assert visualize.parse_weight_specs(specs) == \
        jax_visualize.parse_weight_specs(specs)
    for bad in ["RESNET", "=path", "NAME="]:
        with pytest.raises(ValueError):
            visualize.parse_weight_specs([bad])
