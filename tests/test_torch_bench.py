"""The port's bench (``python -m food101_sr_tpu_torch.bench``) on the CPU:
its argv, names and exit messages against the root ``bench.py``; every
mode through ``main`` at a tiny size (the legs' own size arguments, the
registry's nets narrowed to 2 blocks x 16 channels); and the timed
programs against the JAX package: one bench forward (``build_infer``)
and one bench train step (``build_train``) on weights carried from a JAX
init (``convert.params_from_jax``)."""
import functools
import importlib.util
import io
import json
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from food101_sr_tpu.data.pipeline import prepare_batch as jax_prepare_batch
from food101_sr_tpu.losses import nlpd_loss as jax_nlpd
from food101_sr_tpu.models.attention_sr import AttentionSR as JaxAttentionSR
from food101_sr_tpu.training.state import SRTrainState as JaxState
from food101_sr_tpu.training.state import make_adam as jax_make_adam
from food101_sr_tpu.training.steps import make_train_step as jax_train_step
from food101_sr_tpu_torch import bench
from food101_sr_tpu_torch.convert import params_from_jax
from food101_sr_tpu_torch.models import (AttentionSR, ResNetSR, RRDBNet,
                                         SRCNN, registry)

ROOT = Path(__file__).resolve().parent.parent
SCALE = 4
BF16 = torch.bfloat16
STEP = 2.0 ** -8  # bf16's relative step (8 significant bits)


def _root_bench():
    """The root bench.py (its top level imports the standard library
    only), loaded under another name than the port's module."""
    spec = importlib.util.spec_from_file_location("root_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ROOT_BENCH = _root_bench()

ARGV = [[], ["--train"], ["--gan"], ["--input"], ["--architecture", "RRDB"],
        ["--architecture", "SRCNN", "--train"], ["--quantize"],
        ["--quantize", "int8"], ["--quantize", "int8_dot"],
        ["--quantize_dot"], ["--quantize", "--architecture", "RESNET"],
        ["--architecture", "RESNET", "--quantize", "int8"],
        ["--gan", "--quantize", "int8", "--architecture", "RRDB"],
        ["--input", "--train", "--architecture", "SRCNN"]]


@pytest.mark.parametrize("argv", ARGV, ids=lambda a: " ".join(a) or "none")
def test_mode_and_metric_name_match_root_bench(argv):
    argv = ["bench.py", *argv]
    mode = bench.parse_mode(argv)
    assert mode == ROOT_BENCH.parse_mode(argv)
    assert bench.metric_name(*mode) == ROOT_BENCH.metric_name(*mode)


@pytest.mark.parametrize("argv", [["--architecture", "VGG"],
                                  ["--architecture"],
                                  ["--quantize", "fp8"],
                                  ["--train", "--architecture", "rrdb"]])
def test_refusals_exit_with_root_bench_messages(argv):
    argv = ["bench.py", *argv]
    with pytest.raises(SystemExit) as ours:
        bench.parse_mode(argv)
    with pytest.raises(SystemExit) as theirs:
        ROOT_BENCH.parse_mode(argv)
    assert str(ours.value) == str(theirs.value) and "unknown" in \
        str(ours.value)


def test_device_flag():
    assert bench.parse_device(["--train"]) == "cuda"
    assert bench.parse_device(["--device", "cpu"]) == "cpu"
    with pytest.raises(SystemExit, match="unknown --device 'tpu'"):
        bench.parse_device(["--device", "tpu"])


@pytest.fixture
def narrow(monkeypatch):
    """The port registry's three post-upsampling nets narrowed to 2 blocks
    x 16 channels (RRDB growth 8), SRCNN hidden 16; the legs at a tiny
    size through their own arguments, 1 and 2 calls, one repeat."""
    nets = {"SRCNN": lambda scale, quantize="", phase_tail=False,
            compute_dtype=None, remat=False: SRCNN(
                scale, 16, compute_dtype=compute_dtype),
            "RESNET": lambda scale, **f: ResNetSR(scale, 16, 2, **f),
            "AttentionSR": lambda scale, **f: AttentionSR(scale, 16, 2, **f),
            "RRDB": lambda scale, **f: RRDBNet(scale, 16, 8, 2, **f)}
    for name, fn in nets.items():
        monkeypatch.setitem(registry._REGISTRY, name, fn)
    small = dict(n_short=1, n_long=2, repeats=1)
    for leg, kw in (("bench_infer", dict(batch=2, lr_size=12)),
                    ("bench_train", dict(batch=2, crop=32)),
                    ("bench_gan", dict(batch=2, crop=32))):
        monkeypatch.setattr(bench, leg, functools.partial(
            getattr(bench, leg), **kw, **small))
    monkeypatch.setattr(bench, "bench_input", functools.partial(
        bench.bench_input, n_images=2, batches=2, batch_size=2, crop=32,
        side=64))


def _run(argv) -> list[dict]:
    out = io.StringIO()
    with redirect_stdout(out):
        assert bench.main([*argv, "--device", "cpu"]) == 0
    return [json.loads(ln) for ln in out.getvalue().splitlines()]


@pytest.mark.parametrize("argv", [
    [], ["--architecture", "SRCNN"], ["--architecture", "RRDB", "--quantize"],
    ["--architecture", "RESNET", "--quantize_dot"], ["--train"],
    ["--train", "--architecture", "RRDB"],
    ["--train", "--architecture", "SRCNN"], ["--gan"], ["--input"]],
    ids=lambda a: " ".join(a) or "none")
def test_each_mode_prints_root_bench_lines(narrow, argv):
    """stdout is JSON lines only, the last the result: bench.py's keys
    (metric, value, unit, vs_baseline), vs_baseline null, the CPU run
    tagged; inference of a net with a tail prints the standard tail's
    provisional line first and tags the result "phase"."""
    lines = _run(argv)
    mode, quantize, arch = bench.parse_mode(argv)
    metric, unit = bench.metric_name(mode, quantize, arch)
    *provisional, last = lines
    assert list(last)[:4] == ["metric", "value", "unit", "vs_baseline"]
    assert (last["metric"], last["unit"]) == (metric, unit)
    assert last["vs_baseline"] is None and last["platform"] == "cpu"
    assert np.isfinite(last["value"])
    if mode == "infer" and arch != "SRCNN":
        assert last["tail"] == "phase"
        assert provisional == [{"metric": metric,
                                "value": provisional[0]["value"],
                                "unit": unit, "vs_baseline": None,
                                "tail": "standard"}]
    else:
        assert "tail" not in last and provisional == []


def test_srcnn_refuses_quantize_and_cuda_needs_a_card(narrow):
    with pytest.raises(ValueError, match="no quantizable body"):
        _run(["--architecture", "SRCNN", "--quantize", "int8"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench.main(["--input"])


# ---------------------------------------------------------------------------
# the timed programs against JAX's, on carried weights
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_variables(phase_tail: bool):
    net = JaxAttentionSR(scale_factor=SCALE, num_channels=16,
                         num_residuals=2, phase_tail=phase_tail)
    v = jax.jit(net.init)(jax.random.PRNGKey(3), jnp.zeros((1, 8, 8, 3)))
    return jax.tree_util.tree_map(np.asarray, dict(v))


def _jax_net(dtype, phase_tail: bool):
    return JaxAttentionSR(scale_factor=SCALE, num_channels=16,
                          num_residuals=2, phase_tail=phase_tail,
                          dtype=dtype)


def _carry(model, phase_tail: bool):
    model.load_state_dict(params_from_jax(
        _jax_variables(phase_tail)["params"]), strict=True)
    return model


# float32: 1e-4 abs on [0, 1]-scale outputs (test_torch_models.py); bf16:
# 4 bf16 steps of the output's peak (test_torch_bf16.py)
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=str)
@pytest.mark.parametrize("phase_tail", [False, True])
def test_bench_forward_matches_jax(narrow, dtype, phase_tail):
    model, forward = bench.build_infer("AttentionSR", phase_tail=phase_tail,
                                       device="cpu", dtype=dtype)
    _carry(model, phase_tail)
    x = bench.lr_batch(2, 12, "cpu")
    assert x.is_contiguous(memory_format=torch.channels_last)
    got = forward(x).float().permute(0, 2, 3, 1).numpy()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax.jit(_jax_net(jdt, phase_tail).apply)(
        _jax_variables(phase_tail),
        jnp.asarray(x.permute(0, 2, 3, 1).numpy()))
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape == (2, 48, 48, 3)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    else:
        peak = np.abs(want).max()
        np.testing.assert_allclose(got / peak, want / peak, atol=4 * STEP,
                                   rtol=0)


def _jax_step(dtype, hr_u8):
    net = _jax_net(dtype, True)
    v = _jax_variables(True)
    state = JaxState.create(dict(v), jax_make_adam(1e-4))
    step = jax.jit(jax_train_step(net, jax_nlpd, SCALE, "input_conv",
                                  "output_conv"))
    _, metrics = step(state, jnp.asarray(hr_u8))
    lr_img, hr = jax_prepare_batch(jnp.asarray(hr_u8), SCALE)

    def loss_of(params):
        return jax_nlpd(net.apply({"params": params}, lr_img, train=True),
                        hr)

    grads = jax.jit(jax.grad(loss_of))(v["params"])
    return {k: float(m) for k, m in metrics.items()}, grads


def test_bench_train_step_matches_jax(narrow):
    """One float32 bench step (build_train's net, Adam and NLPD step with
    the phase tail) on the bench's seeded uint8 batch: the loss within
    1e-5 relative and the gradient norm within 1e-3 of JAX's step
    (test_torch_training.py's metric tolerance), each raw gradient (left
    in ``.grad`` by the update) within 5e-5 of its leaf's max abs of
    JAX's (test_torch_training.py's gradient tolerance)."""
    state, step = bench.build_train("AttentionSR", device="cpu",
                                    dtype=torch.float32)
    _carry(state.model, True)
    hr = bench.hr_batch(2, 32, "cpu")
    _, metrics = step(state, hr)
    want, jgrads = _jax_step(jnp.float32, hr.numpy())
    assert float(metrics["train_loss"]) == pytest.approx(want["train_loss"],
                                                         rel=1e-5)
    np.testing.assert_allclose(float(metrics["dynamics/grad_norm"]),
                               want["dynamics/grad_norm"], rtol=1e-3)
    assert int(state.step) == 1 and int(state.skipped) == 0
    grads = dict(zip(state.names, (p.grad for p in state.params)))
    expected = params_from_jax(jgrads)
    assert set(grads) == set(expected)
    for name, w in expected.items():
        w = w.numpy()
        scale = np.abs(w).max() + 1e-12
        np.testing.assert_allclose(grads[name].numpy() / scale, w / scale,
                                   atol=5e-5, rtol=0, err_msg=name)


def test_bench_bf16_train_step_loss_matches_jax(narrow):
    """The bench's own step, bf16 compute on float32 master weights: its
    loss within one bf16 step of JAX's bf16 step's (test_torch_bf16.py),
    and the weights float32."""
    state, step = bench.build_train("AttentionSR", device="cpu")
    _carry(state.model, True)
    hr = bench.hr_batch(2, 32, "cpu")
    _, metrics = step(state, hr)
    want, _ = _jax_step(jnp.bfloat16, hr.numpy())
    assert float(metrics["train_loss"]) == pytest.approx(want["train_loss"],
                                                         rel=STEP)
    assert all(p.dtype == torch.float32 for p in state.params)
    assert all(p.grad.dtype == torch.float32 for p in state.params)
