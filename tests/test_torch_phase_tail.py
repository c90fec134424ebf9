"""The phase-space upsample tail and the quantized bodies through the
port's nets (food101_sr_tpu_torch.models) against the JAX package's on
the CPU in float32: ResNetSR, AttentionSR and RRDBNet with ``phase_tail``
on and off (one state_dict loaded strictly both ways), AttentionSR at
other scales, the int8, int8_dot and qat bodies, the server's default,
and the committed ResNetSR QAT winner's int8 forward."""
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from food101_sr_tpu.models import model_for_params as jax_model_for_params
from food101_sr_tpu.models.attention_sr import AttentionSR as JaxAttentionSR
from food101_sr_tpu.models.resnet_sr import ResNetSR as JaxResNetSR
from food101_sr_tpu.models.rrdb import RRDBNet as JaxRRDBNet
from food101_sr_tpu_torch.convert import params_from_jax
from food101_sr_tpu_torch.models import (AttentionSR, ResNetSR, RRDBNet,
                                         build_model, model_for_params)
from food101_sr_tpu_torch.serving import SRServer

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
from export_sr_checkpoint import export_state_dict  # noqa: E402

WEIGHTS = Path(__file__).resolve().parent.parent / "weights"

# 2 blocks x 16 channels (RRDB growth 8): JAX net, port net, both taking
# the scale and the two flags
NETS = {
    "RESNET": (lambda s, **kw: JaxResNetSR(scale_factor=s, num_channels=16,
                                           num_residuals=2, **kw),
               lambda s, **kw: ResNetSR(s, 16, 2, **kw)),
    "AttentionSR": (lambda s, **kw: JaxAttentionSR(
        scale_factor=s, num_channels=16, num_residuals=2, **kw),
        lambda s, **kw: AttentionSR(s, 16, 2, **kw)),
    "RRDB": (lambda s, **kw: JaxRRDBNet(scale_factor=s, num_channels=16,
                                        growth=8, num_blocks=2, **kw),
             lambda s, **kw: RRDBNet(s, 16, 8, 2, **kw)),
}


def _lr(n, h, w, seed):
    return np.random.default_rng(seed).uniform(0, 1, (n, h, w, 3)) \
        .astype(np.float32)


def _forward(model, x: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        y = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1).numpy()


@functools.lru_cache(maxsize=None)
def _jax(arch: str, scale: int):
    """Variables of the narrow JAX net (its param tree does not depend on
    the flags); ResNetSR's BatchNorms get seeded running stats."""
    net = NETS[arch][0](scale)
    variables = jax.tree_util.tree_map(np.asarray, dict(
        jax.jit(net.init)(jax.random.PRNGKey(3), jnp.zeros((1, 12, 12, 3)))))
    if "batch_stats" in variables:
        rng = np.random.default_rng(4)
        variables["batch_stats"] = jax.tree_util.tree_map(
            lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32),
            variables["batch_stats"])
    return variables


def _state_dict(variables):
    return params_from_jax(variables["params"],
                           {k: v for k, v in variables.items()
                            if k != "params"})


def _pair(arch, scale, x, **flags):
    """(port output, JAX output) on shared weights with the same flags."""
    variables = _jax(arch, scale)
    want = np.asarray(NETS[arch][0](scale, **flags).apply(
        variables, jnp.asarray(x)))
    model = build_model(lambda: NETS[arch][1](scale, **flags), device="cpu")
    model.load_state_dict(_state_dict(variables), strict=True)
    return _forward(model, x), want


def _levels(a, b):
    return np.abs(np.clip(a, 0, 1) * 255 - np.clip(b, 0, 1) * 255).max()


# float32 on both sides: the same function, sums in another order; 1e-5
# of the output's peak (measured ~3e-6)
@pytest.mark.parametrize("arch,scale", [("RESNET", 4), ("AttentionSR", 4),
                                        ("RRDB", 4), ("AttentionSR", 2),
                                        ("AttentionSR", 3),
                                        ("AttentionSR", 6)])
def test_phase_tail_on_and_off_match_jax(arch, scale):
    x = _lr(2, 12, 12, seed=scale)
    outs = {}
    for phase_tail in (False, True):
        got, want = _pair(arch, scale, x, phase_tail=phase_tail)
        assert got.shape == want.shape == (2, 12 * scale, 12 * scale, 3)
        peak = np.abs(want).max()
        np.testing.assert_allclose(got / peak, want / peak, rtol=0,
                                   atol=1e-5)
        outs[phase_tail] = got
    peak = np.abs(outs[False]).max()
    np.testing.assert_allclose(outs[True] / peak, outs[False] / peak,
                               rtol=0, atol=1e-5)


def test_phase_tail_modules_keep_the_state_dict():
    """The phase tail swaps the shuffle for an identity and routes the
    convs; the parameters, names and shapes are the materialized tail's."""
    a = AttentionSR(4, 16, 2, phase_tail=False)
    b = AttentionSR(4, 16, 2, phase_tail=True)
    assert {k: v.shape for k, v in a.state_dict().items()} == \
        {k: v.shape for k, v in b.state_dict().items()}
    assert [m.phase_in for m in (b.upsample[0], b.upsample[3],
                                 b.output_conv)] == [1, 2, 4]
    assert isinstance(b.upsample[1], torch.nn.Identity)
    assert b.output_conv.phase_in_map is not None
    # the materialized tail's output conv takes the subpixel route at HR
    assert a.output_conv.subpixel_r == 4 and a.output_conv.phase_in == 0


# the int8 bodies quantize activations per sample: a float32 difference
# before a conv can move a value across a rounding boundary, after which
# one int8 step propagates; the nets must stay within 1 uint8 level and
# 60 dB of JAX's (measured: no flip, ~1e-5 abs, ~118 dB)
@pytest.mark.parametrize("arch", list(NETS))
@pytest.mark.parametrize("quantize", ["int8", "int8_dot", "qat"])
def test_quantized_bodies_match_jax(arch, quantize):
    x = _lr(2, 12, 12, seed=11)
    got, want = _pair(arch, 4, x, quantize=quantize, phase_tail=True)
    snr = 10 * np.log10(np.mean(want ** 2) / np.mean((got - want) ** 2))
    assert _levels(got, want) <= 1 and snr >= 60, (_levels(got, want), snr)
    # and it is a different function from the float net's
    model = build_model(lambda: NETS[arch][1](4, phase_tail=True),
                        device="cpu")
    model.load_state_dict(_state_dict(_jax(arch, 4)), strict=True)
    assert np.abs(_forward(model, x) - got).max() > 1e-4


def test_server_runs_the_phase_tail_by_default():
    """SRServer(phase_tail=True), JAX's default: the same uint8 output as
    the materialized tail within 1 level in float32."""
    sd = _state_dict(_jax("AttentionSR", 4))
    img = (_lr(1, 16, 16, seed=2)[0] * 255).astype(np.uint8)
    outs = []
    for flag in (True, False):
        srv = SRServer("auto", state_dict=sd, tile=16, device="cpu",
                       dtype=torch.float32, phase_tail=flag)
        try:
            assert srv.phase_tail is flag and srv.model.phase_tail is flag
            outs.append(srv.upscale(img))
        finally:
            srv.close()
    assert np.abs(outs[0].astype(int) - outs[1]).max() <= 1
    assert SRServer.__init__.__kwdefaults__["phase_tail"] is True


# the committed ResNetSR QAT winner (JAX's Orbax checkpoint) through the
# exporter, an int8 forward of a seeded 2x3x32x32 batch with the phase
# tail in each package (JAX eager): the uint8 outputs within 45 dB PSNR
# of each other, and each package's int8-vs-float32 PSNR within 0.05 dB
# of the other's (measured: 48.52 dB apart; int8 vs float32 42.819 dB in
# the port, 42.772 in JAX, a gap of 0.047 dB: the real weights put
# rounding ties on the int8 grid, which float32 sums in another order
# resolve differently, as JAX's own jit and eager forwards do). The
# AttentionSR winner stays out for the test time it would add.
@pytest.mark.parametrize("name,arch", [("winner_resnet_qat_best", "RESNET")])
def test_qat_winner_int8_forward_matches_jax(name, arch):
    from food101_sr_tpu.training import load_checkpoint

    tree = load_checkpoint(str(WEIGHTS / name))
    ref, ref_arch = export_state_dict(tree)
    assert ref_arch == arch
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in ref.items()}
    variables = {"params": tree["params"], **tree.get("extra", {})}
    x = _lr(2, 32, 32, seed=12)

    def u8(y):
        return np.floor(np.clip(y, 0, 1) * 255 + 0.5)

    def psnr(a, b):
        return 10 * np.log10(255.0 ** 2 / max(np.mean((a - b) ** 2), 1e-12))

    res = {}
    for mode in ("int8", ""):
        jnet = jax_model_for_params(tree["params"], quantize=mode,
                                    phase_tail=True)
        with jax.disable_jit():
            want = np.asarray(jnet.apply(variables, jnp.asarray(x)))
        model = model_for_params(sd, device="cpu", quantize=mode,
                                 phase_tail=True)
        res[mode] = (u8(_forward(model, x)), u8(want))
    got8, want8 = res["int8"]
    assert psnr(got8, want8) >= 45
    gap = psnr(got8, res[""][0]) - psnr(want8, res[""][1])
    assert abs(gap) <= 0.05, gap


@pytest.mark.parametrize("flags", [{"phase_tail": True},
                                   {"phase_tail": True, "quantize": "qat"}])
def test_gradients_keep_the_weights_memory_format(flags):
    """The nets' weights are channels-last; each raw gradient comes back
    with its parameter's strides through the phase convs' gather and the
    QAT conv, as CUDA's fused Adam requires (it refuses mixed layouts)."""
    from food101_sr_tpu_torch.losses import get_loss_function
    from food101_sr_tpu_torch.training import loss_and_grads

    model = build_model(lambda: AttentionSR(4, 16, 2, **flags), device="cpu")
    hr = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 32, 32, 3), np.uint8))
    _, grads = loss_and_grads(model, get_loss_function("mse"), 4, hr)
    for (name, p), g in zip(model.named_parameters(), grads):
        assert g.stride() == p.stride(), name
