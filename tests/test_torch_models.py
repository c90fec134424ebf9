"""The port's AttentionSR (food101_sr_tpu_torch.models) against the JAX
net on shared weights, on the CPU in float32: a small net with the JAX
``phase_tail`` on and off, the weight carry-over's key set and strict load,
the registry-size net, and the committed trained checkpoint."""
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from food101_sr_tpu.models import get_model as jax_get_model
from food101_sr_tpu.models.attention_sr import AttentionSR as JaxAttentionSR
from food101_sr_tpu.models.layers import scale_stages as jax_scale_stages
from food101_sr_tpu_torch.convert import params_from_jax
from food101_sr_tpu_torch.models import (AttentionSR, build_model, get_model,
                                         scale_stages)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
from export_sr_checkpoint import export_srnet  # noqa: E402

CKPT = Path(__file__).resolve().parent.parent / "weights" / \
    "winner_attentionsr_best"


def _lr(n, h, w, seed):
    return np.random.default_rng(seed).uniform(0, 1, (n, h, w, 3)) \
        .astype(np.float32)


def _port_forward(model, x_nhwc: np.ndarray) -> np.ndarray:
    """The NHWC batch as a channels-last (N, C, H, W) view, as the server
    hands it to the net."""
    with torch.no_grad():
        y = model(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1).numpy()


@functools.lru_cache(maxsize=2)
def _small_jax(phase_tail: bool):
    net = JaxAttentionSR(scale_factor=4, num_channels=32, num_residuals=2,
                         phase_tail=phase_tail)
    variables = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    return net, variables


def _port_like(params, n_res: int, channels: int):
    model = build_model(lambda: AttentionSR(4, channels, n_res), device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


@pytest.mark.parametrize("scale", [2, 3, 4, 6, 8, 9, 12])
def test_scale_stages_match_jax(scale):
    assert scale_stages(scale) == jax_scale_stages(scale)


# 2 blocks x 32 channels in channels-last memory, float32 on both sides:
# the sums differ only in order, so 1e-4 abs on outputs of magnitude ~3
# (measured ~1e-5).
@pytest.mark.parametrize("phase_tail", [False, True])
def test_attention_sr_matches_jax(phase_tail):
    net, variables = _small_jax(phase_tail)
    x = _lr(2, 16, 12, seed=0)
    want = np.asarray(net.apply(variables, jnp.asarray(x)))
    model = _port_like(variables["params"], 2, 32)
    assert model.input_conv.weight.is_contiguous(
        memory_format=torch.channels_last)
    got = _port_forward(model, x)
    assert got.shape == want.shape == (2, 64, 48, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("layout", [torch.channels_last,
                                    torch.contiguous_format])
def test_se_blocks_receive_channels_last(layout):
    """Whatever the input's layout, the net runs channels-last, so every SE
    squeeze gets a channels-last tensor (the NHWC kernel's input)."""
    _, variables = _small_jax(False)
    model = _port_like(variables["params"], 2, 32)
    seen = []
    hooks = [blk.se.register_forward_pre_hook(
        lambda _, args: seen.append(
            args[0].is_contiguous(memory_format=torch.channels_last)))
        for blk in model.res_blocks]
    x = torch.from_numpy(_lr(2, 16, 12, seed=0)).permute(0, 3, 1, 2)
    try:
        with torch.no_grad():
            y = model(x.contiguous(memory_format=layout))
    finally:
        for h in hooks:
            h.remove()
    assert seen == [True, True]
    assert y.is_contiguous(memory_format=torch.channels_last)


def test_params_from_jax_keys_equal_export_srnet():
    _, variables = _small_jax(False)
    params = variables["params"]
    sd = params_from_jax(params)
    ref = export_srnet(params, {})
    assert set(sd) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    model = build_model(lambda: AttentionSR(4, 32, 2), device="cpu")
    assert set(model.state_dict()) == set(sd)
    model.load_state_dict(sd, strict=True)


def test_params_from_jax_rejects_other_nets():
    with pytest.raises(ValueError):
        params_from_jax({"res_0": {"conv1": {}}})


def test_registry_size_forward():
    """get_model("AttentionSR") is 32 blocks x 96 channels, x4: the same
    parameter count as the JAX registry net, seeded init reproducible, and a
    finite forward at 16x16 LR."""
    model = get_model("AttentionSR", device="cpu")
    assert model.num_residuals == 32 and model.scale_factor == 4
    assert model.input_conv.out_channels == 96
    shapes = jax.eval_shape(
        lambda: jax_get_model("AttentionSR").init(
            jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))))["params"]
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    again = get_model("AttentionSR", device="cpu",
                      generator=torch.Generator().manual_seed(0))
    for (k, a), b in zip(model.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k
    y = _port_forward(model, _lr(1, 16, 16, seed=1))
    assert y.shape == (1, 64, 64, 3) and np.isfinite(y).all()


def test_seeded_init_distributions():
    """Kaiming-normal convs (std sqrt(2/fan_in)), ICNR tail convs (each
    sub-filter repeated scale^2 times), zero biases, PReLU 0.25."""
    model = get_model("AttentionSR", device="cpu",
                      generator=torch.Generator().manual_seed(1))
    w = model.res_blocks[0].conv1.weight.detach()
    assert abs(float(w.std()) - (2.0 / (96 * 9)) ** 0.5) < 0.003
    up = model.upsample[0].weight.detach()  # (256, 96, 3, 3): 64 filters x 4 phases
    assert torch.equal(up[0::4], up[1::4]) and torch.equal(up[0::4], up[3::4])
    assert float(model.mid_conv.bias.detach().abs().max()) == 0.0
    assert float(model.res_blocks[5].prelu.weight.detach()) == 0.25
    fc = model.res_blocks[0].se.fc[0].weight.detach()
    assert float(fc.abs().max()) <= 2.0 * (1.0 / 96) ** 0.5 / 0.8796 + 1e-6


def test_committed_winner_checkpoint_matches_jax():
    """The trained weights/winner_attentionsr_best, read with the JAX
    package's loader here in the test, through both nets at 24x24 LR
    (float32; 1e-4 abs on [0, 1] outputs of 32 blocks)."""
    from food101_sr_tpu.training import load_checkpoint

    params = load_checkpoint(str(CKPT))["params"]
    x = _lr(1, 24, 24, seed=2)
    want = np.asarray(jax_get_model("AttentionSR").apply(
        {"params": params}, jnp.asarray(x)))
    got = _port_forward(_port_like(params, 32, 96), x)
    assert got.shape == (1, 96, 96, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
