"""The port's supervised training step (food101_sr_tpu_torch.training and
data.prepare_batch) against the JAX package on the CPU.

A small AttentionSR (3 blocks x 32 channels, x4, 32 px crops) carries the
JAX weights (``convert.params_from_jax``, which maps a gradient tree the
same way). Per CLAUDE.md's numerics rule the nets are compared by raw
gradients and by SGD trajectories, never by post-Adam params; the Adam,
clip and EMA wiring is compared on shared gradients with no net."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from food101_sr_tpu.data.pipeline import prepare_batch as jax_prepare_batch
from food101_sr_tpu.losses import get_loss_function as jax_get_loss_function
from food101_sr_tpu.losses import mse_loss as jax_mse
from food101_sr_tpu.models.attention_sr import AttentionSR as JaxAttentionSR
from food101_sr_tpu.training.state import SRTrainState as JaxState
from food101_sr_tpu.training.state import make_adam as jax_make_adam
from food101_sr_tpu.training.steps import make_eval_step as jax_eval_step
from food101_sr_tpu.training.steps import make_forward as jax_make_forward
from food101_sr_tpu.training.steps import make_train_step as jax_train_step
from food101_sr_tpu_torch.convert import params_from_jax
from food101_sr_tpu_torch.data import prepare_batch
from food101_sr_tpu_torch.losses import get_loss_function, mse_loss
from food101_sr_tpu_torch.models import AttentionSR, build_model
from food101_sr_tpu_torch.training import (FIRST_LAST, SRTrainState,
                                           Transform, loss_and_grads,
                                           make_adam, make_eval_step,
                                           make_forward, make_train_step)

SCALE = 4
FIRST, LAST = FIRST_LAST["AttentionSR"]
METRIC_KEYS = {"train_loss", "dynamics/grad_norm", "dynamics/layer_ratio",
               "dynamics/update_ratio", "nonfinite_steps", "nonfinite_total"}


@functools.lru_cache(maxsize=1)
def _jax_net():
    net = JaxAttentionSR(scale_factor=SCALE, num_channels=32, num_residuals=3,
                         phase_tail=False)
    variables = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))
    return net, variables


def _sgd(lr):
    """Plain fused SGD: trajectories compared across frameworks step with
    it, since Adam amplifies reduction-order noise on near-zero grads."""
    return Transform(lambda params, lr_: torch.optim.SGD(params, lr=lr_,
                                                         fused=True), lr)


def _port_net():
    _, variables = _jax_net()
    model = build_model(lambda: AttentionSR(SCALE, 32, 3), device="cpu")
    model.load_state_dict(params_from_jax(variables["params"]), strict=True)
    return model


def _batches(n, batch=2, crop=32, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (batch, crop, crop, 3), dtype=np.uint8)
            for _ in range(n)]


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def test_prepare_batch_matches_jax():
    hr_u8 = _batches(1, batch=3, crop=40)[0]
    want_lr, want_hr = jax_prepare_batch(jnp.asarray(hr_u8), SCALE)
    lr, hr = prepare_batch(torch.from_numpy(hr_u8), SCALE)
    assert lr.shape == (3, 3, 10, 10) and hr.shape == (3, 3, 40, 40)
    assert hr.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(_nhwc(hr), np.asarray(want_hr))
    np.testing.assert_allclose(_nhwc(lr), np.asarray(want_lr), atol=1e-6,
                               rtol=0)


@functools.lru_cache(maxsize=4)
def _jax_value_and_grads(loss_name):
    """JAX make_train_step's value_and_grad path on the shared batch."""
    net, variables = _jax_net()
    loss_fn = jax_get_loss_function(loss_name)
    lr_img, hr = jax_prepare_batch(jnp.asarray(_batches(1)[0]), SCALE)

    def loss_of(params):
        sr, _ = net.apply({"params": params}, lr_img, train=True,
                          mutable=["batch_stats", "spectral"])
        return loss_fn(sr, hr)

    return jax.value_and_grad(loss_of)(variables["params"])


# float32 on both sides, sums in other orders: atol 5e-5 after scaling by
# the leaf's max abs (the tolerance of the reference's gradient parity)
@pytest.mark.parametrize("loss_name", ["mae", "mse", "nlpd"])
def test_raw_gradients_match_jax(loss_name):
    loss, jgrads = _jax_value_and_grads(loss_name)
    model = _port_net()
    got_loss, grads = loss_and_grads(model, get_loss_function(loss_name),
                                     SCALE, torch.from_numpy(_batches(1)[0]))
    assert float(got_loss) == pytest.approx(float(loss), rel=1e-5)
    want = params_from_jax(jgrads)
    got = dict(zip((k for k, _ in model.named_parameters()), grads))
    assert set(got) == set(want)
    for name, w in want.items():
        w = w.numpy()
        scale = np.abs(w).max() + 1e-12
        np.testing.assert_allclose(got[name].numpy() / scale, w / scale,
                                   atol=5e-5, rtol=0, err_msg=name)


def test_sgd_trajectory_and_eval_match_jax():
    """20 SGD steps through both production train steps (NLPD, a new batch
    each step), then both eval steps and forwards on a fresh batch."""
    n_steps, lr = 20, 5e-3
    net, variables = _jax_net()
    jloss = jax_get_loss_function("nlpd")
    tx = optax.inject_hyperparams(
        lambda learning_rate: optax.sgd(learning_rate))(learning_rate=lr)
    jstate = JaxState.create(dict(variables), tx)
    jstep = jax.jit(jax_train_step(net, jloss, SCALE, FIRST, LAST))

    model = _port_net()
    loss_fn = get_loss_function("nlpd")
    state = SRTrainState.create(model, _sgd(lr))
    step = make_train_step(model, loss_fn, SCALE, FIRST, LAST)

    ours, theirs = [], []
    for i, hr_u8 in enumerate(_batches(n_steps, seed=11)):
        jstate, jm = jstep(jstate, jnp.asarray(hr_u8))
        state, m = step(state, torch.from_numpy(hr_u8))
        assert set(m) == set(jm) == METRIC_KEYS
        ours.append(float(m["train_loss"]))
        theirs.append(float(jm["train_loss"]))
        if i == 0:  # the diagnostics of the same gradients, 1e-4 relative
            for k in METRIC_KEYS:
                assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-4,
                                                    abs=1e-12), k
    np.testing.assert_allclose(ours, theirs, rtol=2e-3)
    assert abs(ours[-1] - ours[0]) > 1e-7  # the losses moved
    assert int(state.step) == int(jstate.step) == n_steps
    assert int(state.skipped) == 0

    hr_u8 = _batches(1, seed=99)[0]
    want = jax_eval_step(net, jloss, SCALE)(jstate.params, jstate.extra,
                                             jnp.asarray(hr_u8))
    got = make_eval_step(model, loss_fn, SCALE)(torch.from_numpy(hr_u8))
    assert set(got) == set(want) == {"psnr", "val_loss"}
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=5e-4,
                                   rtol=1e-3, err_msg=k)
    lr_img, _ = jax_prepare_batch(jnp.asarray(hr_u8), SCALE)
    want_sr = jax_make_forward(net)(jstate.params, jstate.extra, lr_img)
    got_sr = make_forward(model)(prepare_batch(torch.from_numpy(hr_u8),
                                               SCALE)[0])
    np.testing.assert_allclose(_nhwc(got_sr), np.asarray(want_sr), atol=5e-4,
                               rtol=1e-3)
    assert not model.training


class _Leaves(nn.Module):
    """Two parameter leaves and no forward: the optimizer's wiring alone."""

    def __init__(self, a, b):
        super().__init__()
        self.a = nn.Parameter(torch.from_numpy(a.copy()))
        self.b = nn.Parameter(torch.from_numpy(b.copy()))


def _adam_moments(opt_state):
    """(mu, nu) of the Adam state inside optax's chain."""
    for s in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState)):
        if isinstance(s, optax.ScaleByAdamState):
            return s.mu, s.nu
    raise AssertionError("no Adam state")


# shared gradients, no net: what differs is only the rounding of the
# update formulas, so 1e-6 abs on params, EMA and moments
def test_adam_clip_and_ema_wiring_match_optax():
    rng = np.random.default_rng(5)
    params = {"a": rng.normal(0, 1, (4, 6)).astype(np.float32),
              "b": rng.normal(0, 1, (7,)).astype(np.float32)}
    lr, decay = 1e-2, 0.9
    jstate = JaxState.create({"params": params}, jax_make_adam(lr, 1.0),
                             ema=True)
    module = _Leaves(params["a"], params["b"])
    state = SRTrainState.create(module, make_adam(lr, clip_norm=1.0),
                                ema=True)
    clipped = []
    for i, size in enumerate((0.1, 3.0, 0.5, 20.0, 1e-3)):
        grads = {k: (rng.normal(0, 1, v.shape) * size).astype(np.float32)
                 for k, v in params.items()}
        clipped.append(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                   for g in grads.values())) >= 1.0)
        if i == 3:  # the plateau schedule's path, on both sides
            jstate = jstate.set_learning_rate(lr / 2)
            state.set_learning_rate(lr / 2)
            assert state.learning_rate == lr / 2
        jstate = jstate.apply_updates(jax.tree_util.tree_map(jnp.asarray,
                                                             grads),
                                      ema_decay=decay)
        state.apply_updates([torch.from_numpy(grads[k]) for k in state.names],
                            ema_decay=decay)
        mu, nu = _adam_moments(jstate.opt_state)
        for j, k in enumerate(state.names):
            moments = state.optimizer.state[state.params[j]]
            for got, want in ((state.params[j], jstate.params[k]),
                              (state.ema[j], jstate.ema_params[k]),
                              (moments["exp_avg"], mu[k]),
                              (moments["exp_avg_sq"], nu[k])):
                np.testing.assert_allclose(got.detach().numpy(),
                                           np.asarray(want), atol=1e-6,
                                           rtol=0, err_msg=f"step {i} {k}")
    assert any(clipped) and not all(clipped)
    assert int(state.step) == int(jstate.step) == 5


def test_clip_is_optax_rule_not_clip_grad_norm():
    """Below the limit the gradient is untouched; above it, scaled to the
    limit exactly as optax.clip_by_global_norm does."""
    from food101_sr_tpu_torch.training.state import clip_by_global_norm

    for size in (0.5, 4.0):
        g = np.full((3, 4), size / np.sqrt(12), np.float32)
        want = optax.clip_by_global_norm(1.0).update({"g": jnp.asarray(g)},
                                                     None)[0]["g"]
        t = [torch.from_numpy(g.copy())]
        clip_by_global_norm(t, torch.linalg.vector_norm(t[0]), 1.0)
        np.testing.assert_array_equal(t[0].numpy(), np.asarray(want))


def _exploding_mse(sr, hr):
    """Finite for normal images, NaN when the batch is all zero."""
    return torch.where(torch.all(hr == 0.0), torch.nan, mse_loss(sr, hr))


def _snapshot(state):
    moments = [v.clone() for s in state.optimizer.state.values()
               for v in s.values()]
    return ([p.detach().clone() for p in state.params], moments,
            [e.clone() for e in state.ema], state.step.clone())


def test_nonfinite_step_guard_keeps_state_and_counts():
    """A NaN loss (an all-zero batch) leaves params, Adam moments and step
    counts, the step and the EMA bit-equal and adds 1 to skipped, which is
    cumulative; training goes on after it."""
    model = _port_net()
    state = SRTrainState.create(model, make_adam(1e-3), ema=True)
    step = make_train_step(model, _exploding_mse, SCALE, FIRST, LAST,
                           ema_decay=0.99)
    good = torch.from_numpy(_batches(1)[0])
    bad = torch.zeros_like(good)

    state, m = step(state, good)
    assert float(m["nonfinite_steps"]) == 0.0
    before = _snapshot(state)
    for n_bad in (1, 2):
        state, m = step(state, bad)
        assert float(m["nonfinite_steps"]) == 1.0
        assert int(m["nonfinite_total"]) == int(state.skipped) == n_bad
        after = _snapshot(state)
        for b, a in zip(jax.tree_util.tree_leaves(before),
                        jax.tree_util.tree_leaves(after)):
            assert torch.equal(b, a)
    state, m = step(state, good)
    assert float(m["nonfinite_steps"]) == 0.0
    assert int(m["nonfinite_total"]) == 2
    assert int(state.step) == 2


def test_jax_guard_agrees_on_the_same_batches():
    """JAX's own step on the same good/bad/good sequence gives the same
    guard metrics."""
    net, variables = _jax_net()

    def exploding(sr, hr):
        return jnp.where(jnp.all(hr == 0.0), jnp.nan, jax_mse(sr, hr))

    jstate = JaxState.create(dict(variables), jax_make_adam(1e-3))
    jstep = jax.jit(jax_train_step(net, exploding, SCALE, FIRST, LAST))
    model = _port_net()
    state = SRTrainState.create(model, make_adam(1e-3))
    step = make_train_step(model, _exploding_mse, SCALE, FIRST, LAST)
    good = _batches(1)[0]
    for hr_u8 in (good, np.zeros_like(good), good):
        jstate, jm = jstep(jstate, jnp.asarray(hr_u8))
        state, m = step(state, torch.from_numpy(hr_u8))
        for k in ("nonfinite_steps", "nonfinite_total"):
            assert float(m[k]) == float(jm[k]), k
    assert int(state.step) == int(jstate.step) == 2


def test_state_needs_a_fused_optimizer_and_its_own_model():
    model = _port_net()
    plain = Transform(lambda p, lr: torch.optim.Adam(p, lr=lr), 1e-3)
    with pytest.raises(ValueError, match="fused"):
        SRTrainState.create(model, plain)
    state = SRTrainState.create(model, make_adam(1e-3))
    step = make_train_step(_port_net(), mse_loss, SCALE, FIRST, LAST)
    with pytest.raises(ValueError, match="another model"):
        step(state, torch.from_numpy(_batches(1)[0]))


def test_adam_hyperparameters():
    opt = SRTrainState.create(_port_net(), make_adam(4e-4)).optimizer
    assert isinstance(opt, torch.optim.Adam)
    assert opt.defaults["betas"] == (0.5, 0.999)
    assert opt.defaults["eps"] == 1e-8 and opt.defaults["lr"] == 4e-4
