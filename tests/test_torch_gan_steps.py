"""The port's GAN steps (food101_sr_tpu_torch.training: make_gan_d_step,
make_gan_g_step, add_noise) against the JAX package's on the CPU, and
their non-finite guard.

AttentionSR narrowed to 2 blocks x 16 channels, the Discriminator at
nf=8, complete VGG19 on weights both packages load from one file, 32 px
crops, batch 2. JAX's instance-noise draws are fed to the port's D step.
Per the repository's numerics rule the steps are compared by raw gradients and
an SGD trajectory, never after Adam. Tolerances are stated per test."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from food101_sr_tpu.data.pipeline import prepare_batch as jax_prepare_batch
from food101_sr_tpu.losses import PerceptualLoss as JaxPerceptualLoss
from food101_sr_tpu.losses import mae_loss as jax_mae
from food101_sr_tpu.losses import tv_loss as jax_tv
from food101_sr_tpu.models.attention_sr import AttentionSR as JaxAttentionSR
from food101_sr_tpu.training.state import SRTrainState as JaxState
from food101_sr_tpu.training.steps import _apply_train
from food101_sr_tpu.training.steps import make_gan_d_step as jax_d_step
from food101_sr_tpu.training.steps import make_gan_g_step as jax_g_step
from food101_sr_tpu_torch.convert import params_from_jax
from food101_sr_tpu_torch.losses import get_loss_function
from food101_sr_tpu_torch.models import AttentionSR, build_model
from food101_sr_tpu_torch.training import (FIRST_LAST, SRTrainState,
                                           Transform, add_noise, make_adam,
                                           make_gan_d_step, make_gan_g_step)
from test_torch_gan import (BATCH, CROP, assert_d_buffers, close, extra_of,
                            jax_d, nchw, port_d, write_vgg_npz)

SCALE, BLOCKS, CHANNELS = 4, 2, 16
FIRST, LAST = FIRST_LAST["AttentionSR"]
G_KEYS = {"train_loss", "dynamics/grad_norm", "dynamics/layer_ratio",
          "dynamics/update_ratio", "nonfinite_steps", "nonfinite_total"}
D_KEYS = {"train_loss_D", "gan_dynamics/prob_real", "gan_dynamics/prob_fake",
          "nonfinite_steps_D", "nonfinite_total_D"}
# one optax transform for every JAX state, so the jitted steps trace once;
# each state sets its own learning rate
JAX_SGD = optax.inject_hyperparams(
    lambda learning_rate: optax.sgd(learning_rate))(learning_rate=1.0)


def _batches(n, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (BATCH, CROP, CROP, 3), dtype=np.uint8)
            for _ in range(n)]


@functools.lru_cache(maxsize=1)
def _jax_g():
    net = JaxAttentionSR(scale_factor=SCALE, num_residuals=BLOCKS,
                         num_channels=CHANNELS, phase_tail=False)
    return net, jax.jit(net.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 8, 8, 3)))


def _port_g():
    model = build_model(lambda: AttentionSR(SCALE, CHANNELS, BLOCKS),
                        device="cpu")
    model.load_state_dict(params_from_jax(_jax_g()[1]["params"]),
                          strict=True)
    return model


def _sgd(lr):
    return Transform(lambda params, lr_: torch.optim.SGD(params, lr=lr_,
                                                         fused=True), lr)


def _jax_noise(key):
    """JAX d_step's two draws for ``key`` (its split, its shapes)."""
    shape = (BATCH, CROP, CROP, 3)
    rng_r, rng_f = jax.random.split(key)
    return (jax.random.normal(rng_r, shape, jnp.float32),
            jax.random.normal(rng_f, shape, jnp.float32))


class _JaxSide:
    """The JAX nets, perceptual loss, jitted steps and the jitted raw
    gradients of the steps' losses (their loss_of, restated)."""

    def __init__(self, vgg_dir):
        self.net, self.gv = _jax_g()
        self.d, self.dv = jax_d()
        self.percep = JaxPerceptualLoss(weights_dir=str(vgg_dir))
        assert self.percep.pretrained
        self.d_step = jax.jit(jax_d_step(self.net, self.d, SCALE))
        self.g_step = jax.jit(jax_g_step(self.net, self.d, self.percep,
                                         SCALE, FIRST, LAST))
        self.d_grads = jax.jit(self._d_grads)
        self.g_grads = jax.jit(self._g_grads)

    def _d_grads(self, g_vars, d_params, d_extra, hr_u8, key):
        lr_img, hr = jax_prepare_batch(hr_u8, SCALE)
        fake = self.net.apply(g_vars, lr_img, train=False)
        nr, nf = _jax_noise(key)

        def loss_of(p):
            rl, ex1 = _apply_train(self.d, p, d_extra, hr + 0.2 * nr)
            fl, _ = _apply_train(self.d, p, ex1, fake + 0.2 * nf)
            return (jnp.mean(optax.sigmoid_binary_cross_entropy(
                rl - jnp.mean(fl), 0.9 * jnp.ones_like(rl)))
                + jnp.mean(optax.sigmoid_binary_cross_entropy(
                    fl - jnp.mean(rl), 0.1 * jnp.ones_like(fl)))) / 2.0

        return jax.grad(loss_of)(d_params)

    def _g_grads(self, g_params, d_vars, hr_u8):
        lr_img, hr = jax_prepare_batch(hr_u8, SCALE)

        def loss_of(gp):
            sr, _ = _apply_train(self.net, gp, {}, lr_img)
            fl, ex1 = _apply_train(self.d, d_vars["params"],
                                   extra_of(d_vars), sr)
            rl, _ = _apply_train(self.d, d_vars["params"], ex1, hr)
            adv = jnp.mean(optax.sigmoid_binary_cross_entropy(
                fl - jnp.mean(jax.lax.stop_gradient(rl)), jnp.ones_like(fl)))
            return (1e-2 * jax_mae(sr, hr) + self.percep(sr, hr)
                    + 1e-5 * adv + 2e-5 * jax_tv(sr))

        return jax.grad(loss_of)(g_params)


@pytest.fixture(scope="module")
def vgg_dir(tmp_path_factory):
    return write_vgg_npz(tmp_path_factory.mktemp("vgg"))


@pytest.fixture(scope="module")
def jside(vgg_dir):
    return _JaxSide(vgg_dir)


class _Pair:
    """Both packages' G and D states (SGD) on shared weights, stepped
    together."""

    def __init__(self, js, vgg_dir, g_lr=1e-2, d_lr=1e-3):
        self.js = js
        self.jg = JaxState.create(dict(js.gv), JAX_SGD).set_learning_rate(
            g_lr)
        self.jd = JaxState.create(dict(js.dv), JAX_SGD).set_learning_rate(
            d_lr)
        self.g = _port_g()
        self.dm = port_d(js.dv["params"], extra_of(js.dv))
        self.percep = get_loss_function("perceptual",
                                        weights_dir=str(vgg_dir),
                                        device="cpu")
        self.gs = SRTrainState.create(self.g, _sgd(g_lr))
        self.ds = SRTrainState.create(self.dm, _sgd(d_lr))
        self.d_step = make_gan_d_step(self.g, self.dm, SCALE)
        self.g_step = make_gan_g_step(self.g, self.dm, self.percep, SCALE,
                                      FIRST, LAST)

    def d_both(self, hr_u8, key):
        self.jd, jm = self.js.d_step(self.jg, self.jd, jnp.asarray(hr_u8),
                                     key)
        nr, nf = _jax_noise(key)
        self.ds, m = self.d_step(self.gs, self.ds, torch.from_numpy(hr_u8),
                                 (nchw(nr), nchw(nf)))
        return m, jm

    def g_both(self, hr_u8):
        self.jg, self.jd, jm = self.js.g_step(self.jg, self.jd,
                                              jnp.asarray(hr_u8))
        self.gs, self.ds, m = self.g_step(self.gs, self.ds,
                                          torch.from_numpy(hr_u8))
        return m, jm


def _d_params(tree) -> dict:
    """A JAX Discriminator params (or gradient) tree by the port's
    parameter names."""
    out = {}
    for i, p in enumerate(("net.0", "net.2", "net.5", "net.8")):
        blk = tree[f"block_{i}"]
        out[f"{p}.weight_orig"] = np.asarray(blk["sn"]["kernel"]) \
            .transpose(3, 2, 0, 1)
        if "bias" in blk:
            out[f"{p}.bias"] = np.asarray(blk["bias"])
    for i, p in ((1, "net.3"), (2, "net.6"), (3, "net.9")):
        out[f"{p}.weight"] = np.asarray(tree[f"bn_{i}"]["scale"])
        out[f"{p}.bias"] = np.asarray(tree[f"bn_{i}"]["bias"])
    for name, p in (("fc1", "classifier.2"), ("fc2", "classifier.4")):
        out[f"{p}.weight_orig"] = np.asarray(tree[name]["sn"]["kernel"]).T
        out[f"{p}.bias"] = np.asarray(tree[name]["bias"])
    return out


def test_d_step_matches_jax(jside, vgg_dir):
    """One D step on JAX's noise: loss and metrics 1e-5 relative; raw
    gradients per leaf 1e-4 of the leaf's max abs (the fake comes from
    two float32 nets and passes three BatchNorms of batch 2); D's u, v
    and running stats 1e-5; the SGD update applied; G untouched."""
    pair = _Pair(jside, vgg_dir)
    hr_u8 = _batches(1)[0]
    key = jax.random.PRNGKey(11)
    jgrads = jside.d_grads(pair.jg.variables(), pair.jd.params,
                           pair.jd.extra, jnp.asarray(hr_u8), key)
    g_before = [p.detach().clone() for p in pair.gs.params]
    m, jm = pair.d_both(hr_u8, key)
    assert set(m) == set(jm) == D_KEYS
    for k in D_KEYS:
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5,
                                            abs=1e-12), k
    want = _d_params(jgrads)
    got = {k: p.grad for k, p in pair.dm.named_parameters()}
    assert got.keys() == want.keys()
    for k in want:
        close(got[k], want[k], 1e-4, k)
    assert_d_buffers(pair.dm, pair.jd.extra, 1e-5)
    after = _d_params(pair.jd.params)
    for k, p in pair.dm.named_parameters():
        close(p, after[k], 1e-5, k)
    assert all(torch.equal(a, b) for a, b in zip(g_before, pair.gs.params))
    assert int(pair.ds.step) == 1 and int(pair.gs.step) == 0
    assert not pair.g.training  # the fake came from an eval-mode forward


def test_g_step_matches_jax(jside, vgg_dir):
    """One G step: loss 1e-5 and diagnostics 1e-4 relative; raw gradients
    per leaf 5e-5 of the leaf's max abs (the supervised step's bound);
    D's u, v and running stats after its two forwards 1e-5; D's params
    and step untouched."""
    pair = _Pair(jside, vgg_dir)
    hr_u8 = _batches(1, seed=5)[0]
    jgrads = jside.g_grads(pair.jg.params, pair.jd.variables(),
                           jnp.asarray(hr_u8))
    d_before = {k: v.clone() for k, v in pair.dm.named_parameters()}
    m, jm = pair.g_both(hr_u8)
    assert set(m) == set(jm) == G_KEYS
    assert float(m["train_loss"]) == pytest.approx(float(jm["train_loss"]),
                                                   rel=1e-5)
    for k in G_KEYS:
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-4,
                                            abs=1e-12), k
    want = params_from_jax(jgrads)
    got = {k: p.grad for k, p in pair.g.named_parameters()}
    assert got.keys() == want.keys()
    for k in want:
        close(got[k], want[k].numpy(), 5e-5, k)
    assert_d_buffers(pair.dm, pair.jd.extra, 1e-5)
    assert all(torch.equal(v, d_before[k])
               for k, v in pair.dm.named_parameters())
    assert int(pair.gs.step) == 1 and int(pair.ds.step) == 0


def test_sgd_trajectory_with_d_cadence_2_matches_jax(jside, vgg_dir):
    """5 iterations, the D step on iterations 0, 2 and 4 (JAX's noise),
    the G step on each, SGD on both: G and D losses within 2e-3
    relative per iteration (the supervised trajectory's bound), D's
    buffers and both nets' params within 1e-4 of their max abs at the
    end."""
    pair = _Pair(jside, vgg_dir, g_lr=5e-2, d_lr=1e-2)
    ours, theirs = [], []
    for i, hr_u8 in enumerate(_batches(5, seed=13)):
        if i % 2 == 0:
            m, jm = pair.d_both(hr_u8, jax.random.PRNGKey(100 + i))
            ours.append(float(m["train_loss_D"]))
            theirs.append(float(jm["train_loss_D"]))
        m, jm = pair.g_both(hr_u8)
        ours.append(float(m["train_loss"]))
        theirs.append(float(jm["train_loss"]))
    np.testing.assert_allclose(ours, theirs, rtol=2e-3)
    assert len(set(ours)) == len(ours)  # the losses moved
    assert_d_buffers(pair.dm, pair.jd.extra, 1e-4)
    want_g = params_from_jax(pair.jg.params)
    for k, p in pair.g.named_parameters():
        close(p, want_g[k].numpy(), 1e-4, k)
    want_d = _d_params(pair.jd.params)
    for k, p in pair.dm.named_parameters():
        close(p, want_d[k], 1e-4, k)
    assert (int(pair.gs.step), int(pair.ds.step)) == (5, 3)
    assert (int(pair.jg.step), int(pair.jd.step)) == (5, 3)


def test_add_noise_draws_from_the_generator_or_takes_the_draws():
    img = torch.zeros(2, 3, 4, 4)
    a = add_noise(img, 0.2, torch.Generator().manual_seed(1))
    b = add_noise(img, 0.2, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and a.std() > 0.1
    noise = torch.randn(2, 3, 4, 4)
    assert torch.equal(add_noise(img, 0.2, noise), 0.2 * noise)
    assert add_noise(img, 0.0, noise) is img


# ---------------------------------------------------------------------------
# the non-finite guard
# ---------------------------------------------------------------------------

def _bits(state) -> list[torch.Tensor]:
    """Params and buffers, optimizer moments and step counts, the EMA,
    step and skipped."""
    return ([t.detach().clone() for t in state.model.state_dict().values()]
            + [v.clone() for s in state.optimizer.state.values()
               for v in s.values()]
            + [e.clone() for e in (state.ema or [])]
            + [state.step.clone(), state.skipped.clone()])


def _same(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_guard_keeps_both_states_on_nonfinite_steps(vgg_dir):
    """With Adam moments in place: NaN noise in a D step leaves D's params,
    moments and buffers bit-equal and ticks D's skipped only; a NaN
    perceptual loss in a G step leaves G's state (EMA included) and D's
    buffers, which its two D forwards moved, bit-equal and ticks G's
    skipped only; the next good G step moves them again."""
    percep = get_loss_function("perceptual", weights_dir=str(vgg_dir),
                               device="cpu")

    def exploding(sr, hr):
        return torch.where(torch.all(hr == 0.0), torch.nan, percep(sr, hr))

    _, dv = jax_d()
    g, d = _port_g(), port_d(dv["params"], extra_of(dv))
    gs = SRTrainState.create(g, make_adam(1e-3, clip_norm=1.0), ema=True)
    ds = SRTrainState.create(d, make_adam(1e-4))
    d_step = make_gan_d_step(g, d, SCALE)
    g_step = make_gan_g_step(g, d, exploding, SCALE, FIRST, LAST,
                             ema_decay=0.9)
    good = torch.from_numpy(_batches(1)[0])
    ds, _ = d_step(gs, ds, good, torch.Generator().manual_seed(0))
    gs, ds, _ = g_step(gs, ds, good)

    g0, d0 = _bits(gs), _bits(ds)
    nan = torch.full((BATCH, 3, CROP, CROP), torch.nan)
    ds, m = d_step(gs, ds, good, (nan, nan))
    assert float(m["nonfinite_steps_D"]) == 1.0
    assert int(m["nonfinite_total_D"]) == int(ds.skipped) == 1
    assert _same(_bits(gs), g0)
    d1 = _bits(ds)
    assert _same(d1[:-1], d0[:-1])  # all but skipped

    gs, ds, m = g_step(gs, ds, torch.zeros_like(good))
    assert float(m["nonfinite_steps"]) == 1.0
    assert int(m["nonfinite_total"]) == int(gs.skipped) == 1
    assert _same(_bits(gs)[:-1], g0[:-1])
    assert _same(_bits(ds), d1)

    gs, ds, m = g_step(gs, ds, good)  # training goes on
    assert float(m["nonfinite_steps"]) == 0.0 and int(gs.step) == 2
    assert not _same(_bits(ds), d1)  # D's buffers moved again
    assert int(ds.skipped) == 1


def test_steps_refuse_a_state_of_another_model():
    _, dv = jax_d()
    g, d = _port_g(), port_d(dv["params"], extra_of(dv))
    gs = SRTrainState.create(_port_g(), make_adam(1e-3))
    ds = SRTrainState.create(d, make_adam(1e-4))
    hr = torch.from_numpy(_batches(1)[0])
    with pytest.raises(ValueError, match="another model"):
        make_gan_d_step(g, d, SCALE)(gs, ds, hr, torch.Generator())
    with pytest.raises(ValueError, match="another model"):
        make_gan_g_step(g, d, lambda a, b: a.mean(), SCALE, FIRST, LAST)(
            gs, ds, hr)
