"""bf16 training in the port (a compute dtype on float32 parameters,
``models.set_compute_dtype``) against the JAX package's ``dtype=bfloat16``
on the CPU: the four generators and the Discriminator at narrow widths on
shared weights (forwards, one step's raw gradients), the parameters and
Adam's moments float32 after steps, the compute-dtype forward bit-equal
to the ``.to(torch.bfloat16)`` served one, NLPD on a bf16 prediction, and
``train(dtype="bfloat16")``.

Forwards are held within bf16 steps (2^-8 relative) of JAX's bf16
output, gradients per leaf against JAX's bf16 gradient within a bound set
from the two packages' measured agreement, stated per test: they round to
bf16 at the same points, but their conv sums run in other orders, so a
result that lands near a rounding boundary goes the other way and the
difference travels on through the net."""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

import food101_sr_tpu_torch.models.registry as registry
from food101_sr_tpu.data.pipeline import prepare_batch as jax_prepare_batch
from food101_sr_tpu.losses import PerceptualLoss as JaxPerceptualLoss
from food101_sr_tpu.losses import get_loss_function as jax_get_loss_function
from food101_sr_tpu.losses import mae_loss as jax_mae
from food101_sr_tpu.losses import nlpd_loss as jax_nlpd_loss
from food101_sr_tpu.losses import tv_loss as jax_tv
from food101_sr_tpu.models.attention_sr import AttentionSR as JaxAttentionSR
from food101_sr_tpu.models.discriminator import Discriminator as JaxD
from food101_sr_tpu.models.resnet_sr import ResNetSR as JaxResNetSR
from food101_sr_tpu.models.rrdb import RRDBNet as JaxRRDBNet
from food101_sr_tpu.models.srcnn import SRCNN as JaxSRCNN
from food101_sr_tpu.training.steps import _apply_train
from food101_sr_tpu_torch.convert import discriminator_from_jax, params_from_jax
from food101_sr_tpu_torch.losses import get_loss_function, nlpd_loss
from food101_sr_tpu_torch.models import (SRCNN, AttentionSR, Discriminator,
                                         ResNetSR, RRDBNet, build_model,
                                         get_model)
from food101_sr_tpu_torch.training import (FIRST_LAST, SRTrainState,
                                           Transform, load_checkpoint,
                                           loss_and_grads, make_adam,
                                           make_gan_d_step, make_gan_g_step,
                                           make_train_step, train)
from food101_sr_tpu_torch.utils.term_sums import (BF16_GAN_TOL,
                                                  BF16_GRAD_TOL, term_sums)
from test_torch_gan import extra_of, write_vgg_npz
from test_torch_gan_steps import _d_params

SCALE = 4
BF16 = torch.bfloat16
STEP = 2.0 ** -8  # bf16's relative step (8 significant bits)

# narrow nets (RRDB one block deep: its compile dominates the JAX side),
# the training defaults (phase tail on); RRDB in the concat layout on both
# sides (split re-associates the dense sums, which bf16 rounds
# differently)
JAX_NETS = {
    "SRCNN": lambda dt: JaxSRCNN(scale_factor=SCALE, hidden_dim=16, dtype=dt),
    "RESNET": lambda dt: JaxResNetSR(scale_factor=SCALE, num_channels=16,
                                     num_residuals=2, dtype=dt,
                                     phase_tail=True),
    "AttentionSR": lambda dt: JaxAttentionSR(scale_factor=SCALE,
                                             num_channels=16,
                                             num_residuals=2, dtype=dt,
                                             phase_tail=True),
    "RRDB": lambda dt: JaxRRDBNet(scale_factor=SCALE, num_channels=16,
                                  growth=8, num_blocks=1, dtype=dt,
                                  dense_layout="concat", phase_tail=True),
}
PORT_NETS = {
    "SRCNN": lambda cd: SRCNN(SCALE, 16, compute_dtype=cd),
    "RESNET": lambda cd: ResNetSR(SCALE, 16, 2, phase_tail=True,
                                  compute_dtype=cd),
    "AttentionSR": lambda cd: AttentionSR(SCALE, 16, 2, phase_tail=True,
                                          compute_dtype=cd),
    "RRDB": lambda cd: RRDBNet(SCALE, 16, 8, 1, dense_layout="concat",
                               phase_tail=True, compute_dtype=cd),
}
ARCHS = list(JAX_NETS)
NF, CROP = 8, 32


@functools.lru_cache(maxsize=None)
def _variables(arch: str):
    v = jax.jit(JAX_NETS[arch](None).init)(jax.random.PRNGKey(1),
                                           jnp.zeros((1, 16, 16, 3)))
    return jax.tree_util.tree_map(np.asarray, dict(v))


def _port(arch: str, cd=BF16):
    v = _variables(arch)
    model = build_model(lambda: PORT_NETS[arch](cd), device="cpu")
    model.load_state_dict(params_from_jax(
        v["params"], {k: x for k, x in v.items() if k != "params"}),
        strict=True)
    return model


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _hr(seed=3, n=2) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, CROP, CROP, 3),
                                                dtype=np.uint8)


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------

# eval forwards on an LR image: bf16 out on both sides, within 4 bf16 steps
# (4 * 2^-8) of the output's peak. Measured: 1.6e-3 (SRCNN) to 5.8e-3
# (AttentionSR), where JAX's own bf16 output sits 4.6e-3 to 1.2e-2 from
# its float32 one
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax_bf16(arch):
    x = np.random.default_rng(1).uniform(0, 1, (2, 16, 12, 3)) \
        .astype(np.float32)
    v = _variables(arch)
    want = jax.jit(JAX_NETS[arch](jnp.bfloat16).apply)(v, jnp.asarray(x))
    model = _port(arch)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    want = np.asarray(want.astype(jnp.float32))
    peak = np.abs(want).max()
    np.testing.assert_allclose(_nhwc(got) / peak, want / peak,
                               atol=4 * STEP, rtol=0)


@functools.lru_cache(maxsize=1)
def _jax_d():
    v = jax.jit(lambda k, x: JaxD(nf=NF).init(k, x, train=False))(
        jax.random.PRNGKey(2), jnp.zeros((1, CROP, CROP, 3)))
    return jax.tree_util.tree_map(np.asarray, dict(v))


def _port_d(cd=BF16):
    v = _jax_d()
    model = build_model(lambda: Discriminator(nf=NF, compute_dtype=cd),
                        device="cpu")
    model.load_state_dict(discriminator_from_jax(
        v["params"], {k: x for k, x in v.items() if k != "params"}),
        strict=True)
    return model


def test_discriminator_forward_matches_jax_bf16():
    """Eval-mode logits (stored spectral vectors and running stats) of a
    batch of float32 images and of the same rounded to bf16: bf16 logits
    on both sides within 4 bf16 steps of the logits' peak; the port's
    spectral vectors and BatchNorm statistics stay float32."""
    x = np.random.default_rng(6).uniform(0, 1, (4, CROP, CROP, 3)) \
        .astype(np.float32)
    x = np.concatenate([x, np.asarray(jnp.asarray(x).astype(jnp.bfloat16)
                                      .astype(jnp.float32))])
    want = jax.jit(JaxD(nf=NF, dtype=jnp.bfloat16).apply)(_jax_d(),
                                                          jnp.asarray(x))
    model = _port_d()
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16
    want = np.asarray(want.astype(jnp.float32))
    peak = np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy() / peak, want / peak,
                               atol=4 * STEP, rtol=0)
    assert all(t.dtype == torch.float32 for t in model.state_dict().values()
               if t.is_floating_point())


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

# each leaf of the port's bf16 gradients within LEAF_TOL of its term sum
# (utils/term_sums.py) from the reference that _assert_leaves names: 1.5
# times the largest distance measured on these nets (0.040, the D step's
# net.6.weight, a BatchNorm scale), rounded up to a power of two
LEAF_TOL = 2.0 ** -4
# the card's bounds of bf16-vs-float32 gradients at registry size
# (utils/term_sums.py, read by chip_smoke.py), which twice the
# calibrations below must not exceed: BF16_GRAD_TOL (float rounding
# alone: the supervised steps, and the GAN steps with the float32 pass's
# activation branches), twice the smaller of the two packages' own
# distances; BF16_GAN_TOL (the GAN steps as they run, where an activation
# near 0 may take the other branch), twice the larger


def _reduced(model) -> set:
    """The leaves whose JAX bf16 gradient is a bf16 sum of a broadcast
    parameter's cotangent over the batch and the image: conv and linear
    biases and PReLU slopes. The port sums those in float32 and rounds
    once; at SRCNN's biases, summed over the HR image, JAX's bf16 sum is
    0.53 of a term sum from the float32 one."""
    from torch import nn

    out = set()
    for n, m in model.named_modules():
        if isinstance(m, nn.PReLU):
            out.add(f"{n}.weight")
        elif (isinstance(getattr(m, "bias", None), nn.Parameter)
              and not isinstance(m, nn.BatchNorm2d)):
            out.add(f"{n}.bias")
    return out


def _f32_pass(model_f32, loss_of) -> tuple[dict, dict]:
    """The float32 gradients by name and, per parameter, the largest sum
    of absolute terms behind one entry of its gradient (``term_sums``)."""
    with term_sums(model_f32, {}) as sums:
        grads = loss_of(model_f32)[1]
    return dict(zip((k for k, _ in model_f32.named_parameters()),
                    grads)), sums


def _assert_leaves(model, got: dict, want_bf16: dict, f32: dict,
                   sums: dict, pin: float | None = None
                   ) -> tuple[float, float]:
    """Per leaf, in units of its term sum: the port's bf16 gradient (of
    ``model``) within LEAF_TOL of JAX's bf16 gradient; at the leaves JAX
    sums in bf16 (``_reduced``) within LEAF_TOL of the float32 gradient
    instead. The float32 gradient is the port's, which holds JAX's within
    5e-5 of a leaf's max abs (test_torch_generators.py,
    test_torch_gan_steps.py). With ``pin``, the other leaves' distances
    from JAX's bf16 gradient, summed, within ``pin`` times JAX's own
    bf16-to-float32 distances summed: a backward left in float32 reads 1
    there, a bf16 one that rounds where JAX rounds reads far less.

    Returns the calibrations of chip_smoke.py's bounds: over the leaves,
    the largest of the smaller and the largest of the larger of the two
    packages' own bf16-vs-float32 distances (they differ most where JAX
    sums in bf16)."""
    assert got.keys() == want_bf16.keys() == f32.keys()
    reduced = _reduced(model)
    assert reduced <= got.keys()
    calib, widest, near, own_jax = 0.0, 0.0, 0.0, 0.0
    for k, w in want_bf16.items():
        g, w = got[k], torch.as_tensor(w)
        assert g.dtype == torch.float32, k
        s = sums[k] + 1e-30
        ref = float((w - f32[k]).abs().max()) / s
        own = float((g - f32[k]).abs().max()) / s
        err = own if k in reduced else float((g - w).abs().max()) / s
        assert err <= LEAF_TOL, (k, err, "float32" if k in reduced
                                 else "JAX bf16")
        if k not in reduced:
            near, own_jax = near + err, own_jax + ref
        calib = max(calib, min(ref, own))
        widest = max(widest, ref, own)
    if pin is not None:
        assert near <= pin * own_jax, (near, own_jax)
    return calib, widest


def _assert_bf16_backward(model, got: dict) -> None:
    """Every leaf outside BatchNorm (which runs in float32) holds bf16
    values: the last op of its backward, the cotangent of the parameter's
    cast to the compute dtype, ran in bf16. A float32 backward leaves
    nearly every entry between two bf16 values (measured: at most 12% of a
    leaf's entries on bf16 values, SRCNN; 0.003% AttentionSR). JAX's own
    conv weight gradients on the CPU are float32 sums (XLA folds the cast
    into the conv), so this holds the port's path, and the leaves' bounds
    against JAX's bf16 gradient hold its values."""
    from torch import nn

    bn = {f"{n}.{p}" for n, m in model.named_modules()
          if isinstance(m, nn.BatchNorm2d) for p in ("weight", "bias")}
    off = [k for k, g in got.items()
           if k not in bn and not torch.equal(g, g.to(BF16).float())]
    assert off == [], off


def _jax_grads(arch: str, dtype, hr_u8: np.ndarray):
    net, v = JAX_NETS[arch](dtype), _variables(arch)
    lr_img, hr = jax_prepare_batch(jnp.asarray(hr_u8), SCALE)
    loss_fn = jax_get_loss_function("nlpd")

    def loss_of(params):
        sr, _ = net.apply({**v, "params": params}, lr_img, train=True,
                          mutable=["batch_stats"])
        return loss_fn(sr, hr)

    loss, grads = jax.jit(jax.value_and_grad(loss_of))(v["params"])
    return float(loss), {k: t.numpy() for k, t in
                         params_from_jax(grads).items()}


# the NLPD step's raw gradients in train mode on 2 crops (the supervised
# step, ResNetSR normalizing by the batch): the loss within 2^-8 relative,
# each leaf as _assert_leaves says. Measured, the largest distance from
# JAX's bf16 gradient (from the float32 one at the leaves JAX sums in
# bf16): SRCNN 0.0061 (0.014), RESNET 0.011 (0.021), AttentionSR 0.023
# (0.014), RRDB 0.0094 (0.017); the summed distances over JAX's own 0.32,
# 0.089, 0.89 and 0.30 (PINS: AttentionSR's SE blocks send the two bf16
# gradients as far apart as each sits from float32, leaf by leaf too:
# 0.54-3.2 of JAX's own distance, output_conv's 0.75; there
# _assert_bf16_backward, which every arch runs, pins the bf16 backward)
PINS = {"SRCNN": 0.5, "RESNET": 0.5, "AttentionSR": None, "RRDB": 0.5}


@pytest.mark.parametrize("arch", ARCHS)
def test_raw_gradients_match_jax_bf16(arch):
    hr_u8 = _hr()
    want_loss, want = _jax_grads(arch, jnp.bfloat16, hr_u8)

    def loss_of(model):
        return loss_and_grads(model.train(), get_loss_function("nlpd"),
                              SCALE, torch.from_numpy(hr_u8))

    model = _port(arch)
    loss, grads = loss_of(model)
    assert float(loss) == pytest.approx(want_loss, rel=STEP)
    got = dict(zip((k for k, _ in model.named_parameters()), grads))
    f32, sums = _f32_pass(_port(arch, None), loss_of)
    calib, _ = _assert_leaves(model, got, want, f32, sums, pin=PINS[arch])
    _assert_bf16_backward(model, got)
    # a backward left in float32 holds values between bf16's, and fails
    with pytest.raises(AssertionError):
        _assert_bf16_backward(model, f32)
    if PINS[arch] is not None:
        # it also reads 1 on the pin, and fails there
        with pytest.raises(AssertionError):
            _assert_leaves(model, f32, want, f32, sums, pin=PINS[arch])
    # the card's bf16-vs-float32 bound is twice this at least (measured:
    # 0.016 SRCNN, 0.050 RESNET, 0.020 AttentionSR, 0.019 RRDB)
    assert 2 * calib <= BF16_GRAD_TOL


# the GAN steps: the narrow AttentionSR (phase tail) and the D at nf=8 in
# bf16 on JAX's init, 2 crops, VGG19 seeded; fused SGD at lr 0 leaves the
# port's raw gradients in .grad
GAN_SGD0 = Transform(lambda params, lr: torch.optim.SGD(params, lr=lr,
                                                        fused=True), 0.0)


def _jax_gan_nets(dtype):
    return JAX_NETS["AttentionSR"](dtype), JaxD(nf=NF, dtype=dtype)


def _port_gan(cd):
    g, d = _port("AttentionSR", cd), _port_d(cd)
    return g, d, SRTrainState(g, GAN_SGD0), SRTrainState(d, GAN_SGD0)


def test_discriminator_step_gradients_match_jax_bf16():
    """One D step (relativistic average BCE, labels 0.9 and 0.1, real
    then fake through two chained train-mode forwards) on the fake of an
    eval-mode G forward, both noised by the same draws (the fake's in
    bf16, as JAX draws them): D's raw gradients as _assert_leaves says.
    Measured: 0.040 of a term sum from JAX's bf16 gradient at net.6.weight
    (a BatchNorm scale), 0.0043 from the float32 one at the leaves JAX
    sums in bf16; the two packages' own bf16-vs-float32 distances 0.038
    at the least and 0.039 at the most; the summed distances over JAX's
    own 0.98 (no ``pin``: D's three train-mode BatchNorms send the two
    bf16 gradients as far apart as each sits from float32)."""
    hr_u8 = _hr(seed=5)
    rng = np.random.default_rng(9)
    nr, nf = (rng.standard_normal((2, CROP, CROP, 3)).astype(np.float32)
              for _ in range(2))
    nf = np.asarray(jnp.asarray(nf).astype(jnp.bfloat16).astype(jnp.float32))
    v, dv = _variables("AttentionSR"), _jax_d()

    def jax_grads(dtype):
        net, d = _jax_gan_nets(dtype)

        def grads(dp):
            lr_img, hr = jax_prepare_batch(jnp.asarray(hr_u8), SCALE)
            fake = net.apply(v, lr_img, train=False)
            fk = fake + 0.2 * jnp.asarray(nf).astype(fake.dtype)

            def loss_of(p):
                rl, ex1 = _apply_train(d, p, extra_of(dv), hr + 0.2 * nr)
                fl, _ = _apply_train(d, p, ex1, fk)
                return (jnp.mean(optax.sigmoid_binary_cross_entropy(
                    rl - jnp.mean(fl), 0.9 * jnp.ones_like(rl)))
                    + jnp.mean(optax.sigmoid_binary_cross_entropy(
                        fl - jnp.mean(rl), 0.1 * jnp.ones_like(fl)))) / 2.0

            return jax.grad(loss_of)(dp)

        g = jax.jit(grads)(dv["params"])
        return {k: np.asarray(t, np.float32) for k, t in _d_params(g).items()}

    def port_step(cd):
        g, d, gs, ds = _port_gan(cd)
        n = [torch.from_numpy(a).permute(0, 3, 1, 2) for a in (nr, nf)]
        if cd is not None:
            n[1] = n[1].to(cd)
        step = make_gan_d_step(g, d, SCALE)
        return d, lambda: step(gs, ds, torch.from_numpy(hr_u8), n)

    d, run = port_step(BF16)
    run()
    got = {k: p.grad.clone() for k, p in d.named_parameters()}
    d32, run32 = port_step(None)
    with term_sums(d32, {}) as sums:
        run32()
    f32 = {k: p.grad.clone() for k, p in d32.named_parameters()}
    calib, widest = _assert_leaves(d, got, jax_grads(jnp.bfloat16), f32,
                                   sums)
    assert 2 * calib <= BF16_GRAD_TOL and 2 * widest <= BF16_GAN_TOL


def test_generator_gan_step_gradients_match_jax_bf16(tmp_path):
    """One G step (1e-2 MAE + perceptual + 1e-5 relativistic BCE + 2e-5
    TV; D in train mode on the fake, then on the real without a graph):
    G's raw gradients as _assert_leaves says, the loss within 2^-7
    relative. Measured: 0.030 of a term sum from JAX's bf16 gradient at
    an SE block's first weight, 0.013 from the float32 one at the leaves
    JAX sums in bf16; the two packages' own bf16-vs-float32 distances
    0.039 at the least and 0.066 at the most (JAX's, at that SE weight);
    the summed distances over JAX's own 0.53."""
    write_vgg_npz(tmp_path)
    hr_u8 = _hr(seed=5)
    v, dv = _variables("AttentionSR"), _jax_d()
    percep = JaxPerceptualLoss(weights_dir=str(tmp_path))
    assert percep.pretrained

    def jax_loss_of(dtype):
        net, d = _jax_gan_nets(dtype)

        def loss_of(gp):
            lr_img, hr = jax_prepare_batch(jnp.asarray(hr_u8), SCALE)
            sr, _ = _apply_train(net, gp, extra_of(v), lr_img)
            fl, ex1 = _apply_train(d, dv["params"], extra_of(dv), sr)
            rl, _ = _apply_train(d, dv["params"], ex1, hr)
            adv = jnp.mean(optax.sigmoid_binary_cross_entropy(
                fl - jnp.mean(jax.lax.stop_gradient(rl)), jnp.ones_like(fl)))
            return (1e-2 * jax_mae(sr, hr) + percep(sr, hr) + 1e-5 * adv
                    + 2e-5 * jax_tv(sr))

        return loss_of

    want_loss, jg = jax.jit(jax.value_and_grad(jax_loss_of(jnp.bfloat16)))(
        v["params"])
    first, last = FIRST_LAST["AttentionSR"]
    pl = get_loss_function("perceptual", weights_dir=str(tmp_path),
                           device="cpu")

    def port_step(cd):
        g, d, gs, ds = _port_gan(cd)
        step = make_gan_g_step(g, d, pl, SCALE, first, last)
        return g, lambda: step(gs, ds, torch.from_numpy(hr_u8))[2]

    g, run = port_step(BF16)
    m = run()
    assert float(m["train_loss"]) == pytest.approx(float(want_loss),
                                                   rel=2 * STEP)
    got = {k: p.grad.clone() for k, p in g.named_parameters()}
    g32, run32 = port_step(None)
    with term_sums(g32, {}) as sums:
        run32()
    f32 = {k: p.grad.clone() for k, p in g32.named_parameters()}
    want = {k: t.numpy() for k, t in params_from_jax(jg).items()}
    calib, widest = _assert_leaves(g, got, want, f32, sums, pin=0.75)
    assert 2 * calib <= BF16_GRAD_TOL and 2 * widest <= BF16_GAN_TOL
    with pytest.raises(AssertionError):  # a float32 backward fails
        _assert_leaves(g, f32, want, f32, sums, pin=0.75)
    _assert_bf16_backward(g, got)
    with pytest.raises(AssertionError):
        _assert_bf16_backward(g, f32)


# ---------------------------------------------------------------------------
# float32 master weights, the served forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_adam_moments_stay_float32(arch):
    """Three bf16 train steps with Adam (JAX's tests/test_training.py
    holds its bf16 step so): the parameters, their gradients and Adam's
    moments stay float32, and the losses are finite. The EMA too."""
    model = _port(arch).train()
    first, last = FIRST_LAST[arch]
    state = SRTrainState.create(model, make_adam(1e-3), ema=True)
    step = make_train_step(model, get_loss_function("nlpd"), SCALE, first,
                           last, ema_decay=0.9)
    losses = []
    for i in range(3):
        state, m = step(state, torch.from_numpy(_hr(seed=i)))
        losses.append(float(m["train_loss"]))
    assert np.all(np.isfinite(losses)) and int(state.skipped) == 0
    assert all(p.dtype == torch.float32 for p in state.params)
    assert all(e.dtype == torch.float32 for e in state.ema)
    moments = [t for s in state.optimizer.state.values()
               for k, t in s.items() if k != "step"]
    assert moments and all(t.dtype == torch.float32 for t in moments)


def test_bf16_srcnn_loss_falls_as_in_jax():
    """JAX's test_train_step_bfloat16_dtype: SRCNN x2 in bf16, MSE, Adam
    1e-3, six steps on one batch of eight 32 px crops: the loss falls."""
    model = get_model("SRCNN", scale_factor=2, device="cpu",
                      compute_dtype=BF16).train()
    state = SRTrainState.create(model, make_adam(1e-3))
    step = make_train_step(model, get_loss_function("mse"), 2, "conv1",
                           "conv3")
    hr = torch.from_numpy(_hr(seed=4, n=8))
    losses = [float(step(state, hr)[1]["train_loss"]) for _ in range(6)]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_compute_dtype_forward_equals_served_bf16(arch):
    """The registry net at full width with a bf16 compute dtype on float32
    weights, and the same seeded weights cast to bf16 as a server holds
    them: eval forwards of one bf16 input are bit-equal (each conv casts
    to the values the served weights hold), and the weights stay float32."""
    x = torch.rand((1, 3, 12, 12), generator=torch.Generator().manual_seed(0))
    x = x.to(BF16)
    served = get_model(arch, dtype=BF16, device="cpu", phase_tail=True)
    computed = get_model(arch, device="cpu", phase_tail=True,
                         compute_dtype=BF16)
    assert all(p.dtype == torch.float32 for p in computed.parameters())
    with torch.no_grad():
        a, b = served(x), computed(x)
    assert a.dtype == b.dtype == BF16
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# NLPD on a bf16 prediction
# ---------------------------------------------------------------------------

def test_nlpd_on_a_bf16_pred_matches_jax():
    """A bf16 prediction against a float32 target: the port's NLPD keeps
    the prediction's pyramid in bf16 between ops, as JAX's does; loss
    within 1e-6 relative and its gradient to the prediction equal in bf16.
    Promoting the prediction to float32 first (one shared float32
    pyramid) is off by 8e-5 relative, and its gradient by a third of the
    peak."""
    rng = np.random.default_rng(0)
    pred = jnp.asarray(rng.uniform(0, 1, (2, CROP, CROP, 3))).astype(
        jnp.bfloat16)
    target = rng.uniform(0, 1, (2, CROP, CROP, 3)).astype(np.float32)
    want, gw = jax.value_and_grad(
        lambda p: jax_nlpd_loss(p, jnp.asarray(target)))(pred)
    gw = np.asarray(gw.astype(jnp.float32))
    p = torch.from_numpy(np.asarray(pred.astype(jnp.float32))) \
        .permute(0, 3, 1, 2).to(BF16).requires_grad_(True)
    t = torch.from_numpy(target).permute(0, 3, 1, 2)
    got = nlpd_loss(p, t)
    got.backward()
    assert got.dtype == torch.float32 and p.grad.dtype == BF16
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    np.testing.assert_array_equal(_nhwc(p.grad), gw)

    q = p.detach().clone().requires_grad_(True)
    promoted = nlpd_loss(q.float(), t)
    promoted.backward()
    assert abs(float(promoted) - float(want)) > 1e-5 * float(want)
    assert np.abs(_nhwc(q.grad) - gw).max() > 0.1 * np.abs(gw).max()


# ---------------------------------------------------------------------------
# train(dtype="bfloat16")
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loss", ["nlpd", "gan"])
def test_train_bfloat16_best_checkpoint_loads_into_float32(loss, tmp_path,
                                                           monkeypatch):
    """train(dtype="bfloat16") on the narrow AttentionSR for an epoch
    (NLPD, or the GAN with its D in bf16): finite metrics and losses, and
    the best checkpoint holds float32 tensors that load strictly into the
    float32 registry model, whose forward is finite."""
    monkeypatch.setitem(registry._REGISTRY, "AttentionSR",
                        lambda scale, **flags: AttentionSR(scale, 16, 2,
                                                          **flags))
    monkeypatch.setenv("FOOD101_SR_RUN_DIR", str(tmp_path / "runs"))
    out = train(dict(dataset="synthetic", architecture="AttentionSR",
                     synthetic_size=48, crop_size=CROP, batch_size=8,
                     epochs=1, log_every=1, dtype="bfloat16",
                     loss_function=loss, d_update_every=2,
                     weights_dir=str(tmp_path / "w"), save_name="bf",
                     run_name="bf", use_wandb=False), device="cpu")
    assert all(np.isfinite(v) for v in out.values())
    steps = [json.loads(line) for line in
             (tmp_path / "runs" / "bf" / "log.jsonl").read_text()
             .splitlines() if "train_loss" in line]
    assert len(steps) == 5 and all(np.isfinite(r["train_loss"])
                                   and r["nonfinite_steps"] == 0
                                   for r in steps)
    sd = load_checkpoint(str(tmp_path / "w" / "bf_best.pth"))
    assert all(v.dtype == torch.float32 for v in sd.values())
    model = registry.get_model("AttentionSR", device="cpu")
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        y = model(torch.rand(1, 3, 8, 8))
    assert y.dtype == torch.float32 and torch.isfinite(y).all()
