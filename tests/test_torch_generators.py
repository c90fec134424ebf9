"""The port's SRCNN, ResNetSR and RRDBNet (food101_sr_tpu_torch.models)
against the JAX package on the CPU in float32: narrow nets on shared
weights (``convert.params_from_jax``) for forwards, raw gradients and a
ResNetSR SGD trajectory; the registry, the state_dict detection and the
converter; the receptive radii; serving (tiled against whole, the "auto"
architecture, the bf16 BatchNorm); the guard over BatchNorm buffers; and
the committed trained checkpoints, read with the JAX package's loader."""
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from food101_sr_tpu.data.pipeline import prepare_batch as jax_prepare_batch
from food101_sr_tpu.losses import get_loss_function as jax_get_loss_function
from food101_sr_tpu.models import get_model as jax_get_model
from food101_sr_tpu.models.attention_sr import AttentionSR as JaxAttentionSR
from food101_sr_tpu.models import model_for_params as jax_model_for_params
from food101_sr_tpu.models import model_names as jax_model_names
from food101_sr_tpu.models.registry import \
    detect_architecture as jax_detect_architecture
from food101_sr_tpu.models.resnet_sr import ResNetSR as JaxResNetSR
from food101_sr_tpu.models.rrdb import RRDBNet as JaxRRDBNet
from food101_sr_tpu.models.srcnn import SRCNN as JaxSRCNN
from food101_sr_tpu.ops.resize import upsample_bicubic
from food101_sr_tpu.parallel.spatial import \
    receptive_radius as jax_receptive_radius
from food101_sr_tpu.training.state import SRTrainState as JaxState
from food101_sr_tpu.training.steps import make_forward as jax_make_forward
from food101_sr_tpu.training.steps import make_train_step as jax_train_step
from food101_sr_tpu_torch.convert import params_from_jax
from food101_sr_tpu_torch.losses import get_loss_function
from food101_sr_tpu_torch.models import (AttentionSR, ResNetSR, RRDBNet,
                                         SRCNN, build_model,
                                         detect_architecture, get_model,
                                         model_for_params, model_names,
                                         param_count)
from food101_sr_tpu_torch.parallel import receptive_radius
from food101_sr_tpu_torch.serving import SRServer
from food101_sr_tpu_torch.training import (FIRST_LAST, SRTrainState,
                                           Transform, loss_and_grads,
                                           make_accum_apply, make_adam,
                                           make_forward, make_grad_step,
                                           make_train_step, snapshot_buffers)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
from export_sr_checkpoint import export_state_dict  # noqa: E402

WEIGHTS = Path(__file__).resolve().parent.parent / "weights"
SCALE = 4

# the narrow nets: SRCNN hidden 16; ResNetSR 2 blocks x 16; RRDB 2 blocks
# x 16, growth 8
JAX_NETS = {
    "SRCNN": lambda: JaxSRCNN(scale_factor=SCALE, hidden_dim=16),
    "RESNET": lambda: JaxResNetSR(scale_factor=SCALE, num_channels=16,
                                  num_residuals=2),
    "RRDB": lambda: JaxRRDBNet(scale_factor=SCALE, num_channels=16, growth=8,
                               num_blocks=2),
}
PORT_NETS = {
    "SRCNN": lambda: SRCNN(SCALE, 16),
    "RESNET": lambda: ResNetSR(SCALE, 16, 2),
    "RRDB": lambda: RRDBNet(SCALE, 16, 8, 2),
}
ARCHS = list(JAX_NETS)


def _lr(n, h, w, seed):
    return np.random.default_rng(seed).uniform(0, 1, (n, h, w, 3)) \
        .astype(np.float32)


def _batches(n, batch=2, crop=32, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (batch, crop, crop, 3), dtype=np.uint8)
            for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _jax(arch: str):
    """The narrow JAX net and its variables; ResNetSR's BatchNorms get
    seeded non-trivial scales, biases and running stats, so that both
    eval-mode normalizations are exercised."""
    net = JAX_NETS[arch]()
    variables = jax.jit(net.init)(jax.random.PRNGKey(1),
                                  jnp.zeros((1, 16, 16, 3)))
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    if arch == "RESNET":
        rng = np.random.default_rng(5)

        def jitter(path, x):
            name = path[-1].key
            if name in ("scale", "var"):
                return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
            if name in ("bias", "mean") and "bn" in str(path):
                return rng.normal(0, 0.1, x.shape).astype(np.float32)
            return x

        variables = jax.tree_util.tree_map_with_path(jitter, variables)
    return net, variables


def _extra(variables):
    return {k: v for k, v in variables.items() if k != "params"}


def _port(arch: str):
    _, variables = _jax(arch)
    model = build_model(PORT_NETS[arch], device="cpu",
                        generator=torch.Generator().manual_seed(7))
    model.load_state_dict(params_from_jax(variables["params"],
                                          _extra(variables)), strict=True)
    return model


def _forward(model, x_nhwc: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        y = model(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1).numpy()


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# ---------------------------------------------------------------------------
# forwards, gradients, the ResNetSR trajectory
# ---------------------------------------------------------------------------

def test_bicubic_pre_upsample_matches_jax():
    """SRCNN's F.interpolate(bicubic, align_corners=False) against JAX's
    upsample_bicubic, borders included (float32, 1e-6 abs)."""
    x = _lr(2, 13, 11, seed=0)
    want = np.asarray(upsample_bicubic(jnp.asarray(x), SCALE))
    got = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=(52, 44),
        mode="bicubic", align_corners=False)
    assert want.shape == (2, 52, 44, 3)
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-6, rtol=0)


# float32 on both sides, sums in other orders: 1e-5 abs on the outputs
# over their largest magnitude (ResNetSR's random-init outputs reach ~9,
# with no residual scaling; eval mode on its seeded running stats). JAX's
# SRCNN takes its subpixel conv3 route here (64 px divide by 4) and RRDB
# its concat layout.
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    net, variables = _jax(arch)
    x = _lr(2, 16, 12, seed=1)
    want = np.asarray(net.apply(variables, jnp.asarray(x)))
    model = _port(arch)
    got = _forward(model, x)
    assert got.shape == want.shape == (2, 64, 48, 3)
    first = model.conv1 if arch == "SRCNN" else model.input_conv
    assert first.weight.is_contiguous(memory_format=torch.channels_last)
    peak = np.abs(want).max()
    np.testing.assert_allclose(got / peak, want / peak, atol=1e-5, rtol=0)


@functools.lru_cache(maxsize=None)
def _jax_grads(arch):
    net, variables = _jax(arch)
    loss_fn = jax_get_loss_function("nlpd")
    lr_img, hr = jax_prepare_batch(jnp.asarray(_batches(1)[0]), SCALE)

    def loss_of(params):
        sr, _ = net.apply({**variables, "params": params}, lr_img,
                          train=True, mutable=["batch_stats"])
        return loss_fn(sr, hr)

    return jax.jit(jax.value_and_grad(loss_of))(variables["params"])


class _SlopeTerms:
    """Forward and gradient hooks on every PReLU of a model: per slope, the
    sum of |g * x| over its negative inputs, the terms its gradient sums."""

    def __init__(self, model):
        self.sums, self.hooks = {}, []
        for name, m in model.named_modules():
            if isinstance(m, torch.nn.PReLU):
                self.hooks.append(m.register_forward_hook(
                    lambda mod, inp, out, n=name: self._keep(n, inp[0], out)))

    def _keep(self, name, x, out):
        def on_grad(g):
            self.sums[f"{name}.weight"] = float(
                (g * x * (x < 0)).abs().sum())
        out.register_hook(on_grad)

    def remove(self):
        for h in self.hooks:
            h.remove()


# the NLPD step's raw gradients, train mode (ResNetSR normalizes by the
# batch's statistics; JAX's RRDB takes its split layout when
# differentiated): per leaf within 5e-5 of the leaf's max abs, the
# tolerance of the AttentionSR step's parity, but for two kinds of leaf
# whose gradient is a cancellation: a conv bias ahead of a train-mode
# BatchNorm has an exact-zero gradient (the batch mean takes it out), so
# both sides give rounding noise, held against its conv weight's max abs;
# a shared PReLU slope sums g*x over every negative input, held against
# that sum's absolute terms
@pytest.mark.parametrize("arch", ARCHS)
def test_raw_gradients_match_jax(arch):
    loss, jgrads = _jax_grads(arch)
    model = _port(arch)
    terms = _SlopeTerms(model)
    try:
        got_loss, grads = loss_and_grads(model, get_loss_function("nlpd"),
                                         SCALE,
                                         torch.from_numpy(_batches(1)[0]))
    finally:
        terms.remove()
    assert float(got_loss) == pytest.approx(float(loss), rel=1e-5)
    want = params_from_jax(jgrads)
    got = dict(zip((k for k, _ in model.named_parameters()), grads))
    assert set(got) == set(want)
    ahead_of_bn = {f"{n[:-3]}conv{n[-1]}.bias" if n != "bn_mid" else
                   "mid_conv.bias" for n, m in model.named_modules()
                   if isinstance(m, torch.nn.BatchNorm2d)}
    for name, w in want.items():
        w = w.numpy()
        if name in ahead_of_bn:
            scale = np.abs(want[name[:-4] + "weight"].numpy()).max()
        elif name in terms.sums:
            scale = terms.sums[name]
        else:
            scale = np.abs(w).max() + 1e-12
        np.testing.assert_allclose(got[name].numpy() / scale, w / scale,
                                   atol=5e-5, rtol=0, err_msg=name)


def _sgd(lr):
    return Transform(lambda params, lr_: torch.optim.SGD(params, lr=lr_,
                                                         fused=True), lr)


def _running_stats(jstate):
    """JAX's BatchNorm running stats under the port's buffer names."""
    tree = jax.tree_util.tree_map(np.asarray, {"params": jstate.params,
                                               **jstate.extra})
    sd = params_from_jax(tree["params"], {"batch_stats": tree["batch_stats"]})
    return {k: v for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


def _stats_off(model, want) -> float:
    """Largest difference of the port's running stats from ``want``, each
    over the buffer's max abs."""
    got = dict(model.named_buffers())
    return max(float((got[k] - v).abs().max() / v.abs().max())
               for k, v in want.items())


def test_resnet_sgd_trajectory_then_eval_match_jax():
    """20 SGD steps of both production train steps on ResNetSR in train
    mode (NLPD, a new batch each step), then both eval forwards. The
    running stats advance by momentum 0.1 with the Bessel-corrected
    variance on both sides (JAX's TorchBatchNorm, torch's BatchNorm2d):
    within 1e-5 of each buffer's max abs after the first step and after
    the twentieth (the Bessel factor n/(n-1), n = 2*8*8, alone moves
    running_var by ~7e-3 of its size over the 20 steps, a wrong momentum
    by far more); the eval outputs within 5e-5 of their
    largest magnitude; the losses within 2e-3 relative, as the AttentionSR
    trajectory's. Each train-mode forward counts one batch. At 5e-3 the
    two float32 trajectories drift apart, faster than at 1e-3, from the
    same rounding differences."""
    n_steps, lr = 20, 1e-3
    net, variables = _jax("RESNET")
    first, last = FIRST_LAST["RESNET"]
    tx = optax.inject_hyperparams(
        lambda learning_rate: optax.sgd(learning_rate))(learning_rate=lr)
    jstate = JaxState.create(dict(variables), tx)
    jstep = jax.jit(jax_train_step(net, jax_get_loss_function("nlpd"), SCALE,
                                   first, last))
    model = _port("RESNET")
    state = SRTrainState.create(model, _sgd(lr))
    step = make_train_step(model, get_loss_function("nlpd"), SCALE, first,
                           last)
    ours, theirs = [], []
    for i, hr_u8 in enumerate(_batches(n_steps, seed=11)):
        jstate, jm = jstep(jstate, jnp.asarray(hr_u8))
        state, m = step(state, torch.from_numpy(hr_u8))
        ours.append(float(m["train_loss"]))
        theirs.append(float(jm["train_loss"]))
        if i == 0:
            assert _stats_off(model, _running_stats(jstate)) <= 1e-5
    np.testing.assert_allclose(ours, theirs, rtol=2e-3)
    assert abs(ours[-1] - ours[0]) > 1e-7
    assert _stats_off(model, _running_stats(jstate)) <= 1e-5
    for k, v in model.named_buffers():
        if k.endswith("num_batches_tracked"):
            assert int(v) == n_steps, k
    lr_img, _ = jax_prepare_batch(jnp.asarray(_batches(1, seed=99)[0]), SCALE)
    want = np.asarray(jax_make_forward(net)(jstate.params, jstate.extra,
                                            lr_img))
    got = _nhwc(make_forward(model)(torch.from_numpy(np.asarray(lr_img))
                                    .permute(0, 3, 1, 2)))
    peak = np.abs(want).max()
    np.testing.assert_allclose(got / peak, want / peak, atol=5e-5, rtol=0)


# ---------------------------------------------------------------------------
# the registry, detection and the converter
# ---------------------------------------------------------------------------

def test_model_names_match_jax():
    assert model_names() == jax_model_names()


@pytest.mark.parametrize("arch", ["SRCNN", "RESNET", "AttentionSR", "RRDB"])
def test_registry_param_counts_match_jax(arch):
    shapes = jax.eval_shape(
        lambda: jax_get_model(arch).init(jax.random.PRNGKey(0),
                                         jnp.zeros((1, 16, 16, 3))))["params"]
    n_jax = sum(int(np.prod(s.shape))
                for s in jax.tree_util.tree_leaves(shapes))
    with torch.device("meta"):
        from food101_sr_tpu_torch.models.registry import _REGISTRY
        model = _REGISTRY[arch](SCALE)
    assert param_count(model) == n_jax
    if arch == "RRDB":
        assert n_jax == 16_896_453
        assert (model.num_blocks, model.num_channels, model.growth) == \
            (23, 64, 32)


# widths, depths and scales outside the registry, as the JAX package's
# own detection test uses; RRDB is the narrow parity net (2 x 16, growth
# 8), whose JAX init alone costs seconds
VARIANTS = {
    "SRCNN": lambda: JaxSRCNN(scale_factor=3, hidden_dim=24),
    "RESNET": lambda: JaxResNetSR(scale_factor=2, num_channels=24,
                                  num_residuals=3),
    "AttentionSR": lambda: JaxAttentionSR(scale_factor=3, num_channels=32,
                                          num_residuals=2),
}


@pytest.mark.parametrize("arch", [*VARIANTS, "RRDB"])
def test_detect_and_model_for_params_on_non_registry_widths(arch):
    """The port's detection and ``model_for_params`` on the port's
    state_dict against JAX's on the params tree: the architecture, the
    widths, depth and scale read from the shapes (``scale_factor=4``
    given, which the upsample stages override), and the forwards (1e-5 of
    their largest magnitude, as test_forward_matches_jax; the JAX side
    eager)."""
    if arch == "RRDB":
        _, variables = _jax(arch)
    else:
        variables = jax.tree_util.tree_map(np.asarray, dict(
            jax.jit(VARIANTS[arch]().init)(jax.random.PRNGKey(2),
                                           jnp.zeros((1, 8, 8, 3)))))
    sd = params_from_jax(variables["params"], _extra(variables))
    assert detect_architecture(sd) == \
        jax_detect_architecture(variables["params"]) == arch
    model = model_for_params(sd, scale_factor=4, device="cpu")
    jmodel = jax_model_for_params(variables["params"], scale_factor=4)
    assert model.scale_factor == jmodel.scale_factor
    for attr in ("num_residuals", "num_channels", "growth", "num_blocks",
                 "hidden_dim"):
        if hasattr(jmodel, attr) and hasattr(model, attr):
            assert getattr(model, attr) == getattr(jmodel, attr), attr
    assert not model.training
    x = _lr(1, 8, 8, seed=3)
    with jax.disable_jit():
        want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    peak = np.abs(want).max()
    np.testing.assert_allclose(_forward(model, x) / peak, want / peak,
                               atol=1e-5, rtol=0)


def test_model_for_params_refusals():
    _, variables = _jax("RESNET")
    sd = params_from_jax(variables["params"], _extra(variables))
    bad = dict(sd, **{"upsample.3.weight": torch.zeros(200, 64, 3, 3)})
    with pytest.raises(ValueError, match="64\\*s\\^2"):
        model_for_params(bad, device="cpu")
    # the quantize modes build (ROADMAP item 8): the body convs take the
    # mode, the head and tail stay float, the weights load strictly
    q = model_for_params(sd, device="cpu", quantize="int8")
    assert (q.quantize, q.res_blocks[0].conv1.quantize,
            q.mid_conv.quantize, q.input_conv.quantize,
            q.output_conv.quantize) == ("int8", "int8", "int8", "", "")
    rrdb = params_from_jax(_jax("RRDB")[1]["params"])
    q = model_for_params(rrdb, device="cpu", quantize="qat")
    assert q.rrdb[1].dense3.conv5.quantize == q.mid_conv.quantize == "qat"
    with pytest.raises(ValueError, match="Unknown quantize mode"):
        model_for_params(sd, device="cpu", quantize="int4")
    srcnn = params_from_jax(_jax("SRCNN")[1]["params"])
    with pytest.raises(ValueError, match="no quantizable body"):
        model_for_params(srcnn, device="cpu", quantize="int8")
    with pytest.raises(ValueError, match="no quantizable body"):
        get_model("SRCNN", device="cpu", quantize="qat")
    with pytest.raises(ValueError, match="matches no known"):
        detect_architecture({"foo.weight": torch.zeros(1)})


@pytest.mark.parametrize("arch", ["SRCNN", "RESNET"])
def test_params_from_jax_equals_export_state_dict(arch):
    """Key for key and value for value the JAX package's exporter's
    reference layout, BatchNorm running stats included, and a strict load
    into the port's net."""
    _, variables = _jax(arch)
    tree = {"params": variables["params"], "extra": _extra(variables)}
    ref, ref_arch = export_state_dict(tree)
    sd = params_from_jax(variables["params"], _extra(variables))
    assert ref_arch == arch
    assert set(sd) == set(ref)
    for k, v in ref.items():
        assert sd[k].numpy().dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    model = build_model(PORT_NETS[arch], device="cpu")
    assert set(model.state_dict()) == set(sd)


def test_rrdb_layouts():
    """"auto", "concat" and "split" build the same net (the layouts'
    parity is in tests/test_torch_registry_options.py); another layout is
    refused."""
    for layout in ("auto", "concat", "split"):
        assert RRDBNet(SCALE, 16, 8, 1, dense_layout=layout).growth == 8
    with pytest.raises(ValueError):
        RRDBNet(SCALE, 16, 8, 1, dense_layout="other")


@torch.no_grad()
def test_seeded_init_distributions():
    """SRCNN kaiming fan_out; RRDB dense convs kaiming x 0.1 and mid_conv
    x 0.01 (fan_in); ResNetSR BatchNorms at ones, zeros and unit running
    variance; ICNR tails; zero biases."""
    gen = torch.Generator().manual_seed(1)
    srcnn = get_model("SRCNN", device="cpu", generator=gen)
    for conv, fan_out in ((srcnn.conv1, 64 * 81), (srcnn.conv3, 3 * 25)):
        assert float(conv.weight.std()) == pytest.approx(
            (2.0 / fan_out) ** 0.5, rel=0.05)
    # the registry's widths at 4 blocks: the fans are the registry net's
    rrdb = build_model(lambda: RRDBNet(SCALE, 64, 32, 4), device="cpu",
                       generator=gen)
    dense = torch.cat([b.dense1.conv1.weight.flatten() for b in rrdb.rrdb])
    assert float(dense.std()) == pytest.approx(0.1 * (2.0 / 576) ** 0.5,
                                               rel=0.02)
    conv5 = rrdb.rrdb[3].dense2.conv5.weight
    assert float(conv5.std()) == pytest.approx(0.1 * (2.0 / (192 * 9)) ** 0.5,
                                               rel=0.03)
    assert float(rrdb.mid_conv.weight.std()) == pytest.approx(
        0.01 * (2.0 / 576) ** 0.5, rel=0.03)
    assert float(rrdb.input_conv.weight.std()) == pytest.approx(
        (2.0 / 27) ** 0.5, rel=0.1)
    up = rrdb.upsample[0].weight
    assert torch.equal(up[0::4], up[3::4])
    assert float(rrdb.rrdb[0].dense3.conv2.bias.abs().max()) == 0.0
    resnet = get_model("RESNET", device="cpu", generator=gen)
    bn = resnet.res_blocks[3].bn2
    assert torch.equal(bn.weight, torch.ones(64))
    assert torch.equal(bn.bias, torch.zeros(64))
    assert torch.equal(bn.running_var, torch.ones(64))
    assert torch.equal(bn.running_mean, torch.zeros(64))
    assert int(bn.num_batches_tracked) == 0


# ---------------------------------------------------------------------------
# receptive radii and serving
# ---------------------------------------------------------------------------

def _meta(fn):
    with torch.device("meta"):
        return fn()


# (name, port net, JAX net, whether it is the registry's size, where the
# name's table holds too)
@pytest.mark.parametrize("arch,port_fn,jax_fn,registry", [
    ("SRCNN", lambda: SRCNN(4, 64), lambda: JaxSRCNN(), True),
    ("RESNET", lambda: ResNetSR(4, 64, 16), lambda: JaxResNetSR(), True),
    ("RESNET", lambda: ResNetSR(4, 16, 2),
     lambda: JaxResNetSR(num_residuals=2), False),
    ("RESNET", lambda: ResNetSR(4, 16, 40),
     lambda: JaxResNetSR(num_residuals=40), False),
    ("AttentionSR", lambda: AttentionSR(4, 96, 32),
     lambda: jax_get_model("AttentionSR"), True),
    ("RRDB", lambda: RRDBNet(4, 64, 32, 23), lambda: jax_get_model("RRDB"),
     True),
    ("RRDB", lambda: RRDBNet(4, 16, 8, 1), lambda: JaxRRDBNet(num_blocks=1),
     False),
    ("RRDB", lambda: RRDBNet(4, 16, 8, 2), lambda: JaxRRDBNet(num_blocks=2),
     False),
])
def test_receptive_radius_matches_jax(arch, port_fn, jax_fn, registry):
    want = jax_receptive_radius(arch, jax_fn())
    assert receptive_radius(arch, _meta(port_fn)) == want
    if registry:
        assert receptive_radius(arch) == jax_receptive_radius(arch) == want


def test_receptive_radius_refuses_an_unknown_net():
    with pytest.raises(ValueError, match="none of"):
        receptive_radius("VDSR")
    with pytest.raises(ValueError, match="none of"):
        receptive_radius(None, torch.nn.Conv2d(3, 3, 3))


def _img(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


# float32: the tiled windows and the whole image are other conv shapes, so
# a pixel may round to the other side of a quantization boundary (1 level)
@pytest.mark.parametrize("arch", ARCHS)
def test_served_tiled_equals_whole_image(arch):
    model = _port(arch)
    srv = SRServer(model=model, dtype=torch.float32, device="cpu", tile=16)
    try:
        halo = srv.halo
        assert halo == {"SRCNN": 8, "RESNET": 20, "RRDB": 40}[arch]
        h, w = 16 * ((16 + 2 * halo) // 16 + 2), 16 * 3 + 5
        img = _img(h, w, seed=4)
        b0 = srv.batcher.n_items
        out = srv.upscale(img)
        assert srv.batcher.n_items - b0 > 1  # went through windows
        pw = (-w) % 16
        whole = srv.forward_u8(torch.from_numpy(
            np.pad(img, ((0, 0), (0, pw), (0, 0)), mode="edge"))[None])[0]
    finally:
        srv.close()
    whole = whole.numpy()[:, : w * SCALE]
    assert out.shape == whole.shape == (h * SCALE, w * SCALE, 3)
    assert np.abs(out.astype(np.int16) - whole.astype(np.int16)).max() <= 1


# each registry net's depth (the halo's only input) at a narrow width:
# SRCNN hidden 16, ResNetSR 16 x 16, AttentionSR 32 x 16, RRDB 2 x 16
# growth 8 (its halo caps at RRDB_EFFECTIVE_RADIUS from 2 blocks on)
@pytest.mark.parametrize("arch,make,halo", [
    ("SRCNN", lambda: SRCNN(SCALE, 16), 8),
    ("RESNET", lambda: ResNetSR(SCALE, 16, 16), 48),
    ("AttentionSR", lambda: AttentionSR(SCALE, 16, 32), 80),
    ("RRDB", lambda: RRDBNet(SCALE, 16, 8, 2), 40),
])
def test_server_auto_picks_the_net_and_halo(arch, make, halo):
    """SRServer("auto", state_dict=...): the class, the halo and the
    weights of the net that made the state_dict."""
    src = build_model(make, device="cpu",
                      generator=torch.Generator().manual_seed(3))
    srv = SRServer("auto", state_dict=src.state_dict(), dtype=torch.float32,
                   device="cpu")
    try:
        assert type(srv.model) is type(src)
        assert (srv.architecture, srv.halo, srv.scale) == (arch, halo, 4)
        assert halo == receptive_radius(arch)  # the registry's table
        for (k, a), b in zip(srv.model.state_dict().items(),
                             src.state_dict().values()):
            assert torch.equal(a, b), k
    finally:
        srv.close()
    with pytest.raises(ValueError, match="state_dict"):
        SRServer("auto", device="cpu")


def test_bf16_server_keeps_batchnorm_in_float32():
    """In a bf16 server the convs run bf16 while ResNetSR's BatchNorms keep
    their parameters and running stats in float32, bit-equal to the
    loaded ones, and normalize in float32, as the JAX package's
    TorchBatchNorm does: each BatchNorm's bf16 output is its float32
    normalization of the bf16 input, rounded once."""
    _, variables = _jax("RESNET")
    sd = params_from_jax(variables["params"], _extra(variables))
    srv = SRServer("auto", state_dict=sd, dtype=torch.bfloat16, device="cpu")
    seen = []
    try:
        assert srv.model.input_conv.weight.dtype == torch.bfloat16
        bns = {n: m for n, m in srv.model.named_modules()
               if isinstance(m, torch.nn.BatchNorm2d)}
        assert len(bns) == 5
        for name, m in bns.items():
            for t in ("weight", "bias", "running_mean", "running_var"):
                got = getattr(m, t)
                assert got.dtype == torch.float32, (name, t)
                assert torch.equal(got, sd[f"{name}.{t}"]), (name, t)
        hooks = [m.register_forward_hook(
            lambda mod, inp, out: seen.append((mod, inp[0], out)))
            for m in bns.values()]
        out = srv.upscale(_img(16, 16, seed=6))
        for h in hooks:
            h.remove()
    finally:
        srv.close()
    assert out.shape == (64, 64, 3) and out.dtype == np.uint8
    assert len(seen) == 5
    for m, x, y in seen:
        assert x.dtype == y.dtype == torch.bfloat16
        want = torch.nn.functional.batch_norm(
            x.float(), m.running_mean, m.running_var, m.weight, m.bias,
            False, 0.0, m.eps).to(torch.bfloat16)
        assert torch.equal(y, want)


# ---------------------------------------------------------------------------
# the guard over the generator's buffers
# ---------------------------------------------------------------------------

def _bits(state):
    return ([t.detach().clone() for t in state.model.state_dict().values()]
            + [v.clone() for s in state.optimizer.state.values()
               for v in s.values()] + [state.step.clone()])


def _nan_loss(sr, hr):
    return torch.where(torch.all(hr == 0.0), torch.nan,
                       torch.mean((sr - hr) ** 2))


@pytest.mark.parametrize("path", ["step", "accum", "gan"])
def test_guard_keeps_batchnorm_buffers_on_a_nan_batch(path):
    """A NaN loss (an all-zero batch) leaves ResNetSR's parameters, Adam's
    state and the BatchNorm running stats and counts bit-equal, with
    skipped 1, through the fused step, the grad-accum group and the GAN's
    G step (a narrow D, nf=8, whose buffers are kept too); a good batch
    then moves the buffers."""
    from food101_sr_tpu_torch.models import Discriminator
    from food101_sr_tpu_torch.training import make_gan_g_step

    model = _port("RESNET")
    first, last = FIRST_LAST["RESNET"]
    state = SRTrainState.create(model, make_adam(1e-3))
    good = torch.from_numpy(_batches(1)[0])
    bad = torch.zeros_like(good)
    if path == "step":
        step = make_train_step(model, _nan_loss, SCALE, first, last)
    elif path == "accum":
        grad_step = make_grad_step(model, _nan_loss, SCALE)
        apply = make_accum_apply(2, first, last)

        def step(state, hr):
            snap = snapshot_buffers(model)
            l1, g1 = grad_step(good)
            l2, g2 = grad_step(hr)
            return apply(state, torch._foreach_add(g1, g2), l1 + l2, snap)
    else:
        d_model = build_model(lambda: Discriminator(nf=8), device="cpu")
        d_state = SRTrainState.create(d_model, make_adam(1e-4))
        g_step = make_gan_g_step(model, d_model, _nan_loss, SCALE, first,
                                 last)

        def step(state, hr):
            state, _, m = g_step(state, d_state, hr)
            return state, m
    state, _ = step(state, good)
    before = _bits(state)
    d_before = [] if path != "gan" else _bits(d_state)
    state, m = step(state, bad)
    after = _bits(state)
    assert float(m["nonfinite_steps"]) == 1.0 and int(state.skipped) == 1
    assert len(before) == len(after)
    for a, b in zip(before, after):
        assert torch.equal(a, b)
    if path == "gan":
        for a, b in zip(d_before, _bits(d_state)):
            assert torch.equal(a, b)
    state, m = step(state, good)
    assert float(m["nonfinite_steps"]) == 0.0
    assert not torch.equal(model.bn_mid.running_mean,
                           before[list(model.state_dict()).index(
                               "bn_mid.running_mean")])


# ---------------------------------------------------------------------------
# the committed trained checkpoints through both packages
# ---------------------------------------------------------------------------

# the JAX side runs eagerly: jit of the 345-conv RRDB costs more compile
# than its forward. float32; 1e-5 abs for SRCNN, 1e-4 for the deep nets
# (the AttentionSR checkpoint's precedent)
@pytest.mark.parametrize("name,arch,atol", [
    ("winner_srcnn_best", "SRCNN", 1e-5),
    ("winner_resnet_best", "RESNET", 1e-4),
    ("winner_rrdb_best", "RRDB", 1e-4),
    ("winner_rrdb_gan_best", "RRDB", 1e-4),
])
def test_committed_checkpoint_matches_jax(name, arch, atol):
    from food101_sr_tpu.training import load_checkpoint

    tree = load_checkpoint(str(WEIGHTS / name))
    params, extra = tree["params"], tree.get("extra", {})
    if arch == "RESNET":
        assert "batch_stats" in extra
    x = _lr(1, 20, 20, seed=8)
    jnet = jax_model_for_params(params)
    with jax.disable_jit():
        want = np.asarray(jnet.apply({"params": params, **extra},
                                     jnp.asarray(x)))
    sd = params_from_jax(params, extra)
    model = model_for_params(sd, device="cpu")
    assert detect_architecture(sd) == arch
    got = _forward(model, x)
    assert got.shape == want.shape == (1, 80, 80, 3)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
