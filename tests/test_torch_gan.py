"""The port's GAN modules (food101_sr_tpu_torch: the spectral-norm
layers, the Discriminator, VGG19Features, PerceptualLoss and the weight
converters) against the JAX package on the CPU, and the committed
GAN-trained generator. The D and G steps are in test_torch_gan_steps.py,
which shares this file's helpers.

Small sizes: the Discriminator at nf=8 (nf=64 for the converter), 32 px
inputs, batch 2; VGG19 is complete. Weights are JAX's, carried over with
``convert``. Tolerances are stated per test: float32 on both sides, sums
in other orders."""
import functools
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from food101_sr_tpu.losses import PerceptualLoss as JaxPerceptualLoss
from food101_sr_tpu.models import get_model as jax_get_model
from food101_sr_tpu.models.discriminator import Discriminator as JaxD
from food101_sr_tpu.models.feature_nets import VGG19Features as JaxVGG
from food101_sr_tpu.models.layers import SNConv, SNDense
from food101_sr_tpu.training.steps import _apply_train
from food101_sr_tpu_torch.convert import (discriminator_from_jax,
                                          params_from_jax, vgg19_from_jax)
from food101_sr_tpu_torch.losses import PerceptualLoss, get_loss_function
from food101_sr_tpu_torch.models import (AttentionSR, Discriminator,
                                         SNConv2d, SNLinear, VGG19Features,
                                         build_model, layers)

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
from export_sr_checkpoint import export_discriminator  # noqa: E402

NF, CROP, BATCH = 8, 32, 2


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def nchw(x) -> torch.Tensor:
    return _t(x).permute(0, 3, 1, 2)


def close(got, want, tol, msg=""):
    """|got - want| <= tol * max|want| (a leaf's own scale). A leaf that is
    exactly 0 in JAX (the last layer's bias under the relativistic loss,
    whose real and fake terms cancel) is held to 1e-6 absolute: float32
    rounding of terms of order 1."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = np.abs(want).max() or 1e-6 / max(tol, 1e-12)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0,
                               err_msg=msg)


# ---------------------------------------------------------------------------
# spectral-norm layers
# ---------------------------------------------------------------------------

def _sn_pair(kind: str):
    """A JAX SNConv (4 -> 6, 3x3, stride 2) or SNDense (7 -> 5) with its
    variables, the port's layer carrying them, and a seeded input."""
    rng = np.random.default_rng(0)
    if kind == "conv":
        x = rng.normal(0, 1, (2, 9, 9, 4)).astype(np.float32)
        jl = SNConv(6, 3, strides=2)
        v = jl.init(jax.random.PRNGKey(1), jnp.asarray(x))
        k = np.asarray(v["params"]["sn"]["kernel"])
        layer = SNConv2d(4, 6, 3, stride=2)
        w = k.transpose(3, 2, 0, 1)
        vv = np.asarray(v["spectral"]["sn"]["v"]).reshape(3, 3, 4) \
            .transpose(2, 0, 1).ravel()
        xt = nchw(x)
    else:
        x = rng.normal(0, 1, (3, 7)).astype(np.float32)
        jl = SNDense(5)
        v = jl.init(jax.random.PRNGKey(1), jnp.asarray(x))
        w = np.asarray(v["params"]["sn"]["kernel"]).T
        vv = np.asarray(v["spectral"]["sn"]["v"])
        layer = SNLinear(7, 5)
        xt = _t(x)
    layer.load_state_dict({"weight_orig": _t(w), "bias": _t(v["params"]["bias"])
                           + 0.1, "weight_u": _t(v["spectral"]["sn"]["u"]),
                           "weight_v": _t(vv)})
    v = {"params": {**v["params"], "bias": v["params"]["bias"] + 0.1},
         "spectral": v["spectral"]}
    return jl, v, x, layer, xt


def _port_out(y: torch.Tensor) -> np.ndarray:
    y = y.detach()
    return (y.permute(0, 2, 3, 1) if y.ndim == 4 else y).numpy()


# outputs, updated u/v and raw gradients within 1e-5 of their max abs
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("kind", ["conv", "dense"])
def test_sn_layer_matches_jax(kind, train):
    jl, v, x, layer, xt = _sn_pair(kind)

    def loss_of(params):
        y, upd = jl.apply({"params": params, "spectral": v["spectral"]},
                          jnp.asarray(x), update_stats=train,
                          mutable=["spectral"])
        return jnp.sum(y ** 2), (y, upd)

    (_, (want_y, upd)), jgrads = jax.value_and_grad(loss_of, has_aux=True)(
        v["params"])
    layer.train(train)
    y = layer(xt)
    (y ** 2).sum().backward()
    close(_port_out(y), want_y, 1e-5, "output")
    ju, jv = upd["spectral"]["sn"]["u"], upd["spectral"]["sn"]["v"]
    if kind == "conv":
        jv = np.asarray(jv).reshape(3, 3, 4).transpose(2, 0, 1).ravel()
    close(layer.weight_u, ju, 1e-5, "u")
    close(layer.weight_v, jv, 1e-5, "v")
    if not train:  # eval keeps the stored vectors
        close(layer.weight_u, v["spectral"]["sn"]["u"], 0, "u kept")
    jk = np.asarray(jgrads["sn"]["kernel"])
    jk = jk.transpose(3, 2, 0, 1) if kind == "conv" else jk.T
    close(layer.weight_orig.grad, jk, 1e-5, "kernel grad")
    close(layer.bias.grad, jgrads["bias"], 1e-5, "bias grad")


def _dense_kernel_grads(detach: bool, monkeypatch):
    """SNDense(8) over 16 inputs, fresh: the kernel gradient of sum(y^2),
    the port's (power iteration differentiated, or with u and v held
    constant) and JAX's."""
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (4, 16)).astype(np.float32)
    jl = SNDense(8)
    v = jl.init(jax.random.PRNGKey(3), jnp.asarray(x))

    def loss_of(params):
        y, _ = jl.apply({"params": params, "spectral": v["spectral"]},
                        jnp.asarray(x), update_stats=True,
                        mutable=["spectral"])
        return jnp.sum(y ** 2)

    want = np.asarray(jax.grad(loss_of)(v["params"])["sn"]["kernel"]).T
    layer = SNLinear(16, 8)
    layer.load_state_dict({
        "weight_orig": _t(np.asarray(v["params"]["sn"]["kernel"]).T),
        "bias": _t(v["params"]["bias"]),
        "weight_u": _t(v["spectral"]["sn"]["u"]),
        "weight_v": _t(v["spectral"]["sn"]["v"])})
    if detach:
        norm = layers._normalize
        monkeypatch.setattr(layers, "_normalize",
                            lambda t, eps: norm(t, eps).detach())
    (layer(_t(x)) ** 2).sum().backward()
    return layer.weight_orig.grad.numpy(), want


def test_gradient_flows_through_the_power_iteration(monkeypatch):
    """The port's kernel gradient equals JAX's within 1e-5 of its max abs;
    the same layer with u and v detached (torch.nn.utils' rule) is off by
    more than a tenth of it, so the parity above would catch a detach."""
    got, want = _dense_kernel_grads(False, monkeypatch)
    close(got, want, 1e-5)
    detached, _ = _dense_kernel_grads(True, monkeypatch)
    assert np.abs(detached - want).max() > 0.1 * np.abs(want).max()


# ---------------------------------------------------------------------------
# Discriminator, converter, VGG19, perceptual loss
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=2)
def jax_d(nf=NF):
    d = JaxD(nf=nf)
    v = jax.jit(functools.partial(d.init, train=False))(
        jax.random.PRNGKey(2), jnp.zeros((1, CROP, CROP, 3)))
    return d, v


def port_d(params, extra, nf=NF):
    model = build_model(lambda: Discriminator(nf=nf), device="cpu")
    model.load_state_dict(discriminator_from_jax(params, extra), strict=True)
    return model


def extra_of(v):
    return {k: v[k] for k in v if k != "params"}


def test_converter_equals_export_discriminator_at_full_width():
    """convert.discriminator_from_jax on a seeded nf=64 JAX Discriminator
    equals tools/export_sr_checkpoint.py::export_discriminator key for key
    and value for value, and loads strictly into the port's."""
    _, v = jax_d(64)
    want = export_discriminator(v["params"], extra_of(v))
    got = discriminator_from_jax(v["params"], extra_of(v))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].numpy().dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    port_d(v["params"], extra_of(v), 64)


def _d_state_arrays(model) -> dict:
    """The port D's u, v and BN running stats in the JAX layout."""
    out = {}
    for i, p in enumerate(("net.0", "net.2", "net.5", "net.8")):
        m = model.get_submodule(p)
        out[f"block_{i}/u"] = m.weight_u.numpy()
        k = m.weight_orig.shape
        out[f"block_{i}/v"] = m.weight_v.reshape(k[1], k[2], k[3]) \
            .permute(1, 2, 0).reshape(-1).numpy()
    for name, p in (("fc1", "classifier.2"), ("fc2", "classifier.4")):
        out[f"{name}/u"] = model.get_submodule(p).weight_u.numpy()
        out[f"{name}/v"] = model.get_submodule(p).weight_v.numpy()
    for i, p in ((1, "net.3"), (2, "net.6"), (3, "net.9")):
        bn = model.get_submodule(p)
        out[f"bn_{i}/mean"] = bn.running_mean.numpy()
        out[f"bn_{i}/var"] = bn.running_var.numpy()
    return out


def _jax_state_arrays(extra) -> dict:
    out = {}
    for name, s in extra["spectral"].items():
        out[f"{name}/u"] = np.asarray(s["sn"]["u"])
        out[f"{name}/v"] = np.asarray(s["sn"]["v"])
    for name, s in extra["batch_stats"].items():
        out[f"{name}/mean"] = np.asarray(s["mean"])
        out[f"{name}/var"] = np.asarray(s["var"])
    return out


def assert_d_buffers(model, extra, tol):
    got, want = _d_state_arrays(model), _jax_state_arrays(extra)
    assert got.keys() == want.keys()
    for k in want:
        close(got[k], want[k], tol, k)


# logits 1e-5 of their max abs; u, v, running stats 1e-5 of their max abs
def test_discriminator_two_train_applies_then_eval_match_jax():
    d, v = jax_d()
    model = port_d(v["params"], extra_of(v)).train()
    rng = np.random.default_rng(6)
    extra = extra_of(v)
    apply_train = jax.jit(functools.partial(_apply_train, d))
    for _ in range(2):
        x = rng.uniform(0, 1, (BATCH, CROP, CROP, 3)).astype(np.float32)
        want, extra = apply_train(v["params"], extra, jnp.asarray(x))
        with torch.no_grad():
            got = model(nchw(x))
        assert got.shape == (BATCH, 1)
        close(got, want, 1e-5, "train logits")
    assert_d_buffers(model, extra, 1e-5)
    x = rng.uniform(0, 1, (BATCH, CROP, CROP, 3)).astype(np.float32)
    want = jax.jit(d.apply)({"params": v["params"], **extra}, jnp.asarray(x))
    with torch.no_grad():
        got = model.eval()(nchw(x))
    close(got, want, 1e-5, "eval logits")


def write_vgg_npz(d: Path) -> Path:
    """A seeded JAX VGG19 as ``d/vgg19_features.npz``, so that both
    packages' perceptual losses load the same weights; returns ``d``."""
    params = jax.jit(JaxVGG().init)(jax.random.PRNGKey(1234),
                                    jnp.zeros((1, CROP, CROP, 3)))["params"]
    np.savez(d / "vgg19_features.npz",
             **{f"{k}/{leaf}": np.asarray(p[leaf]) for k, p in params.items()
                for leaf in ("kernel", "bias")})
    return d


@pytest.fixture(scope="module")
def vgg_dir(tmp_path_factory):
    return write_vgg_npz(tmp_path_factory.mktemp("vgg"))


# 16 convs deep: 1e-5 of the features' max abs
def test_vgg19_features_match_jax(vgg_dir):
    with np.load(vgg_dir / "vgg19_features.npz") as npz:
        tree: dict = {}
        for key in npz.files:
            conv, leaf = key.split("/")
            tree.setdefault(conv, {})[leaf] = npz[key]
    net = VGG19Features()
    net.load_state_dict(vgg19_from_jax(tree), strict=True)
    assert len(tree) == 16
    x = np.random.default_rng(7).uniform(0, 1, (BATCH, CROP, CROP, 3)) \
        .astype(np.float32)
    want = jax.jit(JaxVGG().apply)({"params": tree}, jnp.asarray(x))
    with torch.no_grad():
        got = net(nchw(x))
    assert got.shape == (BATCH, 512, 2, 2)
    close(got.permute(0, 2, 3, 1), want, 1e-5)


def test_perceptual_loss_matches_jax(vgg_dir):
    """1e-5 relative; the net is frozen and loaded from the file."""
    loss = get_loss_function("perceptual", weights_dir=str(vgg_dir),
                             device="cpu")
    assert isinstance(loss, PerceptualLoss) and loss.pretrained
    assert not any(p.requires_grad for p in loss.net.parameters())
    rng = np.random.default_rng(8)
    a, b = (rng.uniform(0, 1, (BATCH, CROP, CROP, 3)).astype(np.float32)
            for _ in range(2))
    jloss = JaxPerceptualLoss(weights_dir=str(vgg_dir))
    assert jloss.pretrained
    want = float(jax.jit(jloss.__call__)(jnp.asarray(a), jnp.asarray(b)))
    assert float(loss(nchw(a), nchw(b))) == pytest.approx(want, rel=1e-5)


def test_perceptual_falls_back_to_a_seeded_net(tmp_path):
    with pytest.warns(UserWarning, match="vgg19_features.npz"):
        a = PerceptualLoss(weights_dir=str(tmp_path), device="cpu")
    with pytest.warns(UserWarning):
        b = PerceptualLoss(weights_dir=str(tmp_path), device="cpu")
    assert not a.pretrained
    for p, q in zip(a.net.parameters(), b.net.parameters()):
        assert torch.equal(p, q)


# ---------------------------------------------------------------------------
# the committed GAN-trained generator
# ---------------------------------------------------------------------------

def test_committed_gan_winner_matches_jax():
    """weights/winner_attentionsr_gan_best (the generator of a GAN run;
    the file holds no discriminator), read with the JAX package's loader
    here in the test, through both nets on 2 seeded 48x48 inputs
    (float32; 1e-4 abs on [0, 1] outputs of 32 blocks, the registry
    winner's bound)."""
    from food101_sr_tpu.training import load_checkpoint

    tree = load_checkpoint(str(ROOT / "weights" /
                               "winner_attentionsr_gan_best"))
    assert "d" not in tree
    params = tree["params"]
    x = np.random.default_rng(21).uniform(0, 1, (2, 48, 48, 3)) \
        .astype(np.float32)
    want = np.asarray(jax_get_model("AttentionSR").apply(
        {"params": params}, jnp.asarray(x)))
    model = build_model(lambda: AttentionSR(4, 96, 32), device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got = model(nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == (2, 192, 192, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
