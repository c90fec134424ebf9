"""The registry's last two options on the CPU: RRDB's split dense layout
(``RRDBNet(dense_layout=...)``) against the JAX package's split and the
port's concat, and ``remat`` (per-block recomputation) against the plain
backward, through ``get_model``, ``build_model`` and
``model_for_params``. Narrow nets: RRDB 2 x 16, growth 8; ResNetSR and
AttentionSR 2 x 16."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from food101_sr_tpu.data.pipeline import prepare_batch as jax_prepare_batch
from food101_sr_tpu.losses import nlpd_loss as jax_nlpd
from food101_sr_tpu.models.rrdb import RRDBNet as JaxRRDBNet
from food101_sr_tpu_torch.convert import params_from_jax
from food101_sr_tpu_torch.losses import nlpd_loss
from food101_sr_tpu_torch.models import (AttentionSR, ResNetSR, RRDBNet,
                                         build_model, get_model, layers,
                                         model_for_params, registry)
from food101_sr_tpu_torch.models import rrdb as rrdb_mod
from food101_sr_tpu_torch.training import (FIRST_LAST, SRTrainState,
                                           loss_and_grads, make_adam,
                                           make_train_step)

SCALE = 4
NETS = {"RESNET": lambda **f: ResNetSR(SCALE, 16, 2, **f),
        "AttentionSR": lambda **f: AttentionSR(SCALE, 16, 2, **f),
        "RRDB": lambda **f: RRDBNet(SCALE, 16, 8, 2, **f)}


def _hr(seed=3, n=2, crop=32):
    return np.random.default_rng(seed).integers(0, 256, (n, crop, crop, 3),
                                                dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def _jax_rrdb():
    net = JaxRRDBNet(scale_factor=SCALE, num_channels=16, growth=8,
                     num_blocks=2, dense_layout="split")
    v = jax.jit(net.init)(jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 3)))
    return net, jax.tree_util.tree_map(np.asarray, dict(v))


def _port_rrdb(layout: str):
    model = build_model(lambda: RRDBNet(SCALE, 16, 8, 2, dense_layout=layout),
                        device="cpu")
    model.load_state_dict(params_from_jax(_jax_rrdb()[1]["params"]),
                          strict=True)
    return model


# ---------------------------------------------------------------------------
# RRDB's split dense layout
# ---------------------------------------------------------------------------

def test_layouts_share_the_state_dict():
    """The layout does not show in the checkpoint: the same keys and
    shapes, and the same seeded init, in every layout."""
    sds = [build_model(lambda: RRDBNet(SCALE, 16, 8, 2, dense_layout=lay),
                       device="cpu").state_dict()
           for lay in rrdb_mod.LAYOUTS]
    for sd in sds[1:]:
        assert list(sd) == list(sds[0])
        assert all(torch.equal(sd[k], sds[0][k]) for k in sd)


# float32, sums in other orders: 1e-5 of the output's peak, as the
# generators' forward parity (tests/test_torch_generators.py)
def test_split_forward_matches_jax_split_and_port_concat():
    net, v = _jax_rrdb()
    x = np.random.default_rng(1).uniform(0, 1, (2, 12, 10, 3)) \
        .astype(np.float32)
    want = np.asarray(net.apply(v, jnp.asarray(x), train=True))
    peak = np.abs(want).max()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    outs = {}
    for layout in ("split", "concat"):
        with torch.no_grad():
            outs[layout] = _port_rrdb(layout)(xt).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(outs[layout] / peak, want / peak,
                                   atol=1e-5, rtol=0, err_msg=layout)
    assert not np.array_equal(outs["split"], outs["concat"])


@functools.lru_cache(maxsize=1)
def _jax_split_grads():
    net, v = _jax_rrdb()
    lr_img, hr = jax_prepare_batch(jnp.asarray(_hr()), SCALE)

    def loss_of(params):
        return jax_nlpd(net.apply({"params": params}, lr_img, train=True), hr)

    loss, grads = jax.jit(jax.value_and_grad(loss_of))(v["params"])
    return float(loss), params_from_jax(grads)


# raw NLPD gradients, train mode, per leaf within 5e-5 of the leaf's max
# abs (the generators' gradient parity)
@pytest.mark.parametrize("layout", ["split", "concat", "auto"])
def test_split_gradients_match_jax_split(layout):
    want_loss, want = _jax_split_grads()
    model = _port_rrdb(layout)
    loss, grads = loss_and_grads(model, nlpd_loss, SCALE,
                                 torch.from_numpy(_hr()))
    assert float(loss) == pytest.approx(want_loss, rel=1e-5)
    got = dict(zip((k for k, _ in model.named_parameters()), grads))
    assert set(got) == set(want)
    for name, w in want.items():
        w = w.numpy()
        scale = np.abs(w).max() + 1e-12
        np.testing.assert_allclose(got[name].numpy() / scale, w / scale,
                                   atol=5e-5, rtol=0, err_msg=name)


def test_split_gradients_keep_each_weights_memory_format():
    """The wide kernels' backward hands every dense conv its gradient in
    the weight's strides (channels-last here: CUDA's fused Adam refuses
    another), and a fused Adam step takes them."""
    model = _port_rrdb("split")
    _, grads = loss_and_grads(model, nlpd_loss, SCALE,
                              torch.from_numpy(_hr()))
    for (name, p), g in zip(model.named_parameters(), grads):
        assert g.stride() == p.stride(), name
    dense = model.rrdb[0].dense2.conv3.weight
    assert dense.is_contiguous(memory_format=torch.channels_last)
    state = SRTrainState.create(model, make_adam(1e-4))
    state.apply_updates(grads)
    assert int(state.step) == 1


def test_auto_takes_split_in_training_passes(monkeypatch):
    """"auto" resolves per pass from ``self.training``: a train-mode
    forward builds the wide kernels once per dense block, an eval-mode one
    never."""
    calls = []
    real = rrdb_mod._WideKernels.apply
    monkeypatch.setattr(rrdb_mod._WideKernels, "apply",
                        lambda *a: calls.append(1) or real(*a))
    model = build_model(lambda: RRDBNet(SCALE, 16, 8, 2), device="cpu")
    x = torch.rand(1, 3, 8, 8)
    with torch.no_grad():
        model.eval()(x)
        assert calls == []
        model.train()(x)
    assert len(calls) == 2 * 3


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("quantize", ["", "int8", "int8_dot", "qat"])
@pytest.mark.parametrize("layout", ["auto", "concat", "split"])
def test_resolved_layout_is_jax_rule(layout, quantize, train):
    kw = dict(scale_factor=SCALE, num_channels=16, growth=8, num_blocks=1,
              dense_layout=layout, quantize=quantize)
    want = JaxRRDBNet(**kw).resolved_layout(train=train)
    assert RRDBNet(**kw).resolved_layout(train=train) == want


def test_unknown_layout_is_refused():
    with pytest.raises(ValueError, match="dense_layout"):
        RRDBNet(SCALE, 16, 8, 1, dense_layout="bogus")
    model = RRDBNet(SCALE, 16, 8, 1)
    model.dense_layout = "bogus"
    with pytest.raises(ValueError, match="dense_layout"):
        model.resolved_layout(train=True)


def test_quantized_body_takes_concat_in_training():
    """A QAT RRDB asked for split trains in the concat layout, bit for bit
    the concat net's gradients."""
    grads = []
    for layout in ("split", "concat"):
        model = build_model(lambda: RRDBNet(SCALE, 16, 8, 1, quantize="qat",
                                            dense_layout=layout),
                            device="cpu")
        grads.append(loss_and_grads(model, nlpd_loss, SCALE,
                                    torch.from_numpy(_hr()))[1])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_bf16_split_stays_within_bf16_of_concat():
    """With a bf16 compute dtype the split layout rounds its re-associated
    sums in bf16: the forwards agree within 4 bf16 steps of the output's
    peak (test_torch_bf16.py's forward bound) and run in bf16."""
    x = torch.rand(2, 3, 12, 12, generator=torch.Generator().manual_seed(2))
    outs = []
    for layout in ("split", "concat"):
        model = _port_rrdb(layout)
        layers.set_compute_dtype(model, torch.bfloat16)
        with torch.no_grad():
            outs.append(model.train()(x).float())
    assert model.rrdb[0].dense1.conv1.weight.dtype == torch.float32
    peak = outs[1].abs().max()
    assert float((outs[0] - outs[1]).abs().max() / peak) <= 4 * 2.0 ** -8


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(NETS))
def test_remat_gives_the_same_step(arch):
    """One NLPD train step with and without remat from the same weights:
    the same loss and raw gradients bit for bit, the same buffers after it
    (ResNetSR's running stats advanced once: one batch counted)."""
    out = []
    for remat in (False, True):
        model = build_model(lambda: NETS[arch](remat=remat), device="cpu")
        assert model.remat is remat
        loss, grads = loss_and_grads(model, nlpd_loss, SCALE,
                                     torch.from_numpy(_hr()))
        out.append((loss, grads, dict(model.named_buffers())))
    (l0, g0, b0), (l1, g1, b1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert list(b0) == list(b1)
    assert all(torch.equal(b0[k], b1[k]) for k in b0)
    for k, v in b1.items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == 1, k
        if k.endswith("running_var"):
            assert not torch.equal(v, torch.ones_like(v)), k


def test_remat_recomputes_each_block_once(monkeypatch):
    """AttentionSR's SE squeeze (kernel K2 on the card) runs once per
    block in a plain step and twice with remat: the backward recomputes
    each block's forward once, so a registry step launches K2 64 times
    instead of 32."""
    calls = []
    real = layers.spatial_mean
    monkeypatch.setattr(layers, "spatial_mean",
                        lambda x: calls.append(1) or real(x))
    counts = []
    for remat in (False, True):
        calls.clear()
        model = build_model(lambda: NETS["AttentionSR"](remat=remat),
                            device="cpu")
        loss_and_grads(model, nlpd_loss, SCALE, torch.from_numpy(_hr()))
        counts.append(len(calls))
    assert counts == [2, 4]


def test_remat_is_plain_without_a_gradient(monkeypatch):
    """Eval forwards and no-grad train forwards of a remat net take the
    plain loop (no checkpoint) and give the same outputs."""
    monkeypatch.setattr(layers, "checkpoint",
                        lambda *a, **k: pytest.fail("checkpointed"))
    x = torch.rand(1, 3, 8, 8)
    plain = build_model(lambda: NETS["RESNET"](), device="cpu")
    remat = build_model(lambda: NETS["RESNET"](remat=True), device="cpu")
    with torch.no_grad():
        assert torch.equal(plain(x), remat(x))
        assert torch.equal(plain.train()(x), remat.train()(x))


def _nan_loss(sr, hr):
    return torch.where(torch.all(hr == 0.0), torch.nan, nlpd_loss(sr, hr))


def test_guard_restores_buffers_under_remat():
    """A NaN step of a remat ResNetSR leaves the parameters, Adam's state
    and the BatchNorm buffers bit-equal and counts one skip."""
    model = build_model(lambda: NETS["RESNET"](remat=True), device="cpu")
    state = SRTrainState.create(model, make_adam(1e-3))
    step = make_train_step(model, _nan_loss, SCALE, *FIRST_LAST["RESNET"])
    step(state, torch.from_numpy(_hr()))

    def kept():
        return [t.clone() for t in state.tensors() if t is not state.skipped]

    before = kept()
    state, m = step(state, torch.zeros(2, 32, 32, 3, dtype=torch.uint8))
    assert float(m["nonfinite_steps"]) == 1.0 and int(state.skipped) == 1
    assert all(torch.equal(a, b) for a, b in zip(before, kept()))


@pytest.mark.parametrize("arch", ["SRCNN", "RESNET", "AttentionSR", "RRDB"])
def test_registry_takes_remat(monkeypatch, arch):
    """``get_model``, ``build_model`` and ``model_for_params`` take
    ``remat`` (SRCNN ignores it, as in JAX): the nets with a block stack
    carry it, and the net built from a state_dict steps as the plain one
    does."""
    if arch != "SRCNN":
        monkeypatch.setitem(registry._REGISTRY, arch,
                            lambda scale, **f: NETS[arch](**f))
    model = get_model(arch, device="cpu", remat=True)
    assert getattr(model, "remat", True) is True
    built = build_model(lambda: registry._REGISTRY[arch](SCALE),
                        device="cpu", remat=True)
    assert getattr(built, "remat", True) is True
    loaded = model_for_params(get_model(arch, device="cpu").state_dict(),
                              device="cpu", remat=True)
    assert getattr(loaded, "remat", True) is True
    plain = get_model(arch, device="cpu")
    hr = torch.from_numpy(_hr(n=1))
    _, g0 = loss_and_grads(plain, nlpd_loss, SCALE, hr)
    _, g1 = loss_and_grads(loaded, nlpd_loss, SCALE, hr)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_term_sums_record_split_nets_in_concat():
    """``utils.term_sums`` watches the conv modules, which the split layout
    goes past: it records an RRDB in the concat layout (every dense conv's
    weight and bias gets its sum, the same terms) and gives the net its
    layout back."""
    from food101_sr_tpu_torch.utils.term_sums import term_sums

    model = _port_rrdb("auto")
    with term_sums(model, {}) as sums:
        assert model.dense_layout == "concat"
        loss_and_grads(model, nlpd_loss, SCALE, torch.from_numpy(_hr()))
    assert model.dense_layout == "auto"
    assert set(sums) == {k for k, _ in model.named_parameters()}
