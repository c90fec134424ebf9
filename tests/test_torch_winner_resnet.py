"""The committed ResNetSR x4 winners the card host reads
(``food101_sr_tpu_torch/assets/winner_resnet.f101w``, its QAT fine-tune
``winner_resnet_qat.f101w``, packed weights files, and their goldens,
written by ``tools/export_port_assets.py --what resnet`` from
``weights/winner_resnet_best`` and ``weights/winner_resnet_qat_best``),
each case run for both: the state_dict, BatchNorm running stats included,
loads strictly into the registry ResNetSR and equals the JAX package's
export of the Orbax checkpoint bit for bit; the goldens' outputs are x4
the AttentionSR goldens' LRs, which are the tool's inputs; the port's
float32 server on the CPU is within 1 uint8 level of the goldens on the
four small inputs (the tiled fifth is held on the card); the JAX server
recomputed from the Orbax checkpoint is within 1 level of its golden;
``train(pretrained_weights=...)`` starts from the asset, running stats
included; one QAT NLPD step from the asset agrees with the JAX package's
in its raw gradients and its updated running stats."""
import concurrent.futures as cf
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch_threads import one_thread  # noqa: F401

from food101_sr_tpu.losses import get_loss_function as jax_get_loss_function
from food101_sr_tpu.models import model_for_params
from food101_sr_tpu.training import load_checkpoint as jax_load_checkpoint
from food101_sr_tpu_torch import native
from food101_sr_tpu_torch.convert import params_from_jax
from food101_sr_tpu_torch.losses import get_loss_function
from food101_sr_tpu_torch.models import get_model
from food101_sr_tpu_torch.serving import SRServer, load_generator_weights
from food101_sr_tpu_torch.training import (load_checkpoint, loop,
                                           loss_and_grads)
from test_torch_generators import _SlopeTerms
from test_torch_winner_attentionsr import (ASSETS, LEVEL_TOL, ROOT, SMALL,
                                           _jax_prelu_outputs, _Started,
                                           export_state_dict,
                                           goldens, jax_serve, tool_hr,
                                           winner_lr)

NPZ = ASSETS / "winner_resnet_goldens.npz"
WINNERS = {"resnet": ROOT / "weights" / "winner_resnet_best",
           "resnet_qat": ROOT / "weights" / "winner_resnet_qat_best"}
N_PARAMS = 1_549_462

each = pytest.mark.parametrize("tag", list(WINNERS))


def _pack(tag):
    return ASSETS / f"winner_{tag}.f101w"


@pytest.fixture(scope="module")
def outputs():
    """JAX's float32 served outputs by tag, as stored in the goldens."""
    g = np.load(NPZ)
    return {tag: [native.decode_image(g[f"{tag}_sr_{i}"].tobytes())
                  for i in range(SMALL + 1)] for tag in WINNERS}


@pytest.fixture(scope="module")
def port_served(goldens):
    """The port's float32 server's outputs for the four small inputs by
    tag, sent at once so that they share one device batch."""
    out = {}
    for tag in WINNERS:
        srv = SRServer("auto", checkpoint=str(_pack(tag)),
                       dtype=torch.float32, device="cpu")
        try:
            with cf.ThreadPoolExecutor(SMALL) as pool:
                out[tag] = list(pool.map(srv.upscale,
                                         [x for x, _ in goldens[:SMALL]]))
            assert srv.architecture == "RESNET"
        finally:
            srv.close()
    return out


@each
def test_asset_loads_strictly_and_equals_the_jax_export(tag):
    asset = load_checkpoint(str(_pack(tag)))
    model = get_model("RESNET", device="cpu")
    model.load_state_dict(asset, strict=True)
    assert sum(p.numel() for p in model.parameters()) == N_PARAMS
    assert load_generator_weights(str(_pack(tag))).keys() == asset.keys()
    want, arch = export_state_dict(jax_load_checkpoint(str(WINNERS[tag])))
    assert arch == "RESNET" and want.keys() == asset.keys()
    # 33 BatchNorms (two in each of 16 blocks, bn_mid), mean and variance
    assert sum(k.endswith(("running_mean", "running_var"))
               for k in asset) == 2 * 33
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            assert asset[k].dtype == torch.float32
        assert np.array_equal(asset[k].numpy(), v), k


@each
def test_goldens_are_x4_of_the_tool_inputs(tag, goldens, tool_hr, outputs):
    for i, (x, _) in enumerate(goldens):
        assert np.array_equal(x, winner_lr(tool_hr[i]))
        assert outputs[tag][i].shape == tool_hr[i].shape
    assert goldens[SMALL][0].shape[:2] == (200, 152)  # the tiled path


@each
def test_port_server_within_one_level_of_goldens(tag, outputs, port_served):
    for got, want in zip(port_served[tag], outputs[tag][:SMALL]):
        assert got.shape == want.shape
        assert np.abs(got.astype(np.int16) - want).max() <= LEVEL_TOL


@each
def test_goldens_within_one_level_of_jax_recomputed(tag, goldens, outputs):
    # the smallest input: one device batch of the 64x64 bucket
    i = min(range(SMALL), key=lambda j: goldens[j][0].size)
    jsrv = jax_serve.SRServer("auto", str(WINNERS[tag]), dtype=jnp.float32)
    got = np.asarray(jsrv.upscale(Image.fromarray(goldens[i][0])), np.int16)
    assert np.abs(got - outputs[tag][i]).max() <= LEVEL_TOL


@each
def test_train_starts_from_the_asset(tag, tmp_path, monkeypatch):
    """``train(pretrained_weights=asset)``: the generator handed to its
    train state, before any step, is the asset bit for bit, the BatchNorm
    running stats and counts included."""
    seen = {}

    class Recording(loop.SRTrainState):
        @classmethod
        def create(cls, model, *a, **kw):
            seen["sd"] = {k: v.detach().clone()
                          for k, v in model.state_dict().items()}
            raise _Started

    monkeypatch.setattr(loop, "SRTrainState", Recording)
    monkeypatch.setenv("FOOD101_SR_RUN_DIR", str(tmp_path / "runs"))
    with pytest.raises(_Started):
        loop.train({"dataset": "synthetic", "architecture": "RESNET",
                    "synthetic_size": 40, "crop_size": 32, "batch_size": 2,
                    "quantize": "qat", "lr": 1e-5, "epochs": 1,
                    "pretrained_weights": str(_pack(tag)), "use_wandb": False,
                    "weights_dir": str(tmp_path / "w")}, device="cpu")
    asset = load_checkpoint(str(_pack(tag)))
    assert seen["sd"].keys() == asset.keys()
    for k, v in asset.items():
        assert torch.equal(seen["sd"][k], v), k


def _jax_qat_step(tree, hr_u8, levels=None):
    """JAX's QAT NLPD gradients, updated batch_stats, and its forward's
    discrete choices: per fake-quantized activation (call order) its int8
    levels and values, per fake-quantized kernel its values, and the
    sign of each PReLU input under the port's module names. Recorded
    through ordered callbacks in the jitted step itself (an eager forward
    may round otherwise)."""
    from food101_sr_tpu.data.pipeline import prepare_batch as jax_prepare
    from food101_sr_tpu.models.layers import PReLU
    from food101_sr_tpu.ops import quantize as jq

    params, extra = tree["params"], tree["extra"]
    net = model_for_params(params, quantize="qat", phase_tail=True)
    loss_fn = jax_get_loss_function("nlpd")
    lr_img, hr = jax_prepare(jnp.asarray(hr_u8), 4)
    rec = {"acts": [], "kernels": []}
    own_act, own_kernel = jq.fake_quant_act, jq.fake_quant_kernel

    def act(x):
        y = own_act(x)
        jax.debug.callback(lambda q, v: rec["acts"].append(
            (torch.from_numpy(np.asarray(q).transpose(0, 3, 1, 2).copy()),
             torch.from_numpy(np.asarray(v).transpose(0, 3, 1, 2).copy()))),
            jq.quantize_per_sample(x)[0], y, ordered=True)
        return y

    def kernel(k):
        y = own_kernel(k)
        jax.debug.callback(lambda v: rec["kernels"].append(
            torch.from_numpy(np.asarray(v).transpose(3, 2, 0, 1).copy())),
            y, ordered=True)
        return y

    def loss_of(p):
        sr, state = net.apply(
            {"params": p, **extra}, lr_img, train=True,
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda m, _: isinstance(m, PReLU))
        return loss_fn(sr, hr), state

    jq.fake_quant_act, jq.fake_quant_kernel = act, kernel
    try:
        (loss, state), grads = jax.jit(jax.value_and_grad(
            loss_of, has_aux=True))(params)
        jax.effects_barrier()
    finally:
        jq.fake_quant_act, jq.fake_quant_kernel = own_act, own_kernel
    rec["masks"] = {}
    for port, (y, a) in _jax_prelu_outputs(
            state["intermediates"], params).items():
        assert (a > 0).all()  # the output's sign is the input's
        rec["masks"][f".{port}"] = [torch.from_numpy(np.ascontiguousarray(
            (y > 0).transpose(0, 3, 1, 2)))]
    stats = {k: v for k, v in params_from_jax(params, jax.tree_util.tree_map(
        np.asarray, {"batch_stats": state["batch_stats"]})).items()
        if k.endswith(("running_mean", "running_var"))}
    return float(loss), params_from_jax(grads), stats, rec


@contextlib.contextmanager
def _jax_choices(model, rec: dict, stats: dict):
    """Within the block, ``model``'s forward makes JAX's choices (``rec``,
    :func:`_jax_qat_step`): JAX's fake-quantized activations and kernels
    taken through the straight-through estimator, its PReLU branches
    (``chip_smoke._branches``). ``stats`` keeps the largest difference
    between the int8 levels the port would round each input to and JAX's
    ("act_levels", "kernel_levels")."""
    from chip_smoke import _branches
    from food101_sr_tpu_torch.ops import quantize as q

    acts, kernels = iter(rec["acts"]), iter(rec["kernels"])
    stats.update(act_levels=0, kernel_levels=0, calls=0)

    def act(x):
        levels, values = next(acts)
        own = q.quantize_per_sample(x)[0].int()
        stats["act_levels"] = max(stats["act_levels"],
                                  int((own - levels.int()).abs().max()))
        stats["calls"] += 1
        return q._ste(x.float(), values).to(x.dtype)

    def kernel(w):
        values = next(kernels)
        own, scales = q.quantize_kernel_per_cout(w.float())
        levels = torch.round(values / scales[:, None, None, None])
        stats["kernel_levels"] = max(stats["kernel_levels"], int(
            (own.float() - levels).abs().max()))
        return q._ste(w.float(), values).to(w.dtype)

    own_act, own_kernel = q.fake_quant_act, q.fake_quant_kernel
    q.fake_quant_act, q.fake_quant_kernel = act, kernel
    try:
        with _branches({"": model}, rec, "replay", {}, (torch.nn.PReLU,)):
            yield stats
    finally:
        q.fake_quant_act, q.fake_quant_kernel = own_act, own_kernel


# One QAT step from each asset at batch 2, crop 48, the phase tail on (as
# train() runs it): float32 on both sides, sums in other orders. The
# trained weights put rounding ties on the int8 grid (a kernel of the QAT
# winner's block 14 rounds one weight a level apart in the two packages)
# and near-zero PReLU inputs, which float32 resolves either way; each
# choice that differs moves every leaf upstream of it by far more than the
# sums' rounding. So, as chip_smoke.py's QAT check replays the CPU's
# choices on the card (``_decisions``), the step replays JAX's: its
# fake-quantized activations and kernels through the straight-through
# estimator, its PReLU branches; the port's own rounding of each input is
# at most one int8 level from JAX's (a tie, not another quantizer). Per leaf within 1e-4
# of its max abs (the rule of tests/test_torch_quantize.py's QAT step);
# as tests/test_torch_generators.py holds the registry ResNetSR's step, a
# shared PReLU slope of its sum's absolute terms (it sums g*x over every
# negative input) and a conv bias ahead of a train-mode BatchNorm, whose
# gradient is 0 in exact arithmetic (rounding noise on both sides), of
# its weight's max abs; the
# running stats within 1e-5 of each buffer's max abs, as that file's
# trajectory holds them
@each
def test_qat_step_from_the_asset_matches_jax(tag):
    hr_u8 = np.random.default_rng(5).integers(0, 256, (2, 48, 48, 3),
                                              dtype=np.uint8)
    jloss, want, jstats, rec = _jax_qat_step(
        jax_load_checkpoint(str(WINNERS[tag])), hr_u8)
    assert len(rec["acts"]) == len(rec["kernels"]) == 33

    model = get_model("RESNET", device="cpu", quantize="qat",
                      phase_tail=True)
    model.load_state_dict(load_checkpoint(str(_pack(tag))),
                          strict=True)
    stats = {}
    with _jax_choices(model, rec, stats):
        terms = _SlopeTerms(model)  # after the replay's hooks: their outputs
        try:
            loss, grads = loss_and_grads(model, get_loss_function("nlpd"),
                                         4, torch.from_numpy(hr_u8))
        finally:
            terms.remove()
    assert stats["calls"] == 33
    assert stats["act_levels"] <= 1 and stats["kernel_levels"] <= 1
    assert float(loss) == pytest.approx(jloss, rel=1e-5)
    got = dict(zip((k for k, _ in model.named_parameters()), grads))
    assert set(got) == set(want)
    ahead_of_bn = {f"{n[:-3]}conv{n[-1]}.bias" if n != "bn_mid" else
                   "mid_conv.bias" for n, m in model.named_modules()
                   if isinstance(m, torch.nn.BatchNorm2d)}
    assert len(terms.sums) == 19
    for name, w in want.items():
        w = w.numpy()
        if name in ahead_of_bn:
            scale = np.abs(want[name[:-4] + "weight"].numpy()).max()
        else:
            scale = terms.sums.get(name, np.abs(w).max() + 1e-12)
        np.testing.assert_allclose(got[name].numpy() / scale, w / scale,
                                   rtol=0, atol=1e-4, err_msg=name)
    bufs = dict(model.named_buffers())
    assert len(jstats) == 2 * 33
    for k, v in jstats.items():
        off = float((bufs[k] - v).abs().max() / v.abs().max())
        assert off <= 1e-5, (k, off)


def test_assets_stay_under_14_megabytes():
    total = sum(_pack(t).stat().st_size for t in WINNERS) + NPZ.stat().st_size
    assert total < 14_000_000
    assert NPZ.stat().st_size <= 1_500_000
