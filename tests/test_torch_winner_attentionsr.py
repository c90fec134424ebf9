"""The committed AttentionSR x4 winner the card host reads
(``food101_sr_tpu_torch/assets/winner_attentionsr.f101w``, a packed
weights file, and its goldens,
written by ``tools/export_port_assets.py --what attentionsr`` from
``weights/winner_attentionsr_best``): the state_dict loads strictly into
the registry AttentionSR and equals the JAX package's export of the Orbax
checkpoint bit for bit; the goldens hold the tool's inputs; the port's
float32 server on the CPU is within 1 uint8 level of the goldens on the
four small inputs (the tiled fifth is held on the card); the JAX server
recomputed from the Orbax checkpoint is within 1 level of its golden;
``train(pretrained_weights=...)`` starts from the asset; one MAE step's
raw gradients from the winner agree with the JAX package's."""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch_threads import one_thread  # noqa: F401

from food101_sr_tpu.data.pipeline import prepare_batch as jax_prepare_batch
from food101_sr_tpu.losses import get_loss_function as jax_get_loss_function
from food101_sr_tpu.models import model_for_params
from food101_sr_tpu.training import load_checkpoint as jax_load_checkpoint
from food101_sr_tpu_torch import native
from food101_sr_tpu_torch.convert import params_from_jax
from food101_sr_tpu_torch.data import prepare_batch
from food101_sr_tpu_torch.losses import get_loss_function
from food101_sr_tpu_torch.models import get_model
from food101_sr_tpu_torch.serving import SRServer, load_generator_weights
from food101_sr_tpu_torch.training import (load_checkpoint, loop,
                                           loss_and_grads)
from test_torch_generators import _SlopeTerms

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import serve as jax_serve  # noqa: E402
from tools.export_port_assets import winner_hr, winner_lr  # noqa: E402
from tools.export_sr_checkpoint import export_state_dict  # noqa: E402

ASSETS = ROOT / "food101_sr_tpu_torch" / "assets"
PACK = ASSETS / "winner_attentionsr.f101w"
NPZ = ASSETS / "winner_attentionsr_goldens.npz"
CHECKPOINT = ROOT / "weights" / "winner_attentionsr_best"
N_PARAMS = 5_842_630
SMALL = 4  # the mini tree's test images; the fifth input is the tiled one
LEVEL_TOL = 1  # float32 on both sides: a rounding-boundary flip at most


@pytest.fixture(scope="module")
def goldens():
    g = np.load(NPZ)
    return [(native.decode_image(g[f"lr_{i}"].tobytes()),
             native.decode_image(g[f"sr_{i}"].tobytes()))
            for i in range(SMALL + 1)]


@pytest.fixture(scope="module")
def tool_hr():
    return winner_hr()


@pytest.fixture(scope="module")
def asset():
    return load_checkpoint(str(PACK))


@pytest.fixture(scope="module")
def port_served(goldens):
    """The port's float32 server's outputs for the four small inputs, sent
    at once so that they share one device batch."""
    import concurrent.futures as cf

    srv = SRServer("auto", checkpoint=str(PACK), dtype=torch.float32,
                   device="cpu")
    try:
        with cf.ThreadPoolExecutor(SMALL) as pool:
            out = list(pool.map(srv.upscale, [x for x, _ in goldens[:SMALL]]))
        assert srv.architecture == "AttentionSR"
        return out
    finally:
        srv.close()


def test_asset_loads_strictly_and_equals_the_jax_export(asset):
    model = get_model("AttentionSR", device="cpu")
    model.load_state_dict(asset, strict=True)
    assert sum(p.numel() for p in model.parameters()) == N_PARAMS
    assert load_generator_weights(str(PACK)).keys() == asset.keys()
    want, arch = export_state_dict(jax_load_checkpoint(str(CHECKPOINT)))
    assert arch == "AttentionSR" and want.keys() == asset.keys()
    for k, v in want.items():
        assert asset[k].dtype == torch.float32
        assert np.array_equal(asset[k].numpy(), v), k


@pytest.mark.parametrize("i", range(SMALL + 1))
def test_goldens_hold_the_tool_inputs(goldens, tool_hr, i):
    hr = tool_hr[i]
    x, y = goldens[i]
    assert hr.shape[0] % 4 == 0 and hr.shape[1] % 4 == 0
    assert np.array_equal(x, winner_lr(hr))
    assert y.shape == hr.shape
    if i == SMALL:  # the server's tiled path
        assert x.shape[:2] == (200, 152)


@pytest.mark.parametrize("i", range(SMALL))
def test_port_server_within_one_level_of_goldens(goldens, port_served, i):
    _, want = goldens[i]
    got = port_served[i]
    assert got.shape == want.shape
    assert np.abs(got.astype(np.int16) - want).max() <= LEVEL_TOL


def test_goldens_within_one_level_of_jax_recomputed(goldens):
    # the smallest input: one device batch of the 64x64 bucket
    i = min(range(SMALL), key=lambda j: goldens[j][0].size)
    x, want = goldens[i]
    jsrv = jax_serve.SRServer("auto", str(CHECKPOINT), dtype=jnp.float32)
    got = np.asarray(jsrv.upscale(Image.fromarray(x)), np.int16)
    assert np.abs(got - want).max() <= LEVEL_TOL


class _Started(Exception):
    pass


def test_train_starts_from_the_asset(asset, tmp_path, monkeypatch):
    """``train(pretrained_weights=asset)``: the generator handed to its
    train state, before any step, is the asset bit for bit."""
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
        loop.train({"dataset": "synthetic", "architecture": "AttentionSR",
                    "synthetic_size": 40, "crop_size": 32, "batch_size": 2,
                    "loss_function": "mae", "lr": 1e-4, "epochs": 1,
                    "pretrained_weights": str(PACK), "use_wandb": False,
                    "weights_dir": str(tmp_path / "w")}, device="cpu")
    assert seen["sd"].keys() == asset.keys()
    for k, v in asset.items():
        assert torch.equal(seen["sd"][k], v), k


def _jax_prelu_outputs(inter, params) -> dict:
    """Each PReLU's captured output (NHWC) and slope in a JAX forward's
    ``intermediates``, by the port's module name; the residual blocks are
    counted from ``params``."""
    n_blocks = sum(k.startswith("res_") for k in params)
    names = {"prelu": "prelu", "up_0": "upsample.2", "up_1": "upsample.5",
             **{f"res_{i}": f"res_blocks.{i}.prelu" for i in range(n_blocks)}}
    return {port_name: (
        np.asarray((inter[k] if k == "prelu" else inter[k]["prelu"])[
            "__call__"][0]),
        np.asarray((params[k] if k == "prelu" else params[k]["prelu"])[
            "alpha"])) for k, port_name in names.items()}


def _jax_prelu_inputs(net, params, lr_img) -> dict:
    """The input of each PReLU of the JAX net's forward (NHWC), by the
    port's module name: recovered from the captured outputs, as every
    slope of the winner is positive."""
    from food101_sr_tpu.models.layers import PReLU

    _, state = net.apply({"params": params}, lr_img, train=True,
                         capture_intermediates=lambda m, _: isinstance(
                             m, PReLU), mutable=["intermediates"])
    out = {}
    for port_name, (y, a) in _jax_prelu_outputs(
            state["intermediates"], params).items():
        assert (a > 0).all()
        out[port_name] = np.where(y > 0, y, y / a)
    return out


# float32 on both sides, sums in other orders: per leaf within 5e-5 of
# its max abs, a shared PReLU slope of its sum's absolute terms (it sums
# g*x over every negative input), as tests/test_torch_generators.py holds
# the registry nets' steps.
# The winner's near-zero PReLU inputs are ties in float32: at this batch
# the port's forward puts one element of a tail PReLU's 295k inputs (|x|
# ~1e-7 beside values ~0.6) on the other branch than JAX's, and the
# float64 step sides with JAX there; that one element moves every leaf
# upstream of it by ~1e-3 of its max abs. So, as chip_smoke.py's QAT
# check does, the port's step replays JAX's branches, and each element
# whose branch differs is shown to lie within the two forwards' own
# rounding difference at that layer. Both tails are the materialized ones
# (the same function; tests/test_torch_phase_tail.py holds the phase tail)
def test_mae_step_gradients_from_the_winner_match_jax(asset):
    from chip_smoke import _branches

    rng = np.random.default_rng(3)
    hr_u8 = rng.integers(0, 256, (2, 48, 48, 3), dtype=np.uint8)
    params = jax_load_checkpoint(str(CHECKPOINT))["params"]
    net = model_for_params(params, phase_tail=False)
    loss_fn = jax_get_loss_function("mae")
    lr_img, hr = jax_prepare_batch(jnp.asarray(hr_u8), 4)

    def loss_of(p):
        sr = net.apply({"params": p}, lr_img, train=True)
        return loss_fn(sr, hr)

    loss, jgrads = jax.jit(jax.value_and_grad(loss_of))(params)
    jax_x = _jax_prelu_inputs(net, params, lr_img)

    model = get_model("AttentionSR", device="cpu", phase_tail=False)
    model.load_state_dict(asset, strict=True)
    port_x = {}

    def keep(name):
        def hook(mod, inp, out):
            port_x[name] = inp[0].detach().permute(0, 2, 3, 1).numpy()
        return hook

    hooks = [m.register_forward_hook(keep(n)) for n, m in
             model.named_modules() if isinstance(m, torch.nn.PReLU)]
    with torch.no_grad():
        model.train()(prepare_batch(torch.from_numpy(hr_u8), 4)[0])
    for h in hooks:
        h.remove()
    assert port_x.keys() == jax_x.keys()
    for name, xj in jax_x.items():
        xp = port_x[name]
        ties = np.abs(xj[(xp > 0) != (xj > 0)])
        assert (ties <= np.abs(xp - xj).max()).all(), name

    rec = {"masks": {f".{n}": [torch.from_numpy(np.ascontiguousarray(
        (x > 0).transpose(0, 3, 1, 2)))] for n, x in jax_x.items()}}
    with _branches({"": model}, rec, "replay", {}, (torch.nn.PReLU,)):
        terms = _SlopeTerms(model)  # after the replay's hooks: their outputs
        try:
            got_loss, grads = loss_and_grads(
                model, get_loss_function("mae"), 4, torch.from_numpy(hr_u8))
        finally:
            terms.remove()
    assert float(got_loss) == pytest.approx(float(loss), rel=1e-5)
    want = params_from_jax(jgrads)
    got = dict(zip((k for k, _ in model.named_parameters()), grads))
    assert set(got) == set(want)
    assert len(terms.sums) == 35
    for name, w in want.items():
        w = w.numpy()
        scale = terms.sums.get(name, np.abs(w).max() + 1e-12)
        np.testing.assert_allclose(got[name].numpy() / scale, w / scale,
                                   atol=5e-5, rtol=0, err_msg=name)


def test_assets_stay_under_25_megabytes():
    assert PACK.stat().st_size + NPZ.stat().st_size < 25_000_000
    assert NPZ.stat().st_size <= 1_500_000
