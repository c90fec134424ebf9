"""Data-parallel training in the port (food101_sr_tpu_torch.parallel, the
steps' all-reduce, global-batch BatchNorm, the loaders' rank slices, the
preemption agreement) on the CPU, against the JAX package's
single-device step on shared weights (mirroring tests/test_parallel.py,
whose invariance is JAX's mesh against one device).

Two OS processes form a gloo group and each runs the port's production
step on its half of a batch of 4 crops of 32 px: ResNetSR 2 x 16 (global
BatchNorm) and RRDB 2 x 16 (growth 8) under fused SGD at 1e-2, and one
GAN D step (the Discriminator at nf=8, relativistic means over the global
batch) on a batch of 2, one crop per rank, on JAX's noise. Tolerances are
stated per test."""
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_threads import one_thread  # noqa: F401
from torch_ranks import launch

from food101_sr_tpu.data import SRDataLoader as JaxSRDataLoader
from food101_sr_tpu.data import SyntheticSource as JaxSyntheticSource
from food101_sr_tpu.data.pipeline import prepare_batch as jax_prepare_batch
from food101_sr_tpu.losses import get_loss_function as jax_get_loss_function
from food101_sr_tpu.training.state import SRTrainState as JaxState
from food101_sr_tpu.training.steps import make_gan_d_step as jax_d_step
from food101_sr_tpu.training.steps import make_train_step as jax_train_step
import food101_sr_tpu_torch.data.canvas_cache as canvas_cache
import food101_sr_tpu_torch.data.device_cache as device_cache
import food101_sr_tpu_torch.data.pipeline as pipeline
import food101_sr_tpu_torch.parallel.distributed as dist
import food101_sr_tpu_torch.training.preempt as preempt
from food101_sr_tpu_torch.convert import params_from_jax
from food101_sr_tpu_torch.data import (DeviceCacheLoader, DeviceWindowLoader,
                                       HostCanvasLoader, SRDataLoader,
                                       SyntheticSource, process_local_slice)
from food101_sr_tpu_torch.losses import get_loss_function
from food101_sr_tpu_torch.parallel import cpu_mesh, data_sharding, replicate
from food101_sr_tpu_torch.training import (FIRST_LAST, PreemptionGuard,
                                           SRTrainState, loss_and_grads)
from food101_sr_tpu_torch.training.loop import _noise_rows
from food101_sr_tpu_torch.utils.term_sums import term_sums
from test_torch_gan import extra_of, jax_d, nchw, port_d
from test_torch_gan_steps import (_JaxSide, _d_params, _jax_g, _jax_noise,
                                  _port_g)
from test_torch_generators import (SCALE, _batches, _jax, _port,
                                   _running_stats, _stats_off)

ARCHS = ("RESNET", "RRDB")
BATCH, LR = 4, 1e-2
SIZES = ((48, 56), (40, 64))  # the loader tests' synthetic image sizes

_RANK = r'''
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)
from food101_sr_tpu_torch.losses import get_loss_function
from food101_sr_tpu_torch.models import (AttentionSR, Discriminator,
                                         ResNetSR, RRDBNet, build_model)
from food101_sr_tpu_torch.parallel import distributed as dist
from food101_sr_tpu_torch.parallel import data_sharding
from food101_sr_tpu_torch.training import (FIRST_LAST, SRTrainState,
                                           Transform, make_gan_d_step,
                                           make_train_step, steps)

rank, port, tmp = int(sys.argv[1]), sys.argv[2], Path(sys.argv[3])
assert dist.maybe_initialize(f"localhost:{port}", 2, rank, device="cpu")
all_reduces = 0
_all_reduce_mean_ = steps.all_reduce_mean_


def counted_all_reduce_mean_(tensors):
    global all_reduces
    all_reduces += 1
    _all_reduce_mean_(tensors)


steps.all_reduce_mean_ = counted_all_reduce_mean_
inp = torch.load(tmp / "inputs.pt", weights_only=False)


def sgd(lr):
    return Transform(lambda p, lr_: torch.optim.SGD(p, lr=lr_, fused=True),
                     lr)


def grads(model):
    return {k: p.grad.clone() for k, p in model.named_parameters()}


nets = {"RESNET": lambda: ResNetSR(4, 16, 2),
        "RRDB": lambda: RRDBNet(4, 16, 8, 2)}
out = {}
for arch, make in nets.items():
    model = build_model(make, device="cpu")
    model.load_state_dict(inp[arch])
    state = SRTrainState.create(model, sgd(inp["lr"]))
    step = make_train_step(model, get_loss_function("nlpd"), 4,
                           *FIRST_LAST[arch])
    hr = data_sharding(torch.from_numpy(inp["hr"])).contiguous()
    n0 = all_reduces
    state, m = step(state, hr)
    out[arch] = {"grads": grads(model), "state": model.state_dict(),
                 "loss": float(m["train_loss"]), "rows": hr.shape[0],
                 "all_reduces": all_reduces - n0}

g = build_model(lambda: AttentionSR(4, 16, 2), device="cpu")
g.load_state_dict(inp["g"])
d = build_model(lambda: Discriminator(nf=8), device="cpu")
d.load_state_dict(inp["d"])
gs, ds = SRTrainState.create(g, sgd(0.0)), SRTrainState.create(d, sgd(0.0))
nr, nf = inp["noise"]
n0 = all_reduces
ds, m = make_gan_d_step(g, d, 4)(
    gs, ds, data_sharding(torch.from_numpy(inp["gan_hr"])).contiguous(),
    (data_sharding(nr), data_sharding(nf)))
out["D"] = {"grads": grads(d), "state": d.state_dict(),
            "metrics": {k: float(v) for k, v in m.items()},
            "all_reduces": all_reduces - n0}
torch.save(out, tmp / f"out{rank}.pt")
'''


@pytest.fixture(scope="module")
def jside():
    """JAX's narrow G and D, its jitted D step, and the raw gradients of
    the D step's loss (test_torch_gan_steps._JaxSide's, without its
    perceptual loss, which the D step does not use)."""
    net, gv = _jax_g()
    d, dv = jax_d()
    side = SimpleNamespace(net=net, gv=gv, d=d, dv=dv,
                           d_step=jax.jit(jax_d_step(net, d, SCALE)))
    side.d_grads = jax.jit(functools.partial(_JaxSide._d_grads, side))
    return side


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jside):
    """Both ranks' results (ranks 0 and 1), from one launch; JAX's
    one-device steps (cached) run while the ranks do."""
    tmp = tmp_path_factory.mktemp("dp")
    nr, nf = _jax_noise(jax.random.PRNGKey(11))
    torch.save({"RESNET": _port("RESNET").state_dict(),
                "RRDB": _port("RRDB").state_dict(),
                "g": _port_g().state_dict(),
                "d": port_d(jside.dv["params"],
                            extra_of(jside.dv)).state_dict(),
                "hr": _hr(), "gan_hr": _gan_hr(), "lr": LR,
                "noise": (nchw(nr), nchw(nf))}, tmp / "inputs.pt")
    launch(_RANK, tmp, "dp_step", args=[tmp],
           meanwhile=lambda: [_jax_step(arch) for arch in ARCHS])
    return [torch.load(tmp / f"out{r}.pt", weights_only=False)
            for r in (0, 1)]


def _hr():
    return _batches(1, batch=BATCH, seed=21)[0]


def _gan_hr():
    return np.random.default_rng(3).integers(0, 256, (2, 32, 32, 3),
                                             dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def _jax_step(arch):
    """JAX's production train step on one device over the whole batch,
    SGD at LR: the raw gradients (by the port's names), the new state,
    the loss."""
    net, variables = _jax(arch)
    loss_fn = jax_get_loss_function("nlpd")
    hr = jnp.asarray(_hr())
    lr_img, hr_f = jax_prepare_batch(hr, SCALE)

    def loss_of(params):
        sr, _ = net.apply({**variables, "params": params}, lr_img,
                          train=True, mutable=["batch_stats"])
        return loss_fn(sr, hr_f)

    grads = jax.jit(jax.grad(loss_of))(variables["params"])
    tx = optax.inject_hyperparams(
        lambda learning_rate: optax.sgd(learning_rate))(learning_rate=LR)
    state = JaxState.create(dict(variables), tx)
    state, m = jax.jit(jax_train_step(net, loss_fn, SCALE,
                                      *FIRST_LAST[arch]))(state, hr)
    return params_from_jax(grads), state, float(m["train_loss"])


def _term_sums(arch) -> dict:
    """Per leaf, the largest sum of absolute terms behind one entry of
    its gradient, from the port's one-process step on the whole batch."""
    model = _port(arch)
    with term_sums(model, {}) as sums:
        loss_and_grads(model, get_loss_function("nlpd"), SCALE,
                       torch.from_numpy(_hr()))
    return sums


# each leaf of the two ranks' averaged raw gradients within 5e-5 of its
# term sum from JAX's one-device gradient over the whole batch (GRAD_TOL
# of the card's float32 checks). Measured: 5.6e-7 (RESNET), 6.7e-7 (RRDB)
# at the worst leaf; ResNetSR's BatchNorm normalizing each rank's 2 crops
# by their own statistics instead of the batch's reads 0.049
GRAD_TOL = 5e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_two_rank_gradients_match_jax_single_device(ranks, arch):
    want, _, _ = _jax_step(arch)
    sums = _term_sums(arch)
    got = ranks[0][arch]["grads"]
    assert got.keys() == want.keys()
    worst = max(float((got[k] - w).abs().max()) / sums[k]
                for k, w in want.items())
    assert worst <= GRAD_TOL, worst


# one SGD step at 1e-2 (the update is linear in the gradient, test_parallel's
# reason for SGD): the parameters within test_parallel.py's 5e-6 absolute
# and 1e-3 relative, the loss within 1e-5 relative, ResNetSR's running
# stats (global mean and the Bessel-corrected global variance) within 1e-5
# of each buffer's max abs, as the one-process trajectory test holds them
@pytest.mark.parametrize("arch", ARCHS)
def test_two_rank_sgd_step_matches_jax_single_device(ranks, arch):
    _, jstate, jloss = _jax_step(arch)
    got = ranks[0][arch]
    assert got["loss"] == pytest.approx(jloss, rel=1e-5)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                  jstate.params))
    for k, w in want.items():
        np.testing.assert_allclose(got["state"][k].numpy(), w.numpy(),
                                   atol=5e-6, rtol=1e-3, err_msg=k)
    if arch == "RESNET":
        stats = _running_stats(jstate)
        model = _port(arch)
        model.load_state_dict(got["state"])
        assert _stats_off(model, stats) <= 1e-5


def test_two_rank_d_step_matches_jax_single_device(ranks, jside):
    """One D step on a batch of 2, one crop per rank, on JAX's noise (the
    ranks take their rows of the global draws): loss and the probability
    metrics 1e-5 relative, raw gradients per leaf 1e-4 of the leaf's max
    abs and D's u, v and running stats 1e-5, test_d_step_matches_jax's
    bounds for the one-process step. Three BatchNorms of one crop per rank
    normalize by the pair's statistics: rank-local ones would not
    match."""
    from test_torch_gan import assert_d_buffers, close
    from test_torch_gan_steps import JAX_SGD

    key = jax.random.PRNGKey(11)
    jg = JaxState.create(dict(jside.gv), JAX_SGD)
    jd = JaxState.create(dict(jside.dv), JAX_SGD).set_learning_rate(0.0)
    hr = jnp.asarray(_gan_hr())
    jgrads = jside.d_grads(jg.variables(), jd.params, jd.extra, hr, key)
    jd, jm = jside.d_step(jg, jd, hr, key)
    got = ranks[0]["D"]
    for k, v in got["metrics"].items():
        assert v == pytest.approx(float(jm[k]), rel=1e-5, abs=1e-12), k
    want = _d_params(jgrads)
    assert got["grads"].keys() == want.keys()
    for k in want:
        close(got["grads"][k], want[k], 1e-4, k)
    d = port_d(jside.dv["params"], extra_of(jside.dv))
    d.load_state_dict(got["state"])
    assert_d_buffers(d, jd.extra, 1e-5)


def test_ranks_agree_and_each_stepped_on_half_the_batch(ranks):
    """The ranks end bit-equal (one all-reduce per step makes every
    rank's update the same), each stepped on B/2 rows, and each step ran
    exactly one gradient all-reduce."""
    for key in (*ARCHS, "D"):
        a, b = (r[key] for r in ranks)
        for part in ("grads", "state"):
            assert a[part].keys() == b[part].keys()
            assert all(torch.equal(a[part][k], b[part][k])
                       for k in a[part]), (key, part)
        assert a["all_reduces"] == b["all_reduces"] == 1
    assert [r[a]["rows"] for r in ranks for a in ARCHS] == [BATCH // 2] * 4


# ---------------------------------------------------------------------------
# rank slices, refusals, the agreement, the noise (one process: the rank
# and world the modules read are patched)
# ---------------------------------------------------------------------------

@pytest.fixture
def world_of(monkeypatch):
    def set_rank(r, w=2):
        for mod in (pipeline, device_cache, canvas_cache, preempt, dist):
            if hasattr(mod, "rank"):
                monkeypatch.setattr(mod, "rank", lambda: r)
            monkeypatch.setattr(mod, "world_size", lambda: w)
    return set_rank


def test_loader_rank_slices_are_jax_global_batch_rows(world_of):
    """Each rank's SRDataLoader batch is its interleaved rows (r::2) of
    JAX's one-process global batch, byte for byte, train and eval, from
    a resumed epoch too: the RNG is keyed by global position."""
    want = {}
    for train in (True, False):
        jl = JaxSRDataLoader(JaxSyntheticSource(n=24, sizes=SIZES, seed=4),
                             crop_size=32, batch_size=8, train=train,
                             seed=5)
        jl.set_epoch(1, start_batch=1)
        want[train] = [np.asarray(b) for b in jl]
    for r in (0, 1):
        world_of(r)
        for train in (True, False):
            ld = SRDataLoader(SyntheticSource(n=24, sizes=SIZES, seed=4),
                              crop_size=32, batch_size=8, train=train,
                              seed=5, device="cpu")
            ld.set_epoch(1, start_batch=1)
            got = [b.numpy() for b in ld]
            assert len(got) == len(want[train]) == 2
            for g, w in zip(got, want[train]):
                assert np.array_equal(g, w[r::2])
            assert np.array_equal(process_local_slice(np.arange(8), r, 2),
                                  np.arange(8)[r::2])


def test_host_canvas_loader_rank_slices_are_the_one_process_rows(
        world_of, tmp_path):
    """HostCanvasLoader: each rank's train batch (canvases and the crop
    and flip draws of the global batch) and eval batch are its rows of the
    one-process loader's."""
    src = SyntheticSource(n=24, sizes=SIZES, seed=4)

    def batches(train):
        ld = HostCanvasLoader(src, crop_size=32, batch_size=8, train=train,
                              seed=5, device="cpu", canvas=40 if train
                              else None, cache_dir=str(tmp_path))
        ld.set_epoch(2)
        return [b.numpy() for b in ld]

    want = {t: batches(t) for t in (True, False)}
    for r in (0, 1):
        world_of(r)
        for train in (True, False):
            got = batches(train)
            assert len(got) == len(want[train]) == 3
            for g, w in zip(got, want[train]):
                assert np.array_equal(g, w[r::2]), (r, train)


def test_caches_and_loaders_refuse_what_a_world_cannot_shard(world_of,
                                                             tmp_path):
    world_of(0)
    src = SyntheticSource(n=8, sizes=((48, 48),))
    with pytest.raises(ValueError, match="single-process only"):
        DeviceCacheLoader(src, crop_size=32, batch_size=2, device="cpu")
    with pytest.raises(ValueError, match="single-process only"):
        DeviceWindowLoader(src, crop_size=32, batch_size=2, device="cpu",
                           cache_dir=str(tmp_path))
    with pytest.raises(ValueError, match="divide evenly across 2"):
        SRDataLoader(src, crop_size=32, batch_size=3, device="cpu")


def test_train_refuses_a_microbatch_the_ranks_cannot_split(world_of):
    """In a world of 2, train() refuses a grad-accum microbatch that does
    not split over the ranks before any step, with JAX's message."""
    from food101_sr_tpu_torch.training import train

    world_of(0)
    with pytest.raises(ValueError, match="multiple of the 2 processes"):
        train({"dataset": "synthetic", "synthetic_size": 16,
               "crop_size": 32, "batch_size": 6, "grad_accum": 2,
               "use_wandb": False}, device="cpu")


def test_preemption_polls_agree_only_on_the_cadence(world_of, monkeypatch):
    """In a world of 2 the flag is agreed every sync_every cumulative
    updates (JAX's cadence), and a local request alone stops nothing in
    between; in a world of 1 the local flag stops at once."""
    asked = []
    monkeypatch.setattr(preempt, "agree",
                        lambda flag, device: asked.append(flag) or True)
    guard = PreemptionGuard()
    guard.request()
    assert guard.poll(0) is True and asked == []  # world of 1
    world_of(0)
    assert [guard.poll(i) for i in range(32)] == \
        [(i + 1) % 16 == 0 for i in range(32)]
    assert asked == [True, True]


def test_gan_noise_rows_are_the_global_draws(world_of):
    """A rank's D-step noise is its rows of the global batch's draws from
    the keyed generator, in a one-process run's order and dtypes (the
    real draw in float32, then the fake's in the compute dtype)."""
    hr_u8 = torch.zeros(3, 8, 8, 3, dtype=torch.uint8)
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator().manual_seed(7)
        real = torch.randn((6, 3, 8, 8), generator=gen)
        fake = torch.randn((6, 3, 8, 8), generator=gen, dtype=dtype)
        for r in (0, 1):
            world_of(r)
            got = _noise_rows(torch.Generator().manual_seed(7), hr_u8,
                              dtype)
            assert torch.equal(got[0], real[r::2])
            assert got[1].dtype == dtype and torch.equal(got[1], fake[r::2])


def test_mesh_data_sharding_and_replicate(world_of):
    """``data_sharding`` is a rank's interleaved rows; a mesh spans its
    local devices in every process; ``replicate`` of a module over a local
    mesh gives an independent copy per device."""
    mesh = cpu_mesh(3)
    assert mesh.size == 3 and mesh.devices == (torch.device("cpu"),) * 3
    world_of(1, 4)
    assert torch.equal(data_sharding(torch.arange(8)), torch.tensor([1, 5]))
    assert mesh.size == 12
    world_of(0, 1)
    model = torch.nn.Linear(2, 2)
    copies = replicate(model, mesh)
    assert len(copies) == 3 and len({id(c) for c in copies}) == 3
    assert all(torch.equal(c.weight, model.weight) for c in copies)
    assert replicate(model, cpu_mesh(1)) == [model]
