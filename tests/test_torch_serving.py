"""The port's serving engine (food101_sr_tpu_torch.serving) on the CPU: a
2-block AttentionSR on JAX weights serves uint8 within one level of the JAX
forward plus quantization, the tiled path equals the whole-image forward,
concurrent requests coalesce, and the batcher thread is a daemon that
close() stops."""
import ast
import concurrent.futures as cf
import inspect
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from food101_sr_tpu.models.attention_sr import AttentionSR as JaxAttentionSR
from food101_sr_tpu.parallel.spatial import plan_windows as jax_plan_windows
from food101_sr_tpu.parallel.spatial import \
    receptive_radius as jax_receptive_radius
from food101_sr_tpu_torch.convert import params_from_jax
from food101_sr_tpu_torch.models import AttentionSR, build_model
from food101_sr_tpu_torch.parallel import plan_windows, receptive_radius
from food101_sr_tpu_torch.serving import MicroBatcher, SRServer

ROOT = Path(__file__).resolve().parent.parent
TILE = 16  # halo of the 2-block net: 2*2 + 16 = 20 -> windows of 56 px


@pytest.fixture(scope="module")
def nets():
    jnet = JaxAttentionSR(scale_factor=4, num_channels=32, num_residuals=2)
    variables = jnet.init(jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 3)))
    model = build_model(lambda: AttentionSR(4, 32, 2), device="cpu")
    model.load_state_dict(params_from_jax(variables["params"]), strict=True)
    return jnet, variables, model


@pytest.fixture()
def server(nets):
    srv = SRServer(model=nets[2], dtype=torch.float32, device="cpu",
                   tile=TILE)
    yield srv
    srv.close()


def _img(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


def _jax_u8(jnet, variables, x8):
    y = jnet.apply(variables, jnp.asarray(x8, jnp.float32)[None] / 255.0)
    return np.asarray((jnp.clip(y, 0.0, 1.0) * 255.0 + 0.5)
                      .astype(jnp.uint8))[0]


def _levels(a, b):
    return np.abs(a.astype(np.int16) - b.astype(np.int16))


def test_upscale_matches_jax_within_one_level(nets):
    """Weights carried over as a state_dict into a differently seeded net;
    float32 on both sides, so at most a rounding-boundary flip (1 level)."""
    jnet, variables, _ = nets
    other = build_model(lambda: AttentionSR(4, 32, 2), device="cpu",
                        generator=torch.Generator().manual_seed(9))
    srv = SRServer(model=other, state_dict=params_from_jax(
        variables["params"]), dtype=torch.float32, device="cpu", tile=TILE)
    try:
        img = _img(16, 16, seed=0)
        out = srv.upscale(img)
    finally:
        srv.close()
    assert out.dtype == np.uint8 and out.shape == (64, 64, 3)
    assert _levels(out, _jax_u8(jnet, variables, img)).max() <= 1


def test_non_multiple_size_is_edge_padded_and_cropped(server, nets):
    jnet, variables, _ = nets
    img = _img(13, 10, seed=1)
    out = server.upscale(img)
    assert out.shape == (52, 40, 3)
    padded = np.pad(img, ((0, 3), (0, 6), (0, 0)), mode="edge")
    want = _jax_u8(jnet, variables, padded)[:52, :40]
    assert _levels(out, want).max() <= 1


def test_tiled_path_equals_whole_image_forward(server):
    img = _img(64, 72, seed=2)  # padded 64x80 > 56: the tiled path
    b0 = server.batcher.n_items
    out = server.upscale(img)
    assert server.batcher.n_items - b0 > 1  # went through windows
    whole = server.forward_u8(
        torch.from_numpy(np.pad(img, ((0, 0), (0, 8), (0, 0)),
                                mode="edge"))[None])[0].numpy()[:, :288]
    # float32 on both sides; the same pixel may land on the other side of
    # a quantization boundary when conv sums run in another order
    assert out.shape == (256, 288, 3)
    assert _levels(out, whole).max() <= 1


def test_concurrent_requests_coalesce(server):
    imgs = [_img(16, 16, seed=10 + i) for i in range(8)]
    serial = [server.upscale(im) for im in imgs]
    b0 = server.batcher.n_batches
    with cf.ThreadPoolExecutor(max_workers=8) as pool:
        outs = list(pool.map(server.upscale, imgs))
    assert server.batcher.n_batches - b0 < len(imgs)
    for s, o in zip(serial, outs):
        assert _levels(s, o).max() <= 1
    assert server.n_served == 16


def test_batcher_thread_is_daemon_and_close_stops_it(nets):
    srv = SRServer(model=nets[2], dtype=torch.float32, device="cpu",
                   tile=TILE)
    thread = srv.batcher._thread
    assert thread.daemon and thread.is_alive()
    srv.upscale(_img(8, 8, seed=3))
    srv.close()
    assert not thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        srv.upscale(_img(8, 8, seed=3))
    srv.close()  # idempotent


def test_close_serves_queued_work_first():
    gate = threading.Event()

    def fwd(stack):
        gate.wait(5)
        return stack + 1

    mb = MicroBatcher(fwd, max_batch=2, window_ms=1.0)
    with cf.ThreadPoolExecutor(max_workers=3) as pool:
        futs = [pool.submit(mb.submit, np.full((2, 2), i, np.uint8))
                for i in range(3)]
        closer = pool.submit(mb.close)
        gate.set()
        assert [int(f.result(10)[0, 0]) for f in futs] == [1, 2, 3]
        closer.result(10)
    assert not mb._thread.is_alive()


def test_forward_error_reaches_the_caller_and_batcher_survives():
    calls = []

    def fwd(stack):
        calls.append(len(stack))
        if len(calls) == 1:
            raise ValueError("boom")
        return stack

    mb = MicroBatcher(fwd, window_ms=0.0)
    with pytest.raises(ValueError, match="boom"):
        mb.submit(np.zeros((2, 2), np.uint8))
    assert mb.submit(np.ones((2, 2), np.uint8)).sum() == 4
    mb.close()


def test_call_runs_on_the_batcher_thread_and_counts_nothing():
    def boom():
        raise ValueError("boom")

    mb = MicroBatcher(lambda s: s, window_ms=0.0)
    try:
        assert mb.call(threading.current_thread) is mb._thread
        with pytest.raises(ValueError, match="boom"):
            mb.call(boom)
        assert mb.submit(np.ones((2, 2), np.uint8)).sum() == 4
        assert (mb.n_batches, mb.n_items, mb.rows_fetched) == (1, 1, 1)
    finally:
        mb.close()
    with pytest.raises(RuntimeError, match="closed"):
        mb.call(threading.current_thread)


def test_adaptive_window_policy():
    """Fixed window for sparse traffic; after a >=75%-full dispatch the
    window extends toward 0.75 x the batch-exec EMA, capped at 100 ms."""
    mb = MicroBatcher(lambda s: s, max_batch=8, window_ms=3.0, adaptive=True)
    try:
        assert mb.collect_window() == pytest.approx(3e-3)
        mb._ema_exec_s, mb._last_fill = 0.08, 2
        assert mb.collect_window() == pytest.approx(3e-3)
        mb._last_fill = 6
        assert mb.collect_window() == pytest.approx(0.06)
        mb._ema_exec_s = 0.5
        assert mb.collect_window() == pytest.approx(0.1)
        mb.adaptive = False
        assert mb.collect_window() == pytest.approx(3e-3)
    finally:
        mb.close()


def _jax_server_defaults(*names):
    """Defaults of the JAX serve.py SRServer.__init__, read from its
    source (importing serve.py would start nothing, but it is a CLI)."""
    tree = ast.parse((ROOT / "serve.py").read_text())
    cls = next(n for n in tree.body
               if isinstance(n, ast.ClassDef) and n.name == "SRServer")
    init = next(n for n in cls.body
                if isinstance(n, ast.FunctionDef) and n.name == "__init__")
    args = init.args.args + init.args.kwonlyargs
    defaults = ([None] * (len(init.args.args) - len(init.args.defaults))
                + init.args.defaults + init.args.kw_defaults)
    got = dict(zip((a.arg for a in args), defaults))
    return tuple(ast.literal_eval(got[n]) for n in names)


def test_server_window_defaults_match_jax_and_reach_the_batcher(nets):
    """SRServer takes the JAX server's window_ms / adaptive_window (with
    its defaults) and hands them to the micro-batcher."""
    sig = inspect.signature(SRServer).parameters
    assert (sig["window_ms"].default, sig["adaptive_window"].default) == \
        _jax_server_defaults("window_ms", "adaptive_window") == (3.0, False)
    srv = SRServer(model=nets[2], dtype=torch.float32, device="cpu",
                   tile=TILE, window_ms=5.0, adaptive_window=True)
    try:
        assert srv.batcher.window == pytest.approx(5e-3)
        assert srv.batcher.adaptive
        assert srv.upscale(_img(16, 16, 4)).shape == (64, 64, 3)
    finally:
        srv.close()


@pytest.mark.parametrize("h,w,tile,halo", [(256, 256, 64, 80),
                                           (64, 80, 16, 20),
                                           (100, 37, 16, 20),
                                           (64, 64, 64, 80)])
def test_plan_windows_matches_jax(h, w, tile, halo):
    assert plan_windows(h, w, tile, halo) == jax_plan_windows(h, w, tile, halo)


def test_receptive_radius_matches_jax(nets):
    jnet, _, model = nets
    assert receptive_radius("AttentionSR", model) == \
        jax_receptive_radius("AttentionSR", jnet) == 20
    with torch.device("meta"):
        registry_net = AttentionSR(4, 96, 32)
    assert receptive_radius("AttentionSR", registry_net) == \
        jax_receptive_radius("AttentionSR") == 80
    with pytest.raises(ValueError):
        receptive_radius(None, torch.nn.Conv2d(3, 3, 3))


def test_bf16_output_rounds_as_the_jax_server():
    """The JAX server clips, scales and rounds the net's output in its
    dtype and converts to uint8 with saturation: a bf16 output of 1.0
    gives 255.5, which bf16 rounds to 256, served as 255. The port's
    forward_u8 on the SRCNN asset in bf16 (seeded noise, so that outputs
    saturate) equals JAX's rounding of the same bf16 outputs."""
    sd = torch.load(ROOT / "food101_sr_tpu_torch" / "assets" /
                    "winner_srcnn.pth", weights_only=True)
    srv = SRServer("auto", state_dict=sd, dtype=torch.bfloat16,
                   device="cpu", tile=TILE, max_batch=2)
    try:
        x8 = np.random.default_rng(5).integers(0, 256, (2, TILE, TILE, 3),
                                               np.uint8)
        got = srv.forward_u8(torch.from_numpy(x8)).numpy()
        with torch.no_grad():
            y = srv.model((torch.from_numpy(x8).permute(0, 3, 1, 2).float()
                           / 255.0).to(torch.bfloat16))
    finally:
        srv.close()
    yj = jnp.asarray(y.float().permute(0, 2, 3, 1).numpy(), jnp.bfloat16)
    want = np.asarray((jnp.clip(yj, 0.0, 1.0) * 255.0 + 0.5)
                      .astype(jnp.uint8))
    assert (got == 255).any() and np.array_equal(got, want)

