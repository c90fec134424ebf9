"""The port's spatial paths (food101_sr_tpu_torch.parallel.spatial:
tiled_apply, tiled_forward_for; parallel.spatial_mesh:
halo_sharded_apply, halo_sharded_forward_for, row_sharding) and
SRServer(use_mesh=True) / serve --mesh, on the CPU: each against the JAX
package's counterpart on shared weights, JAX's on its virtual CPU mesh,
the port's on ``cpu_mesh(n)`` (n copies of the CPU device, one model
replica each). Narrow nets from test_torch_generators (ResNetSR 2 x 16
with seeded running stats, SRCNN hidden 16) and test_torch_gan_steps
(AttentionSR 2 x 16); images NHWC on the JAX side, NCHW on the port's.
Every float path is held to the JAX tiling tests' 2e-5 absolute and 1e-5
relative; the server's answers to the plain server's, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from food101_sr_tpu.parallel import cpu_mesh as jax_cpu_mesh
from food101_sr_tpu.parallel import halo_sharded_apply as jax_halo_apply
from food101_sr_tpu.parallel import halo_sharded_forward_for as jax_halo_for
from food101_sr_tpu.parallel import tiled_apply as jax_tiled_apply
from food101_sr_tpu.parallel import tiled_forward_for as jax_tiled_for
from food101_sr_tpu_torch import serve
from food101_sr_tpu_torch.parallel import (cpu_mesh, halo_sharded_apply,
                                           halo_sharded_forward_for,
                                           row_sharding, tiled_apply,
                                           tiled_forward_for)
from food101_sr_tpu_torch.serving import SRServer
from test_torch_gan_steps import _jax_g, _port_g
from test_torch_generators import _jax, _port

SCALE = 4
ATOL, RTOL = 2e-5, 1e-5


def _img(b, h, w, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (b, h, w, 3)) \
        .astype(np.float32)


def _jax_fwd(arch):
    net, variables = _jax(arch)
    return jax.jit(lambda x: net.apply(variables, x, train=False))


def _port_fwd(arch):
    model = _port(arch).eval()
    return torch.no_grad()(model)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# overlap tiling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape,tile,halo,kw", [
    ("RESNET", (2, 64, 64), 16, 16, {}),
    ("RESNET", (1, 48, 64), 16, 16, {"max_windows": 5}),  # 12 windows: 3 chunks
    ("SRCNN", (1, 48, 48), 16, 8, {}),
], ids=["resnet", "resnet-chunked", "srcnn"])
def test_tiled_apply_matches_jax(arch, shape, tile, halo, kw):
    x = _img(*shape, 3)
    want = jax_tiled_apply(_jax_fwd(arch), jnp.asarray(x), SCALE, tile, halo,
                           **kw)
    got = tiled_apply(_port_fwd(arch), _nchw(x), SCALE, tile, halo, **kw)
    assert got.shape == (shape[0], 3, shape[1] * SCALE, shape[2] * SCALE)
    _close(got, want)
    _close(_port_fwd(arch)(_nchw(x)), want)  # the whole image too


def test_tiled_chunks_run_one_shape():
    """Every chunk is max_windows windows (the last padded with zero
    windows), so the forward sees a single shape."""
    seen = []
    fwd = _port_fwd("SRCNN")

    def record(x):
        seen.append(tuple(x.shape))
        return fwd(x)

    tiled_apply(record, _nchw(_img(1, 48, 48)), SCALE, 16, 8, max_windows=4)
    assert seen == [(4, 3, 32, 32)] * 3


def test_tiled_sharded_over_a_mesh_matches_jax():
    """The window batch (2 images x 4 x 4 windows) sharded over 4 CPU
    devices, a replica each, against JAX's sharded over its 4."""
    x = _img(2, 64, 64, seed=1)
    want = jax_tiled_apply(_jax_fwd("RESNET"), jnp.asarray(x), SCALE, 16, 16,
                           mesh=jax_cpu_mesh(4))
    mesh = cpu_mesh(4)
    calls = []
    reps = [_port("RESNET").eval() for _ in mesh.devices]

    def rep(i):
        def run(w):
            calls.append((i, w.shape[0]))
            with torch.no_grad():
                return reps[i](w)
        return run

    got = tiled_apply([rep(i) for i in range(4)], _nchw(x), SCALE, 16, 16,
                      mesh=mesh)
    _close(got, want)
    assert calls == [(i, 8) for i in range(4)]
    with pytest.raises(ValueError, match="does not divide"):
        tiled_apply(rep(0), _nchw(_img(1, 48, 48)), SCALE, 16, 16,
                    mesh=cpu_mesh(4))


def test_tiled_forward_for_attention_sr_matches_jax():
    """AttentionSR 2 x 16 (the SE squeeze through K2's plain version on
    the CPU) with its receptive radius, on a 2-device mesh."""
    net, variables = _jax_g()
    x = _img(1, 64, 48, seed=2)
    want = jax_tiled_for(net, variables, "AttentionSR", SCALE, tile=16)(
        jnp.asarray(x))
    got = tiled_forward_for(_port_g(), "AttentionSR", SCALE, tile=16,
                            mesh=cpu_mesh(2))(_nchw(x))
    _close(got, want)


def test_tiled_degenerate_and_bad_shapes():
    x = _nchw(_img(1, 16, 16, seed=4))
    fwd = _port_fwd("RESNET")
    torch.testing.assert_close(tiled_apply(fwd, x, SCALE, 16, 4), fwd(x),
                               atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="multiples of tile"):
        tiled_apply(fwd, _nchw(_img(1, 20, 16)), SCALE, 16, 4)


# ---------------------------------------------------------------------------
# halo exchange
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape,halo", [
    ("RESNET", (2, 128, 24), 16),   # slab 32 = 2 * halo
    ("SRCNN", (1, 64, 20), 8),
], ids=["resnet", "srcnn"])
def test_halo_sharded_apply_matches_jax_on_a_mesh_of_4(arch, shape, halo):
    """Rows over 4 devices, both clamped border slabs included, against
    JAX's shard_map over its 4 CPU devices and the whole image."""
    x = _img(*shape, 5)
    want = jax_halo_apply(_jax_fwd(arch), jnp.asarray(x), SCALE, halo,
                          jax_cpu_mesh(4))
    got = halo_sharded_apply(_port_fwd(arch), _nchw(x), SCALE, halo,
                             cpu_mesh(4))
    _close(got, want)
    _close(_port_fwd(arch)(_nchw(x)), want)


def test_halo_sharded_forward_for_attention_sr_matches_jax():
    """AttentionSR 2 x 16 (receptive radius 20, slab 40 rows) over 4
    replicas against JAX's halo_sharded_forward_for over its 4 CPU
    devices. Not against the whole image: each SE block squeezes its
    window's mean, so a window sees another mean than the whole image
    (0.0021 apart here; the card holds the registry net to 1 uint8 level
    of the whole image)."""
    net, variables = _jax_g()
    x = _img(1, 160, 12, seed=6)
    want = jax_halo_for(net, variables, "AttentionSR", SCALE,
                        jax_cpu_mesh(4))(jnp.asarray(x))
    mesh = cpu_mesh(4)
    got = halo_sharded_forward_for(_port_g(), "AttentionSR", SCALE, mesh)(
        _nchw(x))
    _close(got, want)
    assert [s.shape[2] for s in row_sharding(_nchw(x), mesh)] == [40] * 4


def test_halo_sharded_degenerate_and_bad_shapes():
    fwd = _port_fwd("RESNET")
    x = _nchw(_img(1, 32, 16, seed=1))
    torch.testing.assert_close(halo_sharded_apply(fwd, x, SCALE, 8,
                                                  cpu_mesh(1)), fwd(x),
                               atol=1e-6, rtol=0)
    mesh = cpu_mesh(4)
    with pytest.raises(ValueError, match="divide"):
        halo_sharded_apply(fwd, _nchw(_img(1, 50, 16)), SCALE, 4, mesh)
    with pytest.raises(ValueError, match="2\\*halo"):
        halo_sharded_apply(fwd, _nchw(_img(1, 32, 16)), SCALE, 8, mesh)


# ---------------------------------------------------------------------------
# SRServer(use_mesh=True), serve --mesh
# ---------------------------------------------------------------------------

def _requests(n, side, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (side, side, 3), np.uint8) for _ in range(n)]


def test_mesh_server_equals_the_plain_server_bit_for_bit():
    """ResNetSR (float32) served over cpu_mesh(2) with max_batch 3: rounded
    up to 4, each device running 2 rows of every device batch; each
    answer, small and tiled, equals a plain server's at max_batch 2 (the
    same per-device shape)."""
    sd = _port("RESNET").state_dict()
    kw = dict(model=_port("RESNET"), state_dict=sd, device="cpu",
              dtype=torch.float32, tile=16)
    mesh_srv = SRServer(use_mesh=True, mesh=cpu_mesh(2), max_batch=3, **kw)
    plain = SRServer(max_batch=2, **kw)
    rows = []
    for m in mesh_srv.replicas:
        m.register_forward_pre_hook(lambda mod, a: rows.append(a[0].shape[0]))
    try:
        assert mesh_srv.batcher.max_batch == 4
        assert len(mesh_srv.replicas) == 2
        for img in _requests(3, 16, 7) + _requests(1, 80, 8):
            assert np.array_equal(mesh_srv.upscale(img), plain.upscale(img))
        assert set(rows) == {2}
    finally:
        mesh_srv.close()
        plain.close()


def test_serve_mesh_flag_builds_a_mesh_server(monkeypatch):
    """``serve --mesh`` reaches SRServer(use_mesh=True): on the CPU a mesh
    of the CPU device unless one is given; here the test's cpu_mesh(2)."""
    seen = {}

    class Server(SRServer):
        def __init__(self, *a, **kw):
            seen.update(kw)
            super().__init__(*a, **{**kw, "mesh": cpu_mesh(2)})

    monkeypatch.setattr(serve, "SRServer", Server)
    a = serve.parse_args(["--mesh", "--architecture", "SRCNN", "--device",
                          "cpu", "--dtype", "float32", "--tile", "16",
                          "--max_batch", "3"])
    srv, default = serve.build_servers(a)
    try:
        assert seen["use_mesh"] is True and default is None
        assert srv.batcher.max_batch == 4 and len(srv.mesh.devices) == 2
        img = _requests(1, 16, 9)[0]
        assert srv.upscale(img).shape == (64, 64, 3)
    finally:
        srv.close()
    one = SRServer("SRCNN", device="cpu", dtype=torch.float32, tile=16,
                   use_mesh=True)
    try:
        assert len(one.mesh.devices) == 1 and one.replicas == [one.model]
    finally:
        one.close()
