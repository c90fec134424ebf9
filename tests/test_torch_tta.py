"""The port's x8 self-ensemble (food101_sr_tpu_torch.ops.tta) on the CPU
in float32: against the JAX package's ``self_ensemble`` on a converted
AttentionSR 2 x 16 (square and non-square inputs, 1e-5 max abs), and
inside the server: two forwards of 4 * max_batch rows per device batch,
the result within 1 uint8 level of the eight dihedral forwards averaged
by hand and of the JAX server's ``--tta`` on shared SRCNN weights."""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401
from PIL import Image

from food101_sr_tpu.models.attention_sr import AttentionSR as JaxAttentionSR
from food101_sr_tpu.ops import self_ensemble as jax_self_ensemble
from food101_sr_tpu_torch.convert import params_from_jax
from food101_sr_tpu_torch.models import AttentionSR, build_model
from food101_sr_tpu_torch.ops import self_ensemble
from food101_sr_tpu_torch.serving import SRServer

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import serve as jax_serve  # noqa: E402

TOL = 1e-5  # float32 max abs: the same sums in another order


@pytest.fixture(scope="module")
def nets():
    jnet = JaxAttentionSR(scale_factor=4, num_channels=16, num_residuals=2)
    variables = jnet.init(jax.random.PRNGKey(4), jnp.zeros((1, 8, 8, 3)))
    model = build_model(lambda: AttentionSR(4, 16, 2), device="cpu",
                        generator=torch.Generator().manual_seed(1))
    model.load_state_dict(params_from_jax(variables["params"]), strict=True)
    return jnet, variables, model


@pytest.mark.parametrize("h,w", [(12, 12), (10, 14)])
def test_self_ensemble_matches_jax(nets, h, w):
    jnet, variables, model = nets
    x = np.random.default_rng(h * w).random((2, h, w, 3), np.float32)
    want = jax.jit(lambda b: jax_self_ensemble(
        lambda v: jnet.apply(variables, v), b))(jnp.asarray(x))
    with torch.no_grad():
        got = self_ensemble(model, torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 4 * h, 4 * w, 3)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)


def test_self_ensemble_keeps_an_equivariant_forward():
    """A forward that commutes with every flip and transpose (nearest
    upsampling) is its own ensemble; the output dtype is the forward's."""
    x = torch.rand(3, 3, 5, 7, dtype=torch.float64)
    up = torch.nn.Upsample(scale_factor=4, mode="nearest")
    out = self_ensemble(up, x)
    assert out.dtype == torch.float64
    torch.testing.assert_close(out, up(x), atol=1e-12, rtol=0)


def _hand_ensemble(model, img: np.ndarray) -> np.ndarray:
    """The eight dihedral forwards one by one (rotations by torch.rot90,
    not the flips the module uses), undone and averaged; uint8 out."""
    x = torch.from_numpy(img).permute(2, 0, 1)[None].float() / 255.0
    acc = 0
    with torch.no_grad():
        for k in range(4):
            for flip in (False, True):
                t = torch.rot90(x, k, (2, 3))
                t = torch.flip(t, (3,)) if flip else t
                y = model(t)
                y = torch.flip(y, (3,)) if flip else y
                acc = acc + torch.rot90(y, -k, (2, 3))
    y8 = ((acc / 8).clamp(0, 1) * 255 + 0.5).to(torch.uint8)
    return y8[0].permute(1, 2, 0).numpy()


def test_tta_server_runs_4x_max_batch_rows_and_matches_hand_ensemble(nets):
    model = nets[2]
    rows = []
    hook = model.register_forward_pre_hook(
        lambda m, args: rows.append(args[0].shape[0]))
    srv = SRServer(model=model, dtype=torch.float32, device="cpu", tile=16,
                   max_batch=4, tta=True)
    try:
        img = np.random.default_rng(3).integers(0, 256, (16, 16, 3),
                                                np.uint8)
        out = srv.upscale(img)
        assert rows == [16, 16]  # both forwards 4 * max_batch rows
        plain = SRServer(model=model, dtype=torch.float32, device="cpu",
                         tile=16, max_batch=4)
        try:
            rows.clear()
            single = plain.upscale(img)
            assert rows == [4]
        finally:
            plain.close()
    finally:
        hook.remove()
        srv.close()
    lv = np.abs(out.astype(np.int16) - _hand_ensemble(model, img))
    assert lv.max() <= 1
    assert np.abs(out.astype(np.int16) - single).max() > 1  # it ensembles


def test_tta_server_matches_jax_tta_server():
    """SRCNN at registry width with the JAX server's seeded weights, both
    servers --tta in float32, a non-square image (both shape classes)."""
    jsrv = jax_serve.SRServer("SRCNN", None, scale=4, tile=16,
                              dtype=jnp.float32, tta=True)
    srv = SRServer("SRCNN", params_from_jax(jsrv.variables["params"]),
                   dtype=torch.float32, device="cpu", tile=16, tta=True)
    try:
        img = np.random.default_rng(5).integers(0, 256, (20, 12, 3),
                                                np.uint8)
        want = np.asarray(jsrv.upscale(Image.fromarray(img)), np.int16)
        got = srv.upscale(img)
    finally:
        srv.close()
    assert got.shape == want.shape == (80, 48, 3)
    assert np.abs(got.astype(np.int16) - want).max() <= 1
