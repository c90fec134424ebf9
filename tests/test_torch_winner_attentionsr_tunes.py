"""The committed AttentionSR x4 fine-tunes the card host reads: the GAN
winner (``food101_sr_tpu_torch/assets/winner_attentionsr_gan.f101w``) and
the QAT winner (``winner_attentionsr_qat.f101w``), each a bfloat16 delta
against ``winner_attentionsr.f101w``, with goldens
(``winner_attentionsr_tunes_goldens.npz``) that the JAX package computed
on the same bfloat16-rounded weights, widened to float32 (written by
``tools/export_port_assets.py --what attentionsr_tunes``). Each case runs
for both: the goldens' outputs are x4 the tool's inputs, which are the
AttentionSR goldens' LRs; the port's float32 ``SRServer("auto")`` on the
CPU is within 1 uint8 level of the goldens on the four small inputs (the
fifth, which takes the tiled path, costs ~100 s a net on one CPU thread
and is held on the card by ``chip_smoke.py``'s winner phase); the JAX
server recomputed on the rounded weights is within 1 level of its golden
on the smallest input. (The packs themselves are held to the Orbax
weights in ``test_torch_packed.py``.)"""
import concurrent.futures as cf

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch_threads import one_thread  # noqa: F401

from food101_sr_tpu_torch import native
from food101_sr_tpu_torch.serving import SRServer
from test_torch_winner_attentionsr import (ASSETS, LEVEL_TOL, SMALL,
                                           goldens, jax_serve, tool_hr,
                                           winner_lr)
from tools.export_port_assets import ATTN_TUNES, rounded_checkpoint

NPZ = ASSETS / "winner_attentionsr_tunes_goldens.npz"
TAGS = list(ATTN_TUNES)
assert TAGS == ["attentionsr_gan", "attentionsr_qat"]

each = pytest.mark.parametrize("tag", TAGS)


@pytest.fixture(scope="module")
def outputs():
    """JAX's float32 served outputs by tag, as stored in the goldens."""
    g = np.load(NPZ)
    assert not any(k.startswith("lr_") for k in g.files)  # not stored twice
    return {tag: [native.decode_image(g[f"{tag}_sr_{i}"].tobytes())
                  for i in range(SMALL + 1)] for tag in TAGS}


@pytest.fixture(scope="module")
def port_served(goldens):
    """The port's float32 server's outputs for the four small inputs by
    tag, sent at once so that they share one device batch."""
    out = {}
    for tag in TAGS:
        srv = SRServer("auto", checkpoint=str(ASSETS / f"winner_{tag}.f101w"),
                       dtype=torch.float32, device="cpu")
        try:
            with cf.ThreadPoolExecutor(SMALL) as pool:
                out[tag] = list(pool.map(srv.upscale,
                                         [x for x, _ in goldens[:SMALL]]))
            assert srv.architecture == "AttentionSR"
        finally:
            srv.close()
    return out


@each
def test_goldens_are_x4_of_the_tool_inputs(tag, goldens, tool_hr, outputs):
    for i, (x, _) in enumerate(goldens):
        assert np.array_equal(x, winner_lr(tool_hr[i]))
        assert outputs[tag][i].shape == tool_hr[i].shape
    assert goldens[SMALL][0].shape[:2] == (200, 152)  # the tiled path


@each
@pytest.mark.parametrize("i", range(SMALL))
def test_port_server_within_one_level_of_goldens(tag, i, outputs,
                                                 port_served):
    got, want = port_served[tag][i], outputs[tag][i]
    assert got.shape == want.shape
    assert np.abs(got.astype(np.int16) - want).max() <= LEVEL_TOL


@each
def test_goldens_within_one_level_of_jax_recomputed(tag, goldens, outputs,
                                                     tmp_path):
    # the smallest input: one device batch of the 64x64 bucket
    i = min(range(SMALL), key=lambda j: goldens[j][0].size)
    ckpt = rounded_checkpoint(ATTN_TUNES[tag], str(tmp_path / tag))
    jsrv = jax_serve.SRServer("auto", ckpt, dtype=jnp.float32)
    got = np.asarray(jsrv.upscale(Image.fromarray(goldens[i][0])), np.int16)
    assert np.abs(got - outputs[tag][i]).max() <= LEVEL_TOL


@each
def test_rounding_cost_is_recorded(tag):
    """The goldens keep what the bfloat16 rounding costs JAX's float32
    server: its PSNR on the Orbax weights beside the rounded ones', and the
    largest level difference of the two outputs per input."""
    g = np.load(NPZ)
    assert g[f"{tag}_psnr_orbax"].shape == (SMALL,)
    assert np.abs(g[f"{tag}_psnr_orbax"] - g[f"{tag}_psnr"]).max() < 0.05
    assert g[f"{tag}_levels_orbax"].shape == (SMALL + 1,)
    assert 0 < g[f"{tag}_levels_orbax"].max() <= 8


def test_goldens_stay_under_1_5_megabytes():
    assert NPZ.stat().st_size <= 1_500_000
