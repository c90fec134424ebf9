"""The committed SRCNN asset the card host reads
(``food101_sr_tpu_torch/assets/``, written by ``tools/export_port_assets.py``
from ``weights/winner_srcnn_best``): the state_dict loads strictly and
equals the JAX package's export of the Orbax checkpoint; the port's float32
server on the CPU is within 1 uint8 level of the committed goldens; the
goldens are within 1 level of the JAX server recomputed from the Orbax
checkpoint; the two files stay under 1 MB together."""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401
from PIL import Image

from food101_sr_tpu.training import load_checkpoint as jax_load_checkpoint
from food101_sr_tpu_torch.models import get_model
from food101_sr_tpu_torch.serving import SRServer, load_generator_weights

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import serve as jax_serve  # noqa: E402
from tools.export_port_assets import golden_inputs  # noqa: E402
from tools.export_sr_checkpoint import export_state_dict  # noqa: E402

ASSETS = ROOT / "food101_sr_tpu_torch" / "assets"
PTH, NPZ = ASSETS / "winner_srcnn.pth", ASSETS / "winner_srcnn_goldens.npz"
CHECKPOINT = ROOT / "weights" / "winner_srcnn_best"
LEVEL_TOL = 1  # float32 on both sides: a rounding-boundary flip at most


@pytest.fixture(scope="module")
def goldens():
    g = np.load(NPZ)
    return [(g[f"lr_{i}"], g[f"sr_{i}"]) for i in range(4)]


@pytest.fixture(scope="module")
def port_server():
    srv = SRServer("auto", checkpoint=str(PTH), dtype=torch.float32,
                   device="cpu")
    yield srv
    srv.close()


def test_asset_loads_strictly_and_equals_the_jax_export():
    sd = torch.load(PTH, weights_only=True)
    model = get_model("SRCNN", device="cpu")
    model.load_state_dict(sd, strict=True)
    assert sum(p.numel() for p in model.parameters()) == 24_579
    assert load_generator_weights(str(PTH)).keys() == sd.keys()
    want, arch = export_state_dict(jax_load_checkpoint(str(CHECKPOINT)))
    assert arch == "SRCNN" and want.keys() == sd.keys()
    for k, v in want.items():
        assert sd[k].dtype == torch.float32
        assert np.array_equal(sd[k].numpy(), v), k


def test_goldens_hold_the_seeded_inputs(goldens):
    inputs = golden_inputs()
    assert [x.shape for x, _ in goldens] == [(32, 32, 3)] * 3 + [(96, 80, 3)]
    for (x, y), want in zip(goldens, inputs):
        assert np.array_equal(x, want)
        assert y.shape == (4 * x.shape[0], 4 * x.shape[1], 3)


@pytest.mark.parametrize("i", range(4))
def test_port_server_within_one_level_of_goldens(goldens, port_server, i):
    x, want = goldens[i]
    n0 = port_server.batcher.n_items
    got = port_server.upscale(x)
    # the 96x80 input pads to 128x128 > 64 + 2*8: the tiled path
    assert (port_server.batcher.n_items - n0 > 1) == (i == 3)
    assert np.abs(got.astype(np.int16) - want).max() <= LEVEL_TOL


def test_goldens_within_one_level_of_jax_recomputed(goldens):
    jsrv = jax_serve.SRServer("auto", str(CHECKPOINT), dtype=jnp.float32)
    for x, want in goldens:
        got = np.asarray(jsrv.upscale(Image.fromarray(x)), np.int16)
        assert np.abs(got - want).max() <= LEVEL_TOL


def test_assets_stay_under_one_megabyte():
    assert PTH.stat().st_size + NPZ.stat().st_size < 1 << 20


@pytest.mark.parametrize("kind", ["best-params", "last-ema", "last-raw"])
def test_load_generator_weights_reads_each_checkpoint_kind(tmp_path, kind):
    sd = torch.load(PTH, weights_only=True)
    shifted = {k: v + 1 for k, v in sd.items()}
    if kind == "best-params":
        tree, want = {"params": sd}, sd
    elif kind == "last-ema":
        tree, want = {"g": {"params": sd, "ema_params": shifted,
                            "step": torch.tensor(3)}}, shifted
    else:
        tree, want = {"g": {"params": sd, "step": torch.tensor(3)}}, sd
    path = tmp_path / "ckpt.pth"
    torch.save(tree, path)
    got = load_generator_weights(str(path))
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
