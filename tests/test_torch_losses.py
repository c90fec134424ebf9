"""The port's loss registry (food101_sr_tpu_torch.losses) against the JAX
package on the CPU: mae, mse, tv (with its weight-squared quirk) and
get_loss_function. Inputs from a seeded numpy generator through both
packages; float32 scalar reductions, so 1e-6 relative."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from food101_sr_tpu.losses import get_loss_function as jax_get_loss_function
from food101_sr_tpu.losses import mae_loss as jax_mae
from food101_sr_tpu.losses import mse_loss as jax_mse
from food101_sr_tpu.losses import tv_loss as jax_tv
from food101_sr_tpu_torch.losses import (PerceptualLoss, get_loss_function,
                                         mae_loss, mse_loss, nlpd_loss,
                                         tv_loss)


def _pair(shape=(2, 20, 18, 3), seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = rng.uniform(0, 1, shape).astype(np.float32)
    return a, b


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("port,ref", [(mae_loss, jax_mae),
                                      (mse_loss, jax_mse)],
                         ids=["mae", "mse"])
def test_pixel_losses_match_jax(port, ref):
    a, b = _pair()
    want = float(ref(jnp.asarray(a), jnp.asarray(b)))
    assert float(port(_nchw(a), _nchw(b))) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("weight", [1.0, 0.5, 3.0])
def test_tv_loss_matches_jax_with_the_weight_squared_quirk(weight):
    a, _ = _pair(seed=1)
    want = float(jax_tv(jnp.asarray(a), weight))
    got = float(tv_loss(_nchw(a), weight))
    assert got == pytest.approx(want, rel=1e-6)
    # the weight enters twice: w^2 times the unit-weight loss
    assert got == pytest.approx(weight**2 * float(tv_loss(_nchw(a))),
                                rel=1e-6)


def test_tv_loss_of_a_constant_image_is_zero():
    assert float(tv_loss(torch.full((2, 3, 8, 8), 0.3))) == 0.0


@pytest.mark.parametrize("name", ["mae", "MSE", "nlpd"])
def test_get_loss_function_matches_jax(name):
    a, b = _pair((1, 32, 32, 3), seed=2)
    want = float(jax_get_loss_function(name)(jnp.asarray(a), jnp.asarray(b)))
    got = float(get_loss_function(name)(_nchw(a), _nchw(b)))
    assert got == pytest.approx(want, rel=1e-5)


def test_get_loss_function_names(tmp_path):
    assert get_loss_function("nlpd") is nlpd_loss
    with pytest.warns(UserWarning, match="vgg19_features.npz"):
        percep = get_loss_function("Perceptual", weights_dir=str(tmp_path),
                                   device="cpu")
    assert isinstance(percep, PerceptualLoss) and not percep.pretrained
    x = torch.rand(1, 3, 16, 16)
    assert float(percep(x, x)) == 0.0
    with pytest.raises(ValueError, match="Unknown"):
        get_loss_function("l3")
