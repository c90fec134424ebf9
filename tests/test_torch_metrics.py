"""The port's metrics and NLPD loss against the JAX package on the CPU
(float32; inputs from a seeded numpy generator through both packages)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from food101_sr_tpu.losses.nlpd import laplacian_pyramid as jax_pyramid
from food101_sr_tpu.losses.nlpd import nlpd_loss as jax_nlpd
from food101_sr_tpu.metrics.metrics import psnr as jax_psnr
from food101_sr_tpu.metrics.metrics import ssim as jax_ssim
from food101_sr_tpu_torch.losses import laplacian_pyramid, nlpd_loss
from food101_sr_tpu_torch.metrics import MetricsCalculator, psnr, ssim


def _pair(shape=(2, 40, 36, 3), seed=0):
    rng = np.random.default_rng(seed)
    hr = rng.uniform(0, 1, shape).astype(np.float32)
    sr = np.clip(hr + rng.normal(0, 0.05, shape), -0.1, 1.1).astype(np.float32)
    return sr, hr


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


# scalar reductions over ~10^4 float32 terms: 1e-5 relative
def test_psnr_matches_jax():
    sr, hr = _pair()
    want = float(jax_psnr(jnp.asarray(sr), jnp.asarray(hr)))
    assert float(psnr(_nchw(sr), _nchw(hr))) == pytest.approx(want, rel=1e-5)


def test_ssim_matches_jax():
    sr, hr = _pair()
    want = float(jax_ssim(jnp.asarray(sr), jnp.asarray(hr)))
    got = float(ssim(_nchw(sr), _nchw(hr)))
    assert got == pytest.approx(want, rel=1e-5, abs=1e-6)
    assert float(ssim(_nchw(hr), _nchw(hr))) == pytest.approx(1.0, abs=1e-6)


def test_laplacian_pyramid_matches_jax():
    sr, _ = _pair((1, 50, 50, 3))
    want = jax_pyramid(jnp.asarray(sr))
    got = laplacian_pyramid(_nchw(sr))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), atol=2e-6, rtol=0)


@pytest.mark.parametrize("shape", [(2, 40, 36, 3), (1, 25, 25, 3)])
def test_nlpd_loss_matches_jax(shape):
    sr, hr = _pair(shape, seed=1)
    want = float(jax_nlpd(jnp.asarray(sr), jnp.asarray(hr)))
    got = float(nlpd_loss(_nchw(sr), _nchw(hr)))
    assert got == pytest.approx(want, rel=1e-5)


def _nlpd_unbatched(pred, target, n_levels=4, alpha=0.7):
    """nlpd_loss with the pred and target pyramids built one after the
    other (the form the batched pyramid replaces)."""
    pyr_p = laplacian_pyramid(pred, n_levels)
    pyr_t = laplacian_pyramid(target, n_levels)
    lap = sum(torch.mean(torch.abs(p - t)) for p, t in zip(pyr_p, pyr_t))
    return alpha * torch.mean(torch.abs(pred - target)) + (1 - alpha) * lap


# one pyramid over cat([pred, target]): the same per-plane arithmetic, so
# value and input gradient agree with JAX and with the unbatched form to
# float32 rounding (1e-5 rel on the value, 1e-6 abs on the gradient,
# whose entries are ~1e-5)
@pytest.mark.parametrize("shape", [(2, 40, 36, 3), (1, 25, 25, 3)])
def test_batched_pyramid_nlpd_value_and_gradient(shape):
    sr, hr = _pair(shape, seed=4)
    want = float(jax_nlpd(jnp.asarray(sr), jnp.asarray(hr)))
    want_g = np.asarray(jax.grad(jax_nlpd)(jnp.asarray(sr), jnp.asarray(hr)))
    a = _nchw(sr).requires_grad_(True)
    got = nlpd_loss(a, _nchw(hr))
    got.backward()
    b = _nchw(sr).requires_grad_(True)
    ref = _nlpd_unbatched(b, _nchw(hr))
    ref.backward()
    assert got.item() == pytest.approx(want, rel=1e-5)
    assert got.item() == pytest.approx(ref.item(), rel=1e-6)
    np.testing.assert_allclose(a.grad.permute(0, 2, 3, 1).numpy(), want_g,
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=1e-7,
                               rtol=0)


def test_nlpd_gradient_matches_plain_autograd(monkeypatch):
    """The K1 autograd rule inside the pyramid gives the same input gradient
    as autograd through the plain conv (1e-6 abs)."""
    from food101_sr_tpu_torch.ops import gaussian, pallas_blur

    sr, hr = _pair((1, 24, 20, 3), seed=2)
    a = _nchw(sr).requires_grad_(True)
    nlpd_loss(a, _nchw(hr)).backward()
    monkeypatch.setattr(pallas_blur, "blur", gaussian.depthwise_blur)
    b = _nchw(sr).requires_grad_(True)
    nlpd_loss(b, _nchw(hr)).backward()
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=1e-6)


def test_metrics_calculator_matches_jax_on_clamped_inputs():
    """compute() clamps to [0, 1] and returns the three metrics as floats
    (NHWC in, like the JAX MetricsCalculator; LPIPS is not ported yet)."""
    sr, hr = _pair(seed=3)
    out = MetricsCalculator(device="cpu").compute(sr, hr)
    assert set(out) == {"psnr", "ssim", "nlpd"}
    s, h = jnp.clip(jnp.asarray(sr), 0, 1), jnp.clip(jnp.asarray(hr), 0, 1)
    assert out["psnr"] == pytest.approx(float(jax_psnr(s, h)), rel=1e-5)
    assert out["ssim"] == pytest.approx(float(jax_ssim(s, h)), rel=1e-5)
    assert out["nlpd"] == pytest.approx(float(jax_nlpd(s, h)), rel=1e-5)
    assert MetricsCalculator(device="cpu").compute(
        torch.from_numpy(sr), torch.from_numpy(hr)) == out
