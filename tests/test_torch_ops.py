"""The port's ops (food101_sr_tpu_torch.ops) against the JAX package on the
CPU: the plain versions of kernels K1 (blur) and K2 (spatial mean) against
the Pallas kernels run in interpret mode, the autograd rules of both, the
matmul resizes, and the pixel-shuffle channel order. Inputs come from a
seeded numpy generator and go through both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from food101_sr_tpu.ops.pixel_shuffle import pixel_shuffle as jax_pixel_shuffle
from food101_sr_tpu.ops import resize as jax_resize
from food101_sr_tpu.ops.gaussian import depthwise_blur as jax_depthwise_blur
from food101_sr_tpu.ops.gaussian import gaussian_kernel_2d as jax_k2d
from food101_sr_tpu.ops.pallas_blur import _gaussian_taps as jax_taps
from food101_sr_tpu.ops.pallas_blur import blur_pallas
from food101_sr_tpu.ops.spatial_mean import spatial_mean_pallas
from food101_sr_tpu_torch.ops import (blur, blur_kernel, degrade_bicubic,
                                      depthwise_blur, depthwise_blur_fast,
                                      kernel_layout, mean_kernel,
                                      resample_matrix, resize_bicubic_torch,
                                      resize_bilinear_torch)
from food101_sr_tpu_torch.ops.pallas_blur import _gaussian_taps
from food101_sr_tpu_torch.ops.spatial_mean import spatial_mean
from food101_sr_tpu_torch.ops.gaussian import gaussian_kernel_2d


def _nhwc(shape, seed, lo=0.0, hi=1.0, dtype=np.float32):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(dtype)


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).float().numpy()


def test_gaussian_kernel_and_taps_match_jax():
    np.testing.assert_array_equal(gaussian_kernel_2d(5, 1.0), jax_k2d(5, 1.0))
    assert _gaussian_taps(5, 1.0) == jax_taps(5, 1.0)


# K1's plain version vs the Pallas kernel (interpret mode) and the XLA conv;
# the shapes include the NLPD metric's odd pyramid levels. Tolerance 1e-6
# abs: both compute a 25-term float32 sum of values in [0, 1].
@pytest.mark.parametrize("shape", [(2, 24, 40, 3), (1, 25, 25, 3),
                                   (2, 13, 7, 2)])
def test_blur_plain_matches_pallas(shape):
    x = _nhwc(shape, seed=0)
    want_pallas = np.asarray(blur_pallas(jnp.asarray(x), 5, 1.0, True))
    want_xla = np.asarray(jax_depthwise_blur(jnp.asarray(x), 5, 1.0))
    got = _to_nhwc(blur_kernel(_nchw(x)))
    np.testing.assert_allclose(got, want_pallas, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, want_xla, atol=1e-6, rtol=0)
    np.testing.assert_allclose(_to_nhwc(depthwise_blur_fast(_nchw(x))),
                               want_pallas, atol=1e-6, rtol=0)


def test_blur_zero_padding_borders():
    x = torch.ones(1, 1, 16, 16)
    y = blur_kernel(x)
    assert float(y[0, 0, 0, 0]) < 1.0  # the zero padding leaks in
    assert abs(float(y[0, 0, 8, 8]) - 1.0) < 1e-6


def test_blur_backward_is_the_self_adjoint_blur():
    """The autograd.Function's backward (the blur of the cotangent) equals
    autograd through the plain conv and JAX's custom VJP (1e-5 abs)."""
    x = _nhwc((1, 12, 20, 2), seed=1)
    g = _nhwc((1, 12, 20, 2), seed=2)
    xt = _nchw(x).requires_grad_(True)
    (blur(xt) * _nchw(g)).sum().backward()
    xr = _nchw(x).requires_grad_(True)
    (depthwise_blur(xr) * _nchw(g)).sum().backward()
    want = jax.grad(lambda a: jnp.vdot(blur_pallas(a, 5, 1.0, True),
                                       jnp.asarray(g)))(jnp.asarray(x))
    np.testing.assert_allclose(_to_nhwc(xt.grad), _to_nhwc(xr.grad),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(_to_nhwc(xt.grad), np.asarray(want),
                               atol=1e-5, rtol=0)


def test_depthwise_blur_fast_keeps_dtype():
    x = torch.rand(1, 3, 9, 9, generator=torch.Generator().manual_seed(0))
    y = depthwise_blur_fast(x.to(torch.bfloat16))
    assert y.dtype == torch.bfloat16 and y.shape == x.shape


# K2's plain version vs the Pallas kernel (interpret mode). f32: 1e-6 rel.
# bf16: the plain version and the Pallas kernel both accumulate in f32 and
# round once, so they may differ by 1 bf16 ulp (2**-7 relative).
@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-6),
                                        (jnp.bfloat16, 2.0**-7)])
@pytest.mark.parametrize("shape", [(2, 13, 9, 5), (8, 16, 16, 96)])
def test_spatial_mean_plain_matches_pallas(shape, dtype, rtol):
    x32 = _nhwc(shape, seed=3, lo=-2.0, hi=2.0)
    xj = jnp.asarray(x32).astype(dtype)
    want = np.asarray(spatial_mean_pallas(xj, True).astype(jnp.float32))
    xt = _nchw(np.asarray(xj.astype(jnp.float32)))
    if dtype is jnp.bfloat16:
        xt = xt.to(torch.bfloat16)
    got = mean_kernel(xt)
    assert got.dtype == xt.dtype and got.shape == (shape[0], shape[3])
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=1e-7)
    assert torch.equal(spatial_mean(xt), got)


# K2 on channels-last input, the NHWC kernel's layout: the JAX array and the
# tensor are one NHWC buffer (the tensor a permuted view of it, no copy).
# f32: 1e-6 rel. bf16: both sides accumulate in f32 and round once, so at
# most 1 bf16 ulp (2**-7 relative at the value).
@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-6),
                                        (jnp.bfloat16, 2.0**-7)])
@pytest.mark.parametrize("shape", [(2, 13, 9, 5), (8, 16, 16, 96),
                                   (3, 7, 5, 1)])
def test_spatial_mean_channels_last_matches_pallas(shape, dtype, rtol):
    buf = _nhwc(shape, seed=10, lo=-2.0, hi=2.0).astype(dtype)
    if dtype is jnp.bfloat16:  # torch.from_numpy has no bfloat16
        xt = torch.from_numpy(buf.view(np.int16)).view(torch.bfloat16)
    else:
        xt = torch.from_numpy(buf)
    xt = xt.permute(0, 3, 1, 2)
    assert xt.is_contiguous(memory_format=torch.channels_last)
    assert xt.data_ptr() == buf.__array_interface__["data"][0]
    assert kernel_layout(xt) == "nhwc"
    xj = jnp.asarray(buf)
    want_pallas = np.asarray(spatial_mean_pallas(xj, True).astype(jnp.float32))
    want_mean = np.asarray(jnp.mean(xj.astype(jnp.float32), (1, 2))
                           .astype(dtype).astype(jnp.float32))
    got = mean_kernel(xt)
    assert got.dtype == xt.dtype and got.shape == (shape[0], shape[3])
    for want in (want_pallas, want_mean):
        np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                                   atol=1e-7)
    assert torch.equal(spatial_mean(xt), got)


# the layout comes from the strides: C == 1 or H*W == 1 is contiguous in
# both formats (the same bytes) and goes to the NHWC kernel; a view that is
# dense in neither is refused
@pytest.mark.parametrize("shape,to,want", [
    ((2, 5, 4, 3), torch.channels_last, "nhwc"),
    ((2, 5, 4, 3), torch.contiguous_format, "nchw"),
    ((2, 1, 4, 3), torch.contiguous_format, "nhwc"),
    ((2, 5, 1, 1), torch.contiguous_format, "nhwc"),
    ((2, 5, 1, 1), torch.channels_last, "nhwc")])
def test_spatial_mean_layout_decision(shape, to, want):
    x = torch.rand(shape).contiguous(memory_format=to)
    assert kernel_layout(x) == want
    torch.testing.assert_close(mean_kernel(x), x.mean((2, 3)), rtol=1e-6,
                               atol=1e-7)
    with pytest.raises(ValueError, match="contiguous"):
        kernel_layout(torch.rand(2, 5, 8, 6)[:, :, ::2])


def test_spatial_mean_backward_broadcasts_g_over_hw():
    """The autograd.Function's backward equals autograd of x.mean((2, 3))
    and JAX's VJP (1e-7 abs: one multiply each)."""
    x = _nhwc((2, 6, 10, 4), seed=4)
    g = _nhwc((2, 4), seed=5)
    xt = _nchw(x).requires_grad_(True)
    (spatial_mean(xt) * torch.from_numpy(g)).sum().backward()
    xr = _nchw(x).requires_grad_(True)
    (xr.mean((2, 3)) * torch.from_numpy(g)).sum().backward()
    want = jax.grad(lambda a: jnp.vdot(spatial_mean_pallas(a, True),
                                       jnp.asarray(g)))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), xr.grad.numpy(), atol=1e-7)
    np.testing.assert_allclose(_to_nhwc(xt.grad), np.asarray(want), atol=1e-7)


@pytest.mark.parametrize("args", [(200, 50, "cubic", -0.5, True),
                                  (50, 200, "cubic", -0.75, False),
                                  (25, 50, "linear", -0.75, False),
                                  (13, 7, "linear", -0.75, True)])
def test_resample_matrix_matches_jax(args):
    np.testing.assert_array_equal(resample_matrix(*args),
                                  jax_resize.resample_matrix(*args))


# The resizes are two float32 matmuls on both sides (HIGHEST precision in
# JAX); 2e-6 abs covers the summation-order difference for [0, 1] inputs.
def test_degrade_bicubic_matches_jax():
    hr = _nhwc((2, 48, 40, 3), seed=6)
    want = np.asarray(jax_resize.degrade_bicubic(jnp.asarray(hr), 4))
    got = _to_nhwc(degrade_bicubic(_nchw(hr), 4))
    assert got.shape == (2, 12, 10, 3)
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


@pytest.mark.parametrize("antialias", [False, True])
def test_resize_bicubic_torch_matches_jax(antialias):
    x = _nhwc((1, 10, 14, 3), seed=7)
    want = np.asarray(jax_resize.resize_bicubic_torch(
        jnp.asarray(x), 25, 9, antialias=antialias))
    got = _to_nhwc(resize_bicubic_torch(_nchw(x), 25, 9, antialias=antialias))
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


def test_resize_bilinear_torch_matches_jax_and_interpolate():
    x = _nhwc((2, 25, 25, 3), seed=8)
    want = np.asarray(jax_resize.resize_bilinear_torch(jnp.asarray(x), 50, 50))
    got = resize_bilinear_torch(_nchw(x), 50, 50)
    np.testing.assert_allclose(_to_nhwc(got), want, atol=2e-6, rtol=0)
    ref = torch.nn.functional.interpolate(_nchw(x), size=(50, 50),
                                          mode="bilinear", align_corners=False)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-6, rtol=0)


# the model's tail uses nn.PixelShuffle (NCHW); JAX's NHWC pixel_shuffle
# has two formulations split at 128x128 px, both pinned here (exact)
@pytest.mark.parametrize("hw", [(6, 5), (130, 129)])
def test_pixel_shuffle_channel_order_matches_jax(hw):
    x = _nhwc((1, *hw, 12), seed=9)
    want = np.asarray(jax_pixel_shuffle(jnp.asarray(x), 2))
    got = _to_nhwc(torch.nn.PixelShuffle(2)(_nchw(x)))
    np.testing.assert_array_equal(got, want)
