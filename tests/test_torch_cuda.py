"""The port's CUDA kernels on the card: each against its plain PyTorch
version on the same CUDA tensors, and their launch counters. Marked
``cuda``; they skip where there is no CUDA device (run them on the GPU host
with ``python -m pytest -m cuda tests/test_torch_cuda.py``)."""
import pytest
import torch

from food101_sr_tpu_torch.ops.gaussian import depthwise_blur
from food101_sr_tpu_torch.ops.pallas_blur import blur, blur_kernel
from food101_sr_tpu_torch.ops.spatial_mean import (mean_kernel, spatial_mean,
                                                   spatial_mean_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


# K1: float32, the same 25 products summed in another order: 1e-5 abs
@pytest.mark.parametrize("shape", [(8, 3, 200, 200), (2, 3, 25, 25),
                                   (3, 5, 37, 61), (1, 1, 1, 70)])
def test_k1_matches_plain_forward_and_backward(gen, shape):
    x = torch.rand(shape, device="cuda", generator=gen)
    g = torch.rand(shape, device="cuda", generator=gen)
    n0 = blur_kernel.launches
    assert (blur_kernel(x) - depthwise_blur(x)).abs().max().item() <= 1e-5
    xa = x.clone().requires_grad_(True)
    (blur(xa) * g).sum().backward()
    xb = x.clone().requires_grad_(True)
    (depthwise_blur(xb) * g).sum().backward()
    assert (xa.grad - xb.grad).abs().max().item() <= 1e-5
    assert blur_kernel.launches - n0 == 3  # forward, forward, backward


def test_k1_rejects_what_it_cannot_take(gen):
    x = torch.rand(1, 3, 8, 8, device="cuda", generator=gen)
    for bad in (x.double(), x.transpose(2, 3), x[0]):
        with pytest.raises(ValueError):
            blur_kernel(bad)
    with pytest.raises(ValueError):
        blur_kernel(x, size=7)


# K2: f32 within 1e-5 relative; bf16 within one bf16 ulp (2**-7 relative
# at the value, both sides accumulate in f32 and round once)
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2.0**-7)])
@pytest.mark.parametrize("shape", [(8, 96, 64, 64), (2, 96, 224, 224),
                                   (3, 5, 13, 7)])
def test_k2_matches_plain(gen, shape, dtype, rtol):
    x = (torch.rand(shape, device="cuda", generator=gen) + 0.25).to(dtype)
    n0 = mean_kernel.launches
    got, want = mean_kernel(x), spatial_mean_plain(x)
    assert got.dtype == dtype and got.shape == shape[:2]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=0)
    assert mean_kernel.launches - n0 == 1


def test_k2_backward_broadcasts(gen):
    x = torch.rand(2, 4, 6, 10, device="cuda", generator=gen,
                   requires_grad=True)
    g = torch.rand(2, 4, device="cuda", generator=gen)
    (spatial_mean(x) * g).sum().backward()
    torch.testing.assert_close(
        x.grad, (g / 60.0)[:, :, None, None].expand(2, 4, 6, 10))
