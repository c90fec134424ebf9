"""The port's CUDA kernels on the card: each against its plain PyTorch
version on the same CUDA tensors, and their launch counters; and one
train step's gradients against the CPU's plain path. Marked
``cuda``; they skip where there is no CUDA device (run them on the GPU host
with ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``)."""
import sys
from pathlib import Path

import pytest
import torch

from food101_sr_tpu_torch.losses import nlpd_loss
from food101_sr_tpu_torch.models import get_model
from food101_sr_tpu_torch.ops.gaussian import depthwise_blur
from food101_sr_tpu_torch.ops.pallas_blur import blur, blur_kernel
from food101_sr_tpu_torch.ops.spatial_mean import (mean_kernel,
                                                   mean_nhwc_kernel,
                                                   mean_plane_kernel,
                                                   spatial_mean,
                                                   spatial_mean_plain)
from food101_sr_tpu_torch.training import (FIRST_LAST, SRTrainState,
                                           make_adam, make_train_step)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


# K1: float32, the same 25 products summed in another order: 1e-5 abs.
# The NLPD pyramid's levels (16 = pred and target of 8 images; 200 and
# 100 px take the 4-column path, 50 and 25 px the 1-column path), odd
# sizes, and a plane narrower than a strip.
@pytest.mark.parametrize("shape", [(16, 3, 200, 200), (16, 3, 100, 100),
                                   (16, 3, 50, 50), (16, 3, 25, 25),
                                   (8, 3, 200, 200), (2, 3, 25, 25),
                                   (3, 5, 37, 61), (1, 1, 1, 70),
                                   (2, 1, 7, 244)])
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


def test_k1_unaligned_view_takes_the_scalar_path(gen):
    """W % 4 == 0 but the data starts 4 bytes past a 16-byte boundary."""
    flat = torch.rand(1 + 2 * 3 * 40 * 48, device="cuda", generator=gen)
    x = flat[1:].view(2, 3, 40, 48)
    assert x.data_ptr() % 16 != 0
    assert (blur_kernel(x) - depthwise_blur(x)).abs().max().item() <= 1e-5


def test_k1_rejects_what_it_cannot_take(gen):
    x = torch.rand(1, 3, 8, 8, device="cuda", generator=gen)
    for bad in (x.double(), x.transpose(2, 3), x[0],
                x.to(memory_format=torch.channels_last)):
        with pytest.raises(ValueError):
            blur_kernel(bad)
    with pytest.raises(ValueError):
        blur_kernel(x, size=7)


def test_k1_refuses_size_3_and_names_it(gen):
    """The kernel has 5 taps compiled in: another size raises, it never
    falls back to the plain conv."""
    x = torch.rand(1, 3, 8, 8, device="cuda", generator=gen)
    n0 = blur_kernel.launches
    with pytest.raises(ValueError, match="size=3"):
        blur_kernel(x, size=3)
    assert blur_kernel.launches == n0


def _counts():
    return mean_nhwc_kernel.launches, mean_plane_kernel.launches


# K2: f32 within 1e-5 relative; bf16 within one bf16 ulp (2**-7 relative
# at the value, both sides accumulate in f32 and round once). Each layout
# goes to its own kernel. Shapes: the serving shapes (224^2 fills clusters
# of 16), C = 64 and 3 (3 takes the element-by-element path), H*W not a
# multiple of a ring stage or of the cluster, N = 1 and N = 8.
@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2.0**-7)])
@pytest.mark.parametrize("shape", [(8, 96, 64, 64), (2, 96, 224, 224),
                                   (1, 96, 224, 224), (8, 64, 37, 53),
                                   (1, 3, 61, 67), (8, 3, 64, 64),
                                   (3, 5, 13, 7)])
def test_k2_matches_plain(gen, shape, dtype, rtol, layout):
    x = (torch.rand(shape, device="cuda", generator=gen) + 0.25).to(dtype)
    if layout == "nhwc":
        x = x.contiguous(memory_format=torch.channels_last)
    before = _counts()
    got, want = mean_kernel(x), spatial_mean_plain(x)
    assert got.dtype == dtype and got.shape == shape[:2]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=0)
    nhwc, plane = (a - b for a, b in zip(_counts(), before))
    assert (nhwc, plane) == ((1, 0) if layout == "nhwc" else (0, 1))


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2.0**-7)])
def test_k2_nhwc_unaligned_offset_view(gen, dtype, rtol):
    """A channels-last view whose data starts one element past a 16-byte
    boundary: the NHWC kernel reads it element by element."""
    n, c, h, w = 4, 96, 30, 50
    flat = (torch.rand(1 + n * h * w * c, device="cuda", generator=gen)
            + 0.25).to(dtype)
    x = flat[1:].view(n, h, w, c).permute(0, 3, 1, 2)
    assert x.is_contiguous(memory_format=torch.channels_last)
    assert x.data_ptr() % 16 != 0
    n0 = mean_nhwc_kernel.launches
    torch.testing.assert_close(mean_kernel(x).float(),
                               spatial_mean_plain(x).float(), rtol=rtol,
                               atol=0)
    assert mean_nhwc_kernel.launches - n0 == 1


def test_k2_is_deterministic(gen):
    """Fixed-order sums: the same bits on every run."""
    x = torch.randn(8, 96, 224, 224, device="cuda", generator=gen) \
        .to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    first = mean_kernel(x)
    for _ in range(3):
        assert torch.equal(mean_kernel(x), first)


def test_k2_rejects_what_it_cannot_take(gen):
    x = torch.rand(2, 4, 8, 8, device="cuda", generator=gen)
    for bad in (x.double(), x[:, :, ::2], x[0]):
        with pytest.raises(ValueError):
            mean_kernel(bad)


@pytest.mark.parametrize("layout", [torch.contiguous_format,
                                    torch.channels_last])
def test_k2_backward_broadcasts(gen, layout):
    x = torch.rand(2, 4, 6, 10, device="cuda", generator=gen) \
        .contiguous(memory_format=layout).requires_grad_(True)
    g = torch.rand(2, 4, device="cuda", generator=gen)
    (spatial_mean(x) * g).sum().backward()
    torch.testing.assert_close(
        x.grad, (g / 60.0)[:, :, None, None].expand(2, 4, 6, 10))


def test_train_step_gradients_match_the_cpu_plain_path(gen):
    """Registry AttentionSR x4 (32 x 96): one step's raw gradients on 2
    crops of 96 px through K1 and K2 (8 and 32 launches), TF32 off, held
    per leaf to the CPU's plain path as chip_smoke.py holds them (5e-5 of
    the leaf's largest sum of absolute terms); then one Adam step on the
    card leaves finite weights."""
    model = get_model("AttentionSR", device="cuda")
    n1, n2 = blur_kernel.launches, mean_nhwc_kernel.launches
    worst = chip_smoke._grad_check(model, batch=2, crop=96)
    # the card's step, and the CPU copy's and the term sums' plain calls
    assert (blur_kernel.launches - n1, mean_nhwc_kernel.launches - n2) == \
        (8, 32)
    assert worst["term_sum"][0] <= chip_smoke.GRAD_TOL, worst
    state = SRTrainState.create(model, make_adam(4e-4))
    step = make_train_step(model, nlpd_loss, 4, *FIRST_LAST["AttentionSR"])
    hr = torch.randint(0, 256, (2, 96, 96, 3), dtype=torch.uint8,
                       device="cuda", generator=gen)
    state, m = step(state, hr)
    assert float(m["nonfinite_steps"]) == 0.0 and int(state.step) == 1
    assert all(torch.isfinite(p).all() for p in model.parameters())
