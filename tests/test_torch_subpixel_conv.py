"""The port's phase-space convs and pixel shuffles
(food101_sr_tpu_torch.ops.subpixel_conv, .pixel_shuffle) against the JAX
package's and against the direct conv, on the CPU in float32: the
shuffle's channel identity, the kernel gathers bit-equal to JAX's, the
three phase forms for k in {3, 9} and r in {2, 4} (relative to the
output's peak, 1e-5: the same products summed in another order), the
static maps as tuples equal to JAX's, and gradients through the gather."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401
import torch.nn.functional as F

from food101_sr_tpu.ops import subpixel_conv as jsub
from food101_sr_tpu.ops.pixel_shuffle import pixel_shuffle as jax_shuffle
from food101_sr_tpu.ops.pixel_shuffle import pixel_unshuffle as jax_unshuffle
from food101_sr_tpu_torch.ops import subpixel_conv as sub
from food101_sr_tpu_torch.ops.pixel_shuffle import (pixel_shuffle,
                                                    pixel_unshuffle)

CL = torch.channels_last
KR = [(k, r) for k in (3, 9) for r in (2, 4)]
CIN, COUT = 4, 3


def _nchw(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> (N, C, H, W) channels-last torch (the nets' format)."""
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> np.ndarray:
    return y.detach().permute(0, 2, 3, 1).numpy()


def _data(k, r, seed, cin=CIN, cout=COUT, side=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, side * r, side * r, cin)).astype(np.float32)
    z = rng.standard_normal((2, side, side, cin * r * r)).astype(np.float32)
    w = rng.standard_normal((k, k, cin, cout)).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    return x, z, w, b


def _oihw(w: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _close(got: np.ndarray, want: np.ndarray):
    assert got.shape == want.shape
    peak = np.abs(want).max()
    np.testing.assert_allclose(got / peak, want / peak, rtol=0, atol=1e-5)


def test_pixel_shuffle_identity_and_inverse():
    """The channel index ``c*r*r + i*r + j`` is nn.PixelShuffle's and
    JAX's; unshuffle inverts it exactly; channels-last in and out."""
    rng = np.random.default_rng(0)
    for r in (2, 3, 4):
        z = rng.standard_normal((2, 5, 7, 3 * r * r)).astype(np.float32)
        got = pixel_shuffle(_nchw(z), r)
        assert torch.equal(got, torch.nn.PixelShuffle(r)(_nchw(z)))
        assert np.array_equal(_nhwc(got), np.asarray(jax_shuffle(z, r)))
        assert got.is_contiguous(memory_format=CL)
        back = pixel_unshuffle(got, r)
        assert torch.equal(back, _nchw(z))
        assert torch.equal(back, F.pixel_unshuffle(got, r))
        assert np.array_equal(_nhwc(back),
                              np.asarray(jax_unshuffle(_nhwc(got), r)))
        # one channel alone: pixel (h*r + i, w*r + j) holds channel i*r + j
        c = (1 * r + (r - 1))
        one = torch.zeros(1, r * r, 1, 1)
        one[0, c] = 1.0
        assert pixel_shuffle(one, r)[0, 0, 1, r - 1] == 1.0
    with pytest.raises(ValueError):
        pixel_unshuffle(torch.zeros(1, 3, 5, 4), 2)
    with pytest.raises(ValueError):
        pixel_shuffle(torch.zeros(1, 3, 5, 4), 2)


@pytest.mark.parametrize("k,r", KR)
def test_kernel_gathers_equal_jax(k, r):
    """K' and every K'_p are gathers: bit-equal to JAX's rearranged HWIO
    kernels, with and without ``in_map`` and ``out_perm``."""
    _, _, w, _ = _data(k, r, seed=k + r)
    rng = np.random.default_rng(1)
    in_map = tuple(int(v) for v in rng.permutation(CIN * r * r))
    perm = tuple(int(v) for v in rng.permutation(COUT * r * r))
    wt, wj = _oihw(w), jnp.asarray(w)
    for ps_in, om, im in ((False, None, None), (True, perm, in_map)):
        want = np.asarray(jsub._phase_kernel(wj, r, ps_in, om, im))
        got = sub._phase_kernel(wt, r, ps_in, om, im).numpy()
        assert np.array_equal(got.transpose(2, 3, 1, 0), want)
    for py in range(r):
        for px in range(r):
            want = np.asarray(jsub._grouped_kernel(wj, r, py, px, in_map))
            got = sub._grouped_kernel(wt.contiguous(memory_format=CL), r,
                                      py, px, in_map).numpy()
            assert np.array_equal(got.transpose(2, 3, 1, 0), want)


@pytest.mark.parametrize("k,r", KR)
def test_subpixel_conv2d_matches_jax_and_direct(k, r):
    x, _, w, b = _data(k, r, seed=10 * k + r)
    want = np.asarray(jsub.subpixel_conv2d(x, w, b, r))
    got = sub.subpixel_conv2d(_nchw(x).contiguous(memory_format=CL),
                              _oihw(w), torch.from_numpy(b), r)
    assert got.is_contiguous(memory_format=CL)
    _close(_nhwc(got), want)
    direct = F.conv2d(_nchw(x), _oihw(w), torch.from_numpy(b),
                      padding=(k - 1) // 2)
    _close(_nhwc(got), _nhwc(direct))


@pytest.mark.parametrize("k,r", KR)
def test_phase_conv2d_matches_jax_and_direct(k, r):
    """``phase_conv2d(z) == conv(pixel_shuffle(z))``: with ``shuffle_out``
    the HR image, otherwise its pixel-shuffle layout, re-indexed by
    ``out_perm``; both against JAX's."""
    _, z, w, b = _data(k, r, seed=20 * k + r)
    wt, bt, zt = _oihw(w), torch.from_numpy(b), _nchw(z)
    perm = tuple(int(v) for v in
                 np.random.default_rng(2).permutation(COUT * r * r))
    direct = F.conv2d(pixel_shuffle(zt, r), wt, bt, padding=(k - 1) // 2)
    hr = sub.phase_conv2d(zt, wt, bt, r, shuffle_out=True)
    _close(_nhwc(hr), _nhwc(direct))
    _close(_nhwc(hr), np.asarray(jsub.phase_conv2d(z, w, b, r,
                                                   shuffle_out=True)))
    y = sub.phase_conv2d(zt, wt, bt, r, out_perm=perm)
    _close(_nhwc(y), _nhwc(pixel_unshuffle(direct, r))[..., list(perm)])
    _close(_nhwc(y), np.asarray(jsub.phase_conv2d(z, w, b, r,
                                                  out_perm=perm)))


@pytest.mark.parametrize("k,r", KR)
def test_phase_conv2d_grouped_with_in_map(k, r):
    """The grouped form reads a permuted input (``in_map``: the canonical
    channel each actual one holds) and emits phase-major ``(py, px, c)``:
    against JAX's and against the direct conv of the canonical input."""
    _, z, w, b = _data(k, r, seed=30 * k + r)
    in_map = tuple(int(v) for v in
                   np.random.default_rng(3).permutation(CIN * r * r))
    zt = _nchw(z).contiguous(memory_format=CL)
    got = sub.phase_conv2d_grouped(zt, _oihw(w), torch.from_numpy(b), r,
                                   in_map=in_map)
    assert got.shape == (2, r * r * COUT, 6, 6)
    _close(_nhwc(got), np.asarray(jsub.phase_conv2d_grouped(
        z, w, b, r, in_map=in_map)))
    canon = torch.empty_like(_nchw(z))
    canon[:, list(in_map)] = _nchw(z)
    direct = F.conv2d(pixel_shuffle(canon, r), _oihw(w), torch.from_numpy(b),
                      padding=(k - 1) // 2)
    _close(_nhwc(sub.phase_major_shuffle(got, r)), _nhwc(direct))


@pytest.mark.parametrize("cout_hr,r_in,s", [(256, 2, 2), (64 * 9, 2, 3),
                                            (16, 4, 2), (12, 3, 2)])
def test_static_maps_equal_jax(cout_hr, r_in, s):
    assert sub.grouped_out_map(cout_hr, r_in, s) == \
        jsub.grouped_out_map(cout_hr, r_in, s)
    assert sub.merge_phase_perm(cout_hr, r_in, s) == \
        jsub.merge_phase_perm(cout_hr, r_in, s)
    assert isinstance(sub.grouped_out_map(cout_hr, r_in, s), tuple)


def test_grouped_out_map_folds_into_the_next_stage():
    """Two x2 stages in phase space: the first grouped stage's output,
    fed to the next conv through ``grouped_out_map``, equals the
    materialized two-stage tail (conv, shuffle, conv, shuffle)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((1, 4, 5, 5)).astype(np.float32))
    w1 = torch.from_numpy(rng.standard_normal((16, 4, 3, 3))
                          .astype(np.float32))
    w2 = torch.from_numpy(rng.standard_normal((3, 4, 9, 9))
                          .astype(np.float32))
    # both stages 4 -> 16 channels (4 at the next scale), with w1
    hr = F.conv2d(pixel_shuffle(F.conv2d(x, w1, padding=1), 2), w1,
                  padding=1)
    ref = F.conv2d(pixel_shuffle(hr, 2), w2, padding=4)
    z1 = F.conv2d(x, w1, padding=1)                        # phase 2, canon
    z2 = sub.phase_conv2d_grouped(z1, w1, None, 2)         # phase 4, grouped
    got = sub.phase_conv2d(z2, w2, None, 4, shuffle_out=True,
                           in_map=sub.grouped_out_map(16, 2, 2))
    _close(_nhwc(got), _nhwc(ref))


@pytest.mark.parametrize("form", ["subpixel", "phase", "grouped"])
def test_gradients_match_the_direct_conv(form):
    """Gradients reach the HR weight, the bias and the input through the
    gather, equal to the direct conv's (float32 sums in another order)."""
    rng = np.random.default_rng(5)
    k, r = 3, 2
    w0 = rng.standard_normal((COUT, CIN, k, k)).astype(np.float32)
    b0 = rng.standard_normal(COUT).astype(np.float32)
    z0 = rng.standard_normal((2, CIN * r * r, 5, 5)).astype(np.float32)
    g = torch.from_numpy(rng.standard_normal((2, COUT, 10, 10))
                         .astype(np.float32))

    def run(direct: bool):
        w, b, z = (torch.tensor(a, requires_grad=True) for a in (w0, b0, z0))
        if form == "subpixel":
            x = pixel_shuffle(z, r)
            y = (F.conv2d(x, w, b, padding=1) if direct
                 else sub.subpixel_conv2d(x, w, b, r))
        elif form == "phase":
            y = (F.conv2d(pixel_shuffle(z, r), w, b, padding=1) if direct
                 else sub.phase_conv2d(z, w, b, r, shuffle_out=True))
        else:
            y = (F.conv2d(pixel_shuffle(z, r), w, b, padding=1) if direct
                 else sub.phase_major_shuffle(
                     sub.phase_conv2d_grouped(z, w, b, r), r))
        (y * g).sum().backward()
        return [t.grad.numpy() for t in (w, b, z)]

    for got, want in zip(run(False), run(True)):
        _close(got, want)


def test_conv_window_takes_negative_paddings():
    """``_conv_window`` pads and crops to any per-side padding, negative
    ones included, as ``lax.conv_general_dilated`` does."""
    rng = np.random.default_rng(6)
    z = torch.from_numpy(rng.standard_normal((1, 2, 7, 8)).astype(np.float32))
    kp = torch.from_numpy(rng.standard_normal((3, 2, 2, 3))
                          .astype(np.float32))
    for pads in (((1, 0), (2, 0)), ((-1, 2), (0, -1)), ((0, 1), (1, 1))):
        (ty, by), (tx, bx) = pads
        got = sub._conv_window(z, kp, None, pads)
        want = F.conv2d(F.pad(z, (tx, bx, ty, by)), kp)
        assert torch.allclose(got, want, atol=1e-6)


def test_gather_backward_is_deterministic():
    """The weight gradient through the gather is bit-equal run to run at
    the nets' output-conv size (64 -> 3, k 9, r 4, channels-last): an
    accumulating ``index_put_`` sums in a varying order on the CPU."""
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.standard_normal((3, 64, 9, 9))
                         .astype(np.float32)).contiguous(memory_format=CL)
    z = torch.from_numpy(rng.standard_normal((2, 64 * 16, 6, 6))
                         .astype(np.float32))
    grads = []
    for _ in range(3):
        wt = w.clone().requires_grad_(True)
        sub.phase_conv2d(z, wt, None, 4, shuffle_out=True).square().sum() \
            .backward()
        grads.append(wt.grad)
    assert all(torch.equal(grads[0], g) for g in grads[1:])
    assert grads[0].stride() == w.stride()
