"""The port's int8 and QAT numerics (food101_sr_tpu_torch.ops.quantize)
against the JAX package's ``ops/quantize.py`` on the CPU: the quantizers'
int8 values and scales bit-equal, the int32 accumulators of both
lowerings bit-equal to JAX's (and to each other), batch independence,
the fake-quant forwards bit-equal with the straight-through gradient the
identity, one QAT train step's raw gradients per leaf, and JAX's
refusals."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401
import torch.nn.functional as F

from food101_sr_tpu.losses import get_loss_function as jax_get_loss_function
from food101_sr_tpu.models.attention_sr import AttentionSR as JaxAttentionSR
from food101_sr_tpu.ops import quantize as jq
from food101_sr_tpu.training.steps import make_grad_step as jax_grad_step
from food101_sr_tpu_torch.convert import params_from_jax
from food101_sr_tpu_torch.losses import get_loss_function
from food101_sr_tpu_torch.models import (AttentionSR, build_model, get_model,
                                         model_for_params)
from food101_sr_tpu_torch.ops import quantize as q
from food101_sr_tpu_torch.training import loss_and_grads, train

CL = torch.channels_last


def _act(shape, seed, spread=3.0):
    """NHWC float32 activations with per-sample ranges that differ (the
    per-sample scales must not mix) and values on the rounding ties of
    their grid (``x / scale`` = k + 0.5) so that half-to-even is held."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x *= np.float32(spread) ** np.arange(shape[0], dtype=np.float32)[
        :, None, None, None]
    for b in range(shape[0]):
        scale = np.float32(np.abs(x[b]).max()) / np.float32(127.0)
        n = min(4, shape[-1])
        x[b, 0, 0, :n] = (np.arange(n, dtype=np.float32) + 0.5) * scale
    return x


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _hwio(w: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(w.numpy().transpose(2, 3, 1, 0))


def test_quantizers_bit_equal_jax():
    x = _act((3, 5, 6, 8), seed=0)
    qj, sj = jq.quantize_per_sample(jnp.asarray(x))
    qp, sp = q.quantize_per_sample(_nchw(x).contiguous(memory_format=CL))
    assert np.array_equal(qp.permute(0, 2, 3, 1).numpy(), np.asarray(qj))
    assert np.array_equal(sp.numpy().reshape(-1), np.asarray(sj).reshape(-1))
    assert qp.dtype == torch.int8 and sp.dtype == torch.float32
    # the ties round half to even, as jnp.round does
    assert set(np.abs(qp.numpy()[:, :4, 0, 0]).reshape(-1)) <= {0, 2, 4}

    qj, sj = jq.quantize_per_tensor(jnp.asarray(x))
    qp, sp = q.quantize_per_tensor(_nchw(x))
    assert np.array_equal(qp.permute(0, 2, 3, 1).numpy(), np.asarray(qj))
    assert sp.item() == float(sj)

    w = torch.from_numpy(_act((6, 5, 3, 3), seed=1, spread=1.5))  # OIHW
    qj, sj = jq.quantize_kernel_per_cout(jnp.asarray(_hwio(w)))
    qp, sp = q.quantize_kernel_per_cout(w)
    assert np.array_equal(_hwio(qp), np.asarray(qj))
    assert np.array_equal(sp.numpy(), np.asarray(sj))
    # bf16 input is upcast before the absmax, as in JAX
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    qj, sj = jq.quantize_per_sample(xb)
    qp, sp = q.quantize_per_sample(_nchw(x).to(torch.bfloat16))
    assert np.array_equal(qp.permute(0, 2, 3, 1).numpy(), np.asarray(qj))
    assert np.array_equal(sp.numpy().reshape(-1), np.asarray(sj).reshape(-1))
    # an all-zero sample takes the epsilon scale and quantizes to 0
    z = q.quantize_per_sample(torch.zeros(2, 3, 4, 4))
    assert not z[0].any() and np.allclose(z[1].numpy(), 1e-12 / 127.0)


@pytest.mark.parametrize("cin,cout,k,stride", [(16, 16, 3, 1), (24, 8, 3, 1),
                                               (5, 7, 3, 2), (3, 9, 5, 1)])
def test_int8_accumulators_bit_equal_jax(cin, cout, k, stride):
    """The int32 sums equal JAX's direct and im2col ones (the port runs
    both modes through one GEMM), also at sizes the CUDA GEMM pads (cin
    5, cout 7 and 9, fewer than 17 rows); int8_conv2d then equals both
    JAX lowerings' output within float32 rounding of the
    dequantization."""
    x = _act((2, 3, 4, cin), seed=cin + k)
    w = torch.from_numpy(np.random.default_rng(cout).standard_normal(
        (cout, cin, k, k)).astype(np.float32))
    b = torch.from_numpy(np.random.default_rng(9).standard_normal(cout)
                         .astype(np.float32))
    xq, _ = q.quantize_per_sample(_nchw(x))
    wq, _ = q.quantize_kernel_per_cout(w)
    p = (k - 1) // 2
    xqj, wqj = jnp.asarray(xq.permute(0, 2, 3, 1).numpy()), \
        jnp.asarray(_hwio(wq))
    pad, s = ((p, p), (p, p)), (stride, stride)
    want = np.asarray(jq._int8_conv_direct(xqj, wqj, s, pad))
    assert np.array_equal(want, np.asarray(jq._int8_conv_im2col(xqj, wqj,
                                                                s, pad)))
    got = q.int8_accumulators(xq, wq, stride)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    y = q.int8_conv2d(_nchw(x).contiguous(memory_format=CL), w, b,
                      stride=stride)
    assert y.is_contiguous(memory_format=CL)
    for via in ("conv", "dot"):
        yj = np.asarray(jq.int8_conv2d(jnp.asarray(x), jnp.asarray(_hwio(w)),
                                       jnp.asarray(b.numpy()),
                                       strides=stride, via=via))
        np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), yj,
                                   rtol=1e-6, atol=1e-6, err_msg=via)


def test_int8_conv_is_batch_independent():
    """Per-sample scales: a row's output is bit-equal alone and inside a
    batch with a neighbour of a far larger range."""
    x = _nchw(_act((3, 8, 8, 16), seed=4, spread=50.0))
    w = torch.randn(16, 16, 3, 3, generator=torch.Generator().manual_seed(0))
    batch = q.int8_conv2d(x, w, stride=1)
    for i in range(3):
        alone = q.int8_conv2d(x[i:i + 1], w, stride=1)
        assert torch.equal(batch[i:i + 1], alone)


def test_fake_quant_forward_bit_equal_and_ste_gradient():
    x = _act((2, 4, 5, 6), seed=5)
    w = torch.from_numpy(_act((6, 6, 3, 3), seed=6, spread=1.2))
    got = q.fake_quant_act(_nchw(x))
    assert np.array_equal(got.permute(0, 2, 3, 1).numpy(),
                          np.asarray(jq.fake_quant_act(jnp.asarray(x))))
    gk = q.fake_quant_kernel(w)
    assert np.array_equal(_hwio(gk),
                          np.asarray(jq.fake_quant_kernel(
                              jnp.asarray(_hwio(w)))))
    # the straight-through estimator: the gradient is the identity
    xt = _nchw(x).clone().requires_grad_(True)
    wt = w.clone().requires_grad_(True)
    g1, g2 = torch.randn_like(xt), torch.randn_like(wt)
    ((q.fake_quant_act(xt) * g1).sum()
     + (q.fake_quant_kernel(wt) * g2).sum()).backward()
    assert torch.equal(xt.grad, g1) and torch.equal(wt.grad, g2)
    # the QAT conv: JAX's forward within float32 sums, the STE backward
    # equal to the float conv's of the fake-quantized tensors
    b = torch.randn(6, generator=torch.Generator().manual_seed(1))
    xt.grad = wt.grad = None
    y = q.fake_quant_conv2d(xt, wt, b)
    yj = np.asarray(jq.fake_quant_conv2d(jnp.asarray(x),
                                         jnp.asarray(_hwio(w)),
                                         jnp.asarray(b.numpy())))
    peak = np.abs(yj).max()
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy() / peak,
                               yj / peak, rtol=0, atol=1e-6)
    g = torch.randn_like(y)
    (y * g).sum().backward()
    xd = q.fake_quant_act(_nchw(x)).requires_grad_(True)
    wd = q.fake_quant_kernel(w).requires_grad_(True)
    (F.conv2d(xd, wd, b, padding=1) * g).sum().backward()
    assert torch.allclose(xt.grad, xd.grad, atol=1e-5)
    assert torch.allclose(wt.grad, wd.grad, atol=1e-4)


def test_qat_step_gradients_match_jax():
    """One QAT train step's raw gradients (uint8 crops, bicubic
    degradation, NLPD) on shared weights, AttentionSR 2 x 16 with the
    phase tail (train()'s defaults), per leaf within 1e-4 of the leaf's
    max abs: float32 sums in another order before each activation's
    fake-quant rounding."""
    net = JaxAttentionSR(scale_factor=4, num_channels=16, num_residuals=2,
                         quantize="qat", phase_tail=True)
    params = net.init(jax.random.PRNGKey(2), jnp.zeros((1, 8, 8, 3)))["params"]
    hr = np.random.default_rng(7).integers(0, 256, (2, 32, 32, 3), np.uint8)
    jloss, jgrads, _ = jax.jit(jax_grad_step(
        net, jax_get_loss_function("nlpd"), 4))(params, {}, jnp.asarray(hr))
    want = params_from_jax(jgrads)

    model = build_model(lambda: AttentionSR(4, 16, 2, quantize="qat",
                                            phase_tail=True), device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    loss, grads = loss_and_grads(model, get_loss_function("nlpd"), 4,
                                 torch.from_numpy(hr))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        w = want[name].numpy()
        scale = np.abs(w).max() + 1e-12
        np.testing.assert_allclose(g.numpy() / scale, w / scale, rtol=0,
                                   atol=1e-4, err_msg=name)


def test_refusals_match_jax(tmp_path):
    """SRCNN has no body stack, an unknown mode is refused, and train()
    refuses the inference-only modes (round/clip has no gradient)."""
    with pytest.raises(ValueError, match="no quantizable body"):
        get_model("SRCNN", device="cpu", quantize="int8")
    srcnn = get_model("SRCNN", device="cpu").state_dict()
    with pytest.raises(ValueError, match="no quantizable body"):
        model_for_params(srcnn, device="cpu", quantize="qat")
    with pytest.raises(ValueError, match="Unknown quantize mode"):
        get_model("RESNET", device="cpu", quantize="fp8")
    for mode in ("int8", "int8_dot"):
        with pytest.raises(ValueError, match="inference-only"):
            train({"dataset": "synthetic", "architecture": "SRCNN",
                   "synthetic_size": 32, "crop_size": 32, "batch_size": 4,
                   "quantize": mode, "use_wandb": False,
                   "weights_dir": str(tmp_path)}, device="cpu")
