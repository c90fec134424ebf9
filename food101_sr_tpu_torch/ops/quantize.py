"""Dynamic int8 convolution for inference and its fake-quantized twin for
QAT (counterpart of ``food101_sr_tpu/ops/quantize.py``), on (N, C, H, W)
activations and OIHW weights.

- weights: symmetric per-output-channel int8 (a per-O scale factors out
  of the convolution exactly);
- activations: symmetric per-SAMPLE int8 with runtime scales, so requests
  co-batched by the server never change each other's grid;
- accumulation in int32, exact (|sum| <= 127*127*k*k*cin < 2^31 for every
  shape of the nets), dequantized as ``acc * (s_x * s_w[o])`` with the
  bias added in float32.

The quantizers compute what the JAX package's compute, bit for bit:
``absmax / 127`` and ``x / scale`` as true divisions (not products with
a reciprocal), round half to even, clip to +-127.

The int32 product is ``torch._int_mm`` (int8 x int8 -> int32) over
im2col patches, on the CPU and on CUDA alike, the features tap-major
(``(kh*K + kw)*C + c``, the order a channels-last input gives without a
transpose). PyTorch has no int8 convolution, so the JAX package's two
lowerings (a direct int8 conv and channel-major patches with a dot) are
this one computation here: integer sums are exact, so both give these
int32 accumulators.

``fake_quant_conv2d`` runs the same grids as quantize -> dequantize with a
straight-through estimator, in float32 with TF32 off in both passes, so
a fine-tune pulls the float weights onto the int8 grid; checkpoints stay
float either way.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .precision import full_fp32

_EPS = 1e-12


def _scale(absmax: torch.Tensor) -> torch.Tensor:
    """``max(absmax, eps) / 127`` by a true division on every device: on
    CUDA, PyTorch divides by a Python scalar as a product with its
    reciprocal, which can land one ulp away from JAX's quotient."""
    m = torch.clamp_min(absmax, _EPS)
    return m / torch.full_like(m, 127.0)


def quantize_per_tensor(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: (q, scale) with q*scale ~= x; the scale
    from the absmax in float32 (bf16 input is upcast first)."""
    xf = x.float()
    scale = _scale(xf.abs().amax())
    q = torch.clamp(torch.round(xf / scale), -127.0, 127.0).to(torch.int8)
    return q, scale


def quantize_per_sample(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-SAMPLE int8 of (N, ...) activations: scale (N, 1, 1,
    1), so a request's grid does not depend on its batch."""
    xf = x.float()
    scale = _scale(xf.abs().amax(dim=(1, 2, 3), keepdim=True))
    q = torch.clamp(torch.round(xf / scale), -127.0, 127.0).to(torch.int8)
    return q, scale


def quantize_kernel_per_cout(weight: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of an OIHW weight: (q OIHW int8,
    scales float32 (O,))."""
    wf = weight.float()
    scales = _scale(wf.abs().amax(dim=(1, 2, 3)))
    q = torch.clamp(torch.round(wf / scales[:, None, None, None]),
                    -127.0, 127.0).to(torch.int8)
    return q, scales


def _patches(xq: torch.Tensor, k: int, stride: int,
             pad: int) -> tuple[torch.Tensor, int, int]:
    """im2col of int8 NCHW ``xq``: ((N*Ho*Wo, C*k*k) patches, Ho, Wo),
    features ``(kh*k + kw)*C + c``."""
    n, c, h, w = xq.shape
    xp = F.pad(xq.permute(0, 2, 3, 1), (0, 0, pad, pad, pad, pad))
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    taps = [xp[:, i:i + (ho - 1) * stride + 1:stride,
               j:j + (wo - 1) * stride + 1:stride] for i in range(k)
            for j in range(k)]
    p = torch.stack(taps, dim=3)
    return p.reshape(n * ho * wo, c * k * k), ho, wo


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch._int_mm(a, b)`` (int8 (M, K) x (K, N) -> int32) for any
    sizes: CUDA's takes M > 16 and K, N multiples of 8, so zero rows and
    columns pad what falls short and are cut from the result (zeros add
    nothing to an integer sum)."""
    m, kk = a.shape
    n = b.shape[1]
    pm, pk, pn = max(17 - m, 0), -kk % 8, -n % 8
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = F.pad(b.t(), (0, pk, 0, pn)).t()
    out = torch._int_mm(a, b)
    return out[:m, :n] if pm or pn else out


def int8_accumulators(xq: torch.Tensor, wq: torch.Tensor,
                      stride: int = 1) -> torch.Tensor:
    """The int32 sums of the int8 conv of ``xq`` (N, C, H, W) with ``wq``
    (O, C, k, k), ``(k-1)//2`` padding, as (N, Ho, Wo, O)."""
    o, _, k, _ = wq.shape
    p, ho, wo = _patches(xq, k, stride, (k - 1) // 2)
    # (O, K) rows, K contiguous: the int8 GEMM's column-major B
    acc = _int_mm(p, wq.permute(0, 2, 3, 1).reshape(o, -1).t())
    return acc.view(xq.shape[0], ho, wo, o)


def int8_conv2d(x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor | None = None, *,
                stride: int = 1) -> torch.Tensor:
    """Dynamic-int8 conv2d with ``(k-1)//2`` padding: per-sample
    activations and per-cout weights to int8, the int32 GEMM, ``acc *
    (s_x * s_w)`` in float32, the bias added in float32, the input's dtype
    out (channels-last memory)."""
    xq, sx = quantize_per_sample(x)
    wq, sw = quantize_kernel_per_cout(weight)
    acc = int8_accumulators(xq, wq, stride)
    y = acc.float() * (sx.view(-1, 1, 1, 1) * sw)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# Quantization-aware training (fake-quant with straight-through estimator)
# ---------------------------------------------------------------------------

def _ste(x_f32: torch.Tensor, dequantized: torch.Tensor) -> torch.Tensor:
    """Forward ``dequantized``, gradient the identity: JAX's
    ``x + stop_gradient(dq - x)``, written the same way so that the
    forward rounds as JAX's does. The scale's gradient is dropped with
    the rest."""
    return x_f32 + (dequantized - x_f32).detach()


def fake_quant_act(x: torch.Tensor) -> torch.Tensor:
    """Per-sample symmetric int8 fake-quant of (N, C, H, W) activations."""
    xf = x.float()
    q, scale = quantize_per_sample(xf)
    return _ste(xf, q.float() * scale).to(x.dtype)


def fake_quant_kernel(weight: torch.Tensor) -> torch.Tensor:
    """Per-output-channel symmetric int8 fake-quant of an OIHW weight."""
    wf = weight.float()
    q, scales = quantize_kernel_per_cout(wf)
    return _ste(wf, q.float() * scales[:, None, None, None]).to(weight.dtype)


class _Fp32Conv(torch.autograd.Function):
    """F.conv2d without bias with TF32 off in the forward and in both
    backward convolutions (JAX's ``Precision.HIGHEST`` holds for the
    transposes too; ``full_fp32`` around the forward alone would leave
    the backward to TF32)."""

    @staticmethod
    def forward(ctx, x, w, stride: int, pad: int):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, pad)
        with full_fp32():
            return F.conv2d(x, w, None, stride, pad)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, pad = ctx.conf
        with full_fp32():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, [stride] * 2, [pad] * 2, [1, 1], False,
                [0, 0], 1, [ctx.needs_input_grad[0],
                            ctx.needs_input_grad[1], False])
        if gw is not None:  # in the weight's layout, as autograd's own
            gw = gw.contiguous(memory_format=torch.channels_last
                               if w.is_contiguous(
                                   memory_format=torch.channels_last)
                               and not w.is_contiguous()
                               else torch.contiguous_format)
        return gx, gw, None, None


def fake_quant_conv2d(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor | None = None, *,
                      stride: int = 1) -> torch.Tensor:
    """QAT twin of :func:`int8_conv2d`: a float32 conv (TF32 off) of the
    fake-quantized activations and weights, the bias added in float32,
    the input's dtype out. Forward as int8_conv2d up to the float sums'
    order; backward the STE."""
    k = weight.shape[2]
    xq = fake_quant_act(x).float()
    wq = fake_quant_kernel(weight).float()
    y = _Fp32Conv.apply(xq, wq, stride, (k - 1) // 2)
    if bias is not None:
        y = y + bias.float()[:, None, None]
    return y.to(x.dtype)
