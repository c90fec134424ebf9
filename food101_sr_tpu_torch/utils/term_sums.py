"""Per-parameter scales for comparing two computations of a gradient:
the largest sum of absolute terms behind one entry of each parameter's
gradient, recorded from a forward and backward pass (``term_sums``). A
float32 (or bf16) sum's rounding error is bounded relative to that sum,
not to the gradient's own size, which cancellation can make far smaller.
The gradient checks of the tests and of ``chip_smoke.py`` scale their
differences by it."""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from ..models import RRDBNet, SNConv2d, SNLinear
from ..ops.pixel_shuffle import pixel_shuffle
from ..ops.quantize import fake_quant_act
from ..ops.subpixel_conv import phase_major_shuffle

# The bounds of a bf16 step's raw gradients against the float32 step's, per
# leaf over its term sum, shared by ``chip_smoke.py`` (the card, registry
# sizes) and ``tests/test_torch_bf16.py``, which calibrates them on the CPU
# from the bf16-vs-float32 distances of the JAX package's narrow nets and
# of the port's, twice over, rounded up to a power of two. BF16_GRAD_TOL,
# float rounding alone: per leaf the smaller of the two packages' distances
# (they differ most at the leaves JAX sums in bf16: SRCNN's conv biases,
# 0.53), at worst 0.050 (ResNetSR; the GAN steps 0.038 D, 0.039 G). It
# holds the supervised steps, and the bf16 GAN steps with the float32
# steps' activation branches applied. BF16_GAN_TOL holds the GAN steps as
# they run, calibrated by the larger of the two distances, 0.066 (JAX's G
# step at an SE block's first weight): an activation input near 0 takes
# the other branch in bf16, and where its layer is small (an SE block's 6
# hidden units, D's 100) one such element moves a leaf by a fair share of
# its term sum at 2 crops.
BF16_GRAD_TOL, BF16_GAN_TOL = 2.0 ** -3, 2.0 ** -2


@contextlib.contextmanager
def term_sums(model, sums: dict):
    """Within the block, record each conv, linear, PReLU, spectral-norm or
    BatchNorm layer of ``model``'s inputs and output gradients (every call,
    by forward and output-gradient hooks, on the CPU); on exit fill
    ``sums``, per parameter, with the largest sum of absolute terms behind
    one entry of its gradient: the weight-gradient products of |input| and
    |output gradient| (over every call of the layer), the shared PReLU
    slope's g*x over the negative inputs, a BatchNorm scale's g*x_hat. A
    spectral-norm kernel W enters its layer as W/sigma, so its terms are
    those products over sigma plus their sum weighted by |W| over sigma
    squared (sigma's gradient; the power iteration's own derivative is
    left out). A float32 sum's rounding error is bounded relative to that
    sum, not to the gradient's own size, which cancellation can make
    hundreds of times smaller (a PReLU slope sums g*x over every negative
    activation of its layer).

    RRDB's split dense layout convolves with wide kernels assembled from
    the dense convs' weights, past the conv modules the hooks watch; the
    terms of each weight's gradient are the same products in either
    layout, so within the block every ``RRDBNet`` of ``model`` runs the
    concat layout."""
    seen: dict = {}
    dense = [m for m in model.modules() if isinstance(m, RRDBNet)]
    layouts = [m.dense_layout for m in dense]

    def keep(mod, inp, out, name):
        pair = [inp[0].detach()]
        seen.setdefault(name, []).append(pair)
        if out.requires_grad:
            out.register_hook(lambda g: pair.append(g.detach()))

    kinds = (nn.Conv2d, nn.Linear, nn.PReLU, SNConv2d, SNLinear,
             nn.BatchNorm2d)
    layers = {n: m for n, m in model.named_modules() if isinstance(m, kinds)}
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, n=n: keep(mod, inp, out, n))
        for n, m in layers.items()]
    for m in dense:
        m.dense_layout = "concat"
    try:
        yield sums
    finally:
        for h in hooks:
            h.remove()
        for m, layout in zip(dense, layouts):
            m.dense_layout = layout
    for n, m in layers.items():
        pairs = [(x.abs(), g.abs(), x) for x, g in
                 (weight_terms(m, *p) for p in seen.get(n, [])
                  if len(p) == 2)]
        if not pairs:
            continue
        if isinstance(m, (nn.Conv2d, SNConv2d)):
            w = m.weight_orig if isinstance(m, SNConv2d) else m.weight
            t = sum(torch.nn.grad.conv2d_weight(ax, w.shape, ag, m.stride,
                                                m.padding)
                    for ax, ag, _ in pairs)
            bias = sum(ag.sum((0, 2, 3)) for _, ag, _ in pairs)
        elif isinstance(m, (nn.Linear, SNLinear)):
            w = m.weight_orig if isinstance(m, SNLinear) else m.weight
            t = sum(ag.T @ ax for ax, ag, _ in pairs)
            bias = sum(ag.sum(0) for _, ag, _ in pairs)
        elif isinstance(m, nn.BatchNorm2d):
            def x_hat(x):
                mean = x.mean((0, 2, 3), keepdim=True)
                var = x.var((0, 2, 3), unbiased=False, keepdim=True)
                return ((x - mean) / torch.sqrt(var + m.eps)).abs()
            sums[f"{n}.weight"] = sum((ag * x_hat(x)).sum((0, 2, 3))
                                      for _, ag, x in pairs).max().item()
            sums[f"{n}.bias"] = sum(ag.sum((0, 2, 3))
                                    for _, ag, _ in pairs).max().item()
            continue
        else:  # one shared slope: g * x over the negative inputs
            sums[f"{n}.weight"] = sum((ag * ax * (x < 0)).sum().item()
                                      for ax, ag, x in pairs)
            continue
        if isinstance(m, (SNConv2d, SNLinear)):
            with torch.no_grad():
                wm = w.flatten(1)
                sigma = torch.dot(m.weight_v, wm.t() @ m.weight_u).abs()
                t = t / sigma
                t = t.max() + (t * w.abs()).sum() / sigma
            sums[f"{n}.weight_orig"] = t.item()
        else:
            sums[f"{n}.weight"] = t.max().item()
        if m.bias is not None:
            sums[f"{n}.bias"] = bias.max().item()


def weight_terms(m, x: torch.Tensor, g: torch.Tensor):
    """A layer's input and output gradient where its weight gradient is a
    plain conv's of them: a QAT conv's fake-quantized input (the conv's
    true operand; the STE passes the gradient through); for a phase-space
    conv of the upsample tail (``phase_in > 1``) the HR conv's, the input
    put back in canonical pixel-shuffle order (``phase_in_map``) and
    shuffled, a grouped output's gradient shuffled phase-major (a tail's
    last conv already emits HR); any other layer's as they are."""
    if getattr(m, "quantize", "") == "qat":
        return fake_quant_act(x), g
    r = getattr(m, "phase_in", 0)
    if r <= 1:
        return x, g
    if m.phase_in_map is not None:
        canon = torch.empty_like(x)
        canon[:, list(m.phase_in_map)] = x
        x = canon
    return (pixel_shuffle(x, r),
            g if m.subpixel_r > 1 else phase_major_shuffle(g, r))
