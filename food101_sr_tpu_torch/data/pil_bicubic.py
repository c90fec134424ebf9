"""Pillow's 8-bit bicubic resize, byte for byte, in numpy.

The JAX package's loader resizes a small image with
``Image.resize((w, h), Image.BICUBIC)``; the port has no PIL, so this
module repeats what Pillow's ``libImaging/Resample.c`` computes for 8-bit
images:

* the filter is Keys' cubic with ``a = -0.5`` and support 2, stretched by
  ``max(in / out, 1)``;
* for output pixel ``i`` the centre is ``(i + 0.5) * in / out``; the taps
  run from ``int(centre - support + 0.5)`` to ``int(centre + support +
  0.5)``, clamped to the image, and tap ``x`` weighs
  ``filter((x - centre + 0.5) / filterscale)``;
* the weights are normalised in double, then rounded half away from zero
  to fixed point with 22 fraction bits;
* each pass sums ``uint8 * weight`` onto ``1 << 21`` in integers, shifts
  by 22 and clips to 0..255; the horizontal pass runs first and its uint8
  result feeds the vertical pass; a pass whose size does not change is
  skipped.

A float bicubic lands one level off on many pixels; the loader's batches
are held byte-equal to the JAX package's, so this module is too
(``tests/test_torch_data.py`` against Pillow).
"""
from __future__ import annotations

import functools

import numpy as np

PRECISION_BITS = 22  # Resample.c: 32 - 8 - 2
_SUPPORT = 2.0       # bicubic


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
                    np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a,
                             0.0))


@functools.lru_cache(maxsize=64)
def _coeffs(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """(index, weight) arrays of shape (ksize, out_size): for tap ``t`` of
    output ``i``, the source index (a tap past the filter's end points at
    the first tap, with weight 0) and the fixed point weight, as
    ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` make them."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _SUPPORT * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    idx = np.zeros((ksize, out_size), np.intp)
    fixed = np.zeros((ksize, out_size), np.int64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = _bicubic((np.arange(xmax) + xmin - center + 0.5) / filterscale)
        ww = w.sum()
        if ww != 0.0:
            w = w / ww
        scaled = w * (1 << PRECISION_BITS)
        fixed[:xmax, i] = np.trunc(np.where(w < 0, scaled - 0.5, scaled + 0.5))
        idx[:, i] = xmin
        idx[:xmax, i] += np.arange(xmax)
    idx.setflags(write=False)
    fixed.setflags(write=False)
    return idx, fixed


def _pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit resampling pass of ``img`` (H, W, C) along ``axis``: per
    tap, gather the source rows and add ``uint8 * weight`` in int64 (no
    BLAS call: a threaded BLAS spends far longer waking its threads than
    on a product this small)."""
    x = np.moveaxis(img, axis, 0)
    rest = x.shape[1:]
    x = x.reshape(x.shape[0], -1)
    idx, fixed = _coeffs(x.shape[0], out_size)
    acc = np.full((out_size, x.shape[1]), 1 << (PRECISION_BITS - 1), np.int64)
    for t in range(idx.shape[0]):
        acc += x[idx[t]] * fixed[t][:, None]
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out.reshape(out_size, *rest), 0, axis)


def resize_bicubic_u8(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``img`` (H, W, C) uint8 resized to ``size = (width, height)`` (PIL's
    order), as ``Image.fromarray(img).resize(size, Image.BICUBIC)``."""
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"resize_bicubic_u8 takes uint8 (H, W, C), got "
                         f"{img.dtype} {img.shape}")
    out_w, out_h = size
    out = img
    if out_w != img.shape[1]:
        out = _pass(out, out_w, axis=1)
    if out_h != img.shape[0]:
        out = _pass(out, out_h, axis=0)
    return np.ascontiguousarray(out)
