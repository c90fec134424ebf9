"""PIL's ``convert("RGB")`` of a LAB image (PSD's Lab mode, CIELab TIFF).

PIL converts LAB through LittleCMS: ``ImageCms.buildTransform`` from
``createProfile("LAB")`` (lcms2's built-in V2 Lab profile, D50) to
``createProfile("sRGB")``, perceptual, 8 bits in and out. lcms2 reduces
that pipeline to a 33 x 33 x 33 table of 16-bit RGB sampled from
Lab -> XYZ (D50) -> the inverse of sRGB's colorant matrix (Bradford-adapted
to D50) -> sRGB's inverse tone curve, and evaluates an 8-bit pixel by
tetrahedral interpolation in 16 bits. Both steps are written out here with
lcms2's arithmetic (float32 between stages, its rounding to 16 bits, its
fixed-point interpolation), so the bytes are PIL's for every input.

PIL's LAB storage is L, a + 128, b + 128 a pixel (``ImagingUnpackLAB``
flips the sign bit of a TIFF's signed a and b; PSD stores them offset).
"""
from __future__ import annotations

import numpy as np

_GRID = 33
_D50 = (0.9642, 1.0, 0.8249)
_MAX_XYZ = 1 + 32767 / 32768  # lcms2's MAX_ENCODEABLE_XYZ
_clut = None


def _inv(a):
    """lcms2's _cmsMAT3inverse."""
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    return [[c0 / det, (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det,
             (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det],
            [c1 / det, (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det,
             (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det],
            [c2 / det, (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det,
             (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det]]


def _mul(a, b):
    return [[a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j]
             for j in range(3)] for i in range(3)]


def _apply(a, v):
    return [a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2]
            for i in range(3)]


def _xyz_to_srgb_matrix():
    """The inverse of cmsCreate_sRGBProfile's colorants (Rec. 709
    primaries, D65, Bradford to D50), scaled for lcms2's XYZ encoding."""
    xn, yn = 0.3127, 0.3290
    (xr, yr), (xg, yg), (xb, yb) = (0.64, 0.33), (0.30, 0.60), (0.15, 0.06)
    prim = [[xr, xg, xb], [yr, yg, yb],
            [1 - xr - yr, 1 - xg - yg, 1 - xb - yb]]
    c = _apply(_inv(prim), [xn / yn, 1.0, (1.0 - xn - yn) / yn])
    m = [[c[0] * xr, c[1] * xg, c[2] * xb], [c[0] * yr, c[1] * yg, c[2] * yb],
         [c[0] * (1.0 - xr - yr), c[1] * (1.0 - xg - yg),
          c[2] * (1.0 - xb - yb)]]
    brad = [[0.8951, 0.2664, -0.1614], [-0.7502, 1.7135, 0.0367],
            [0.0389, -0.0685, 1.0296]]
    src = _apply(brad, [xn / yn * 1.0, 1.0, (1 - xn - yn) / yn * 1.0])
    dst = _apply(brad, list(_D50))
    cone = [[dst[0] / src[0], 0, 0], [0, dst[1] / src[1], 0],
            [0, 0, dst[2] / src[2]]]
    m = _mul(_mul(_inv(brad), _mul(cone, brad)), m)
    return [[x * _MAX_XYZ for x in row] for row in _inv(m)]


def _to_word(d: np.ndarray) -> np.ndarray:
    """_cmsQuickSaturateWord: +0.5, then lcms2's floor (the value rounded
    to 1/65536 first), clipped to 0..65535."""
    d = d + 0.5
    fl = np.floor(np.round((d - 32767.0) * 65536.0) / 65536.0) + 32767
    return np.where(d <= 0, 0, np.where(d >= 65535.0, 65535, fl)).astype(
        np.int64)


def _table() -> np.ndarray:
    """The 33^3 x 3 table lcms2 samples (16-bit RGB at the grid's Lab)."""
    global _clut
    if _clut is not None:
        return _clut
    f32 = np.float32
    nodes = np.array([(i * 65535 + 16) // 32 for i in range(_GRID)])
    lab = np.stack(np.meshgrid(nodes, nodes, nodes, indexing="ij"),
                   -1).reshape(-1, 3)
    x = (lab.astype(f32) / f32(65535.0)).astype(np.float64)
    y = (x[:, 0] * 100.0 + 16.0) / 116.0
    t = [y + 0.002 * (x[:, 1] * 255.0 - 128.0), y,
         y - 0.005 * (x[:, 2] * 255.0 - 128.0)]
    xyz = [(np.where(v <= 24.0 / 116.0, (108.0 / 841.0) * (v - 16.0 / 116.0),
                     v * v * v) * w / _MAX_XYZ).astype(f32).astype(np.float64)
           for v, w in zip(t, _D50)]
    g, a, b, c, d = 2.4, 1 / 1.055, 0.055 / 1.055, 1 / 12.92, 0.04045
    disc = (a * d + b) ** g
    out = []
    for row in _xyz_to_srgb_matrix():
        lin = (0.0 + xyz[0] * row[0] + xyz[1] * row[1]
               + xyz[2] * row[2]).astype(f32).astype(np.float64)
        with np.errstate(invalid="ignore"):
            hi = (np.power(np.maximum(lin, 0), 1.0 / g) - b) / a
        v = np.where(lin >= disc, hi, lin / c).astype(f32)
        out.append(_to_word(v.astype(np.float64) * 65535.0))
    _clut = np.stack(out, 1).reshape(_GRID, _GRID, _GRID, 3)
    return _clut


def lab_to_rgb(img: np.ndarray) -> np.ndarray:
    """(h, w, >=3) uint8 in PIL's LAB storage -> (h, w, 3) uint8 RGB."""
    h, w = img.shape[:2]
    clut = _table()
    v = img[..., :3].reshape(-1, 3).astype(np.int64) * 257  # FROM_8_TO_16
    v = np.minimum(((v << 8) | v) >> 8, 0xFFFF)  # Lab V2 -> V4 encoding
    f = v * (_GRID - 1)
    f = f + (f + 0x7FFF) // 0xFFFF  # _cmsToFixedDomain
    idx, r = f >> 16, f & 0xFFFF
    step = (v != 0xFFFF).astype(np.int64)
    order = np.argsort(-r, axis=1, kind="stable")
    rows = np.arange(len(v))
    prev = clut[idx[:, 0], idx[:, 1], idx[:, 2]]
    base, rest = prev, np.zeros_like(prev)
    for k in range(3):  # the tetrahedron's edges, largest fraction first
        ax = order[:, k]
        idx[rows, ax] += step[rows, ax]
        cur = clut[idx[:, 0], idx[:, 1], idx[:, 2]]
        rest = rest + (cur - prev) * r[rows, ax][:, None]
        prev = cur
    rest = rest + 0x8001
    out16 = base + ((rest + (rest >> 16)) >> 16)
    out8 = (out16 * 65281 + 8388608) >> 24  # FROM_16_TO_8
    return out8.astype(np.uint8).reshape(h, w, 3)
