"""Window geometry for tiled whole-image SR inference (counterpart of the
framework-free part of ``food101_sr_tpu/parallel/spatial.py``).

A large image is cut into windows of ``tile + 2*halo`` whose starts clamp
at the borders; each window's owned interior is cropped from the model
output and stitched back. With ``halo`` at least the model's receptive-field
radius this equals the whole-image forward: interior pixels see only real
pixels of the window, and clamped border windows put the model's zero
padding where the whole-image forward has it.
"""
from __future__ import annotations

import math


def receptive_radius(model) -> int:
    """Receptive-field radius (LR pixels) the halo must cover, for a net
    with ``num_residuals`` blocks: head conv9 (4) + two conv3 per block +
    mid conv3 + tail convs at LR scale + margin = ``2*n + 16`` (80 for the
    32-block registry AttentionSR)."""
    n_res = getattr(model, "num_residuals", None)
    if n_res is None:
        raise ValueError(f"receptive_radius: {type(model).__name__} has no "
                         "num_residuals (only AttentionSR is ported)")
    return 2 * int(n_res) + 16


def window_starts(size: int, tile: int, halo: int):
    """Clamped start offsets of ``tile + 2*halo`` windows covering ``size``."""
    n = math.ceil(size / tile)
    win = tile + 2 * halo
    return [min(max(i * tile - halo, 0), size - win) for i in range(n)], n, win


def plan_windows(h: int, w: int, tile: int, halo: int):
    """Clamp the halo to what the image allows, then compute per-axis window
    starts. Returns (starts_h, starts_w, win_h, win_w); the owned interior
    of tile (i, j) begins at ``(i*tile - starts_h[i], j*tile - starts_w[j])``
    inside its window."""
    win_h = min(tile + 2 * halo, h)
    win_w = min(tile + 2 * halo, w)
    halo_h = (win_h - tile) // 2
    halo_w = (win_w - tile) // 2
    starts_h, _, win_h = window_starts(h, tile, halo_h)
    starts_w, _, win_w = window_starts(w, tile, halo_w)
    return starts_h, starts_w, win_h, win_w
