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


# Receptive-field radii at LR resolution by architecture (the JAX
# package's table): head conv9 (4) + two conv3 per residual block + mid
# conv3 + tail convs at LR scale, with margin; SRCNN's bicubic support and
# its three convs at HR come to at most 8 LR pixels.
RECEPTIVE_RADIUS = {"SRCNN": 8, "RESNET": 48, "AttentionSR": 80, "RRDB": 40}

# RRDBNet's effective halo (LR px). Its theoretical radius is 15 px per
# RRDB (3 dense blocks x 5 conv3), ~365 for the 23-block registry net, but
# both residual ladders scale by 0.2, so far-field contributions decay
# fast: the JAX package measured the half-uint8 crossing of a maximal
# center-pixel perturbation's response at r=14 at random init and r=7 for
# its trained checkpoints (tools/rrdb_erf.py). The bound is empirical:
# RRDB tiling is exact to the output's quantization, not to float.
RRDB_EFFECTIVE_RADIUS = 40


def receptive_radius(arch: str | None, model=None) -> int:
    """Receptive-field radius (LR pixels) the halo must cover for exact
    tiling. Depth-aware when ``model`` is given: a net with
    ``num_residuals`` blocks (ResNetSR, AttentionSR) needs ``2*n + 16``
    (48 and 80 at registry depth); RRDBNet (``growth``) needs
    ``min(15*num_blocks + 20, RRDB_EFFECTIVE_RADIUS)``, exact for shallow
    nets and the measured effective radius for deep ones. Otherwise the
    table by ``arch``; a model and name that are none of the four
    raise."""
    n_res = getattr(model, "num_residuals", None)
    if n_res is not None:
        return 2 * int(n_res) + 16
    if getattr(model, "growth", None) is not None:
        return min(15 * int(model.num_blocks) + 20, RRDB_EFFECTIVE_RADIUS)
    if arch not in RECEPTIVE_RADIUS:
        raise ValueError(f"receptive_radius: {arch!r} "
                         f"({type(model).__name__}) is none of "
                         f"{sorted(RECEPTIVE_RADIUS)}")
    return RECEPTIVE_RADIUS[arch]


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
