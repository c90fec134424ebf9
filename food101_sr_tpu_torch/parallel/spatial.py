"""Spatial tiling for whole-image SR inference (counterpart of
``food101_sr_tpu/parallel/spatial.py``).

A large image is cut into windows of ``tile + 2*halo`` whose starts clamp
at the borders; each window's owned interior is cropped from the model
output and stitched back. With ``halo`` at least the model's receptive-field
radius this equals the whole-image forward: interior pixels see only real
pixels of the window, and clamped border windows put the model's zero
padding where the whole-image forward has it. The windows become a plain
batch, which a mesh shards over its devices, as JAX's data sharding does.

Images are the port's models' layout, (B, C, H, W): rows on dim 2.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from .mesh import Mesh, replicate, sharded_batch


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


MAX_WINDOWS = 8  # tiled_apply's windows per forward call


def tiled_apply(forward: Callable, images: torch.Tensor, scale: int,
                tile: int, halo: int, mesh: Optional[Mesh] = None,
                max_windows: Optional[int] = MAX_WINDOWS) -> torch.Tensor:
    """Run ``forward`` (an LR->HR model forward, (N, C, h, w) -> (N, C,
    h*scale, w*scale)) over overlapping windows of ``images`` (B, C, H, W),
    H and W multiples of ``tile``, and stitch the owned interiors.

    ``mesh``: the window batch is sharded over its devices
    (``mesh.sharded_batch``; ``forward`` may then be one callable per
    device), in one call. Otherwise ``max_windows`` caps the windows per
    call: fixed-size chunks, the last one padded with zero windows, so the
    forward sees one shape (cuDNN picks per shape) and bounded activation
    memory; None runs every window in one call."""
    b, c, h, w = images.shape
    if h % tile or w % tile:
        raise ValueError(f"H={h}, W={w} must be multiples of tile={tile}")
    starts_h, starts_w, win_h, win_w = plan_windows(h, w, tile, halo)
    nh, nw = len(starts_h), len(starts_w)
    # (B, nh, nw, C, win_h, win_w) -> a flat window batch, window-major
    wins = torch.stack([torch.stack([images[:, :, sh:sh + win_h,
                                            sw:sw + win_w]
                                     for sw in starts_w], 1)
                        for sh in starts_h], 1)
    flat = wins.reshape(b * nh * nw, c, win_h, win_w)
    n_win = flat.shape[0]
    if mesh is not None:
        out = sharded_batch(forward, flat, mesh)
    elif max_windows is None or n_win <= max_windows:
        out = forward(flat)
    else:
        chunks = []
        for s in range(0, n_win, max_windows):
            part = flat[s:s + max_windows]
            valid = part.shape[0]
            if valid < max_windows:
                part = torch.cat([part, part.new_zeros(
                    (max_windows - valid, *part.shape[1:]))])
            chunks.append(forward(part)[:valid])
        out = torch.cat(chunks)
    out = out.reshape(b, nh, nw, c, win_h * scale, win_w * scale)
    ts = tile * scale
    rows = []
    for i, sh in enumerate(starts_h):
        off_h = (i * tile - sh) * scale
        rows.append(torch.cat([
            out[:, i, j, :, off_h:off_h + ts,
                (j * tile - sw) * scale:(j * tile - sw) * scale + ts]
            for j, sw in enumerate(starts_w)], dim=3))
    return torch.cat(rows, dim=2)


def tiled_forward_for(model, arch: str | None, scale: int, tile: int = 128,
                      halo: Optional[int] = None,
                      mesh: Optional[Mesh] = None) -> Callable:
    """Whole-image SR through tiling for a model: a function (B, C, H, W)
    -> (B, C, H*scale, W*scale), the model in eval mode without gradients.
    ``halo`` defaults to the model's receptive radius; with ``mesh``, one
    replica of the model per device (``mesh.replicate``) takes its share
    of the windows."""
    halo = receptive_radius(arch, model) if halo is None else halo
    fwds = replicate(model.eval(), mesh) if mesh is not None else model.eval()

    @torch.no_grad()
    def run(images: torch.Tensor) -> torch.Tensor:
        return tiled_apply(fwds, images, scale, tile, halo, mesh=mesh)

    return run
