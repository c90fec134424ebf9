"""Halo-exchange spatially sharded inference: one large image split in
rows across the mesh's devices, edge strips exchanged between neighbours
(counterpart of ``food101_sr_tpu/parallel/spatial_mesh.py``).

Overlap tiling (``spatial.py``) recomputes the halo around every tile; for
one image much larger than a device's working set that is most of the
work at AttentionSR's halo of 80. Here device i owns the slab of rows
``[i*S, (i+1)*S)`` (S = H/D), receives its neighbours' adjacent
``2*halo`` rows (``.to(device)``, the counterpart of JAX's ``ppermute``:
clamped border windows reach up to ``2*halo`` rows into their one
neighbour; a missing neighbour sends zeros, which the window then leaves
out), runs the model on its window of ``S + 2*halo`` rows starting at
``clamp(i*S - halo, 0, H - S - 2*halo)``, and keeps its own rows of the
output. Every window has the same shape, and the result equals the
whole-image forward for ``halo`` at least the receptive radius, by the
argument of overlap tiling.

Images are (B, C, H, W), the port's models' layout.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .mesh import Mesh, per_device, replicate
from .spatial import receptive_radius


def row_sharding(images: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """``images`` split in rows over ``mesh.devices``: device i's slab of
    H/D rows, on device i. H must divide by the device count."""
    n = len(mesh.devices)
    h = images.shape[2]
    if h % n:
        raise ValueError(f"H={h} must divide by mesh size {n}")
    return [s.to(d) for s, d in zip(images.split(h // n, dim=2),
                                    mesh.devices)]


def halo_sharded_apply(forward: Callable, images: torch.Tensor, scale: int,
                       halo: int, mesh: Mesh) -> torch.Tensor:
    """Spatially sharded SR forward with neighbour halo exchange.

    ``forward``: an LR->HR forward taking any row count, one callable or
    one per device (device i's runs its window). ``images``: (B, C, H, W)
    with H divisible by the device count D and H/D >= 2*halo, so one
    neighbour's slab covers a border window's reach. Returns (B, C,
    H*scale, W*scale) on ``images``' device."""
    n_dev = len(mesh.devices)
    h_img = images.shape[2]
    if h_img % n_dev:
        raise ValueError(f"H={h_img} must divide by mesh size {n_dev}")
    slab = h_img // n_dev
    fwds = per_device(forward, mesh)
    if n_dev == 1:
        return fwds[0](images.to(mesh.devices[0])).to(images.device)
    if slab < 2 * halo:
        raise ValueError(
            f"slab H/D={slab} < 2*halo={2 * halo}: border windows would "
            f"need rows beyond the adjacent neighbor; use fewer devices, "
            f"a taller image, or the overlap-tiling path (tiled_apply)")
    win = slab + 2 * halo
    xs = row_sharding(images, mesh)
    outs = []
    for i, (x, dev, fwd) in enumerate(zip(xs, mesh.devices, fwds)):
        # rows [i*slab - 2h, (i+1)*slab + 2h), zeros outside the image
        edge = x.new_zeros((*x.shape[:2], 2 * halo, x.shape[3]))
        prev_tail = xs[i - 1][:, :, -2 * halo:].to(dev) if i else edge
        next_head = (xs[i + 1][:, :, :2 * halo].to(dev)
                     if i < n_dev - 1 else edge)
        asm = torch.cat([prev_tail, x, next_head], dim=2)
        ws = min(max(i * slab - halo, 0), h_img - win)  # window start
        off = ws - (i * slab - 2 * halo)
        y = fwd(asm[:, :, off:off + win])
        keep = (i * slab - ws) * scale
        outs.append(y[:, :, keep:keep + slab * scale].to(images.device))
    return torch.cat(outs, dim=2)


def halo_sharded_forward_for(model, arch: str | None, scale: int,
                             mesh: Mesh,
                             halo: Optional[int] = None) -> Callable:
    """Large-image SR for a model, rows sharded over ``mesh`` with halo
    exchange: one replica per device (``mesh.replicate``), eval mode, no
    gradients. Returns a function (B, C, H, W) -> (B, C, H*s, W*s)."""
    halo = receptive_radius(arch, model) if halo is None else halo
    fwds = replicate(model.eval(), mesh)

    @torch.no_grad()
    def run(images: torch.Tensor) -> torch.Tensor:
        return halo_sharded_apply(fwds, images, scale, halo, mesh)

    return run
