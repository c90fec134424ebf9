"""Devices and data placement (counterpart of
``food101_sr_tpu/parallel/mesh.py``).

JAX's mesh spans processes and their local devices, and one program runs
over it. Here a :class:`Mesh` is this process's devices; the rank and
world size are the process group's (``distributed``). A training rank's
mesh is its one card, while serving and the spatial paths run in one
process over its local devices (``make_mesh()``: every visible card). ``cpu_mesh(n)`` is
the explicit CPU mesh of the tests, the counterpart of JAX's virtual CPU
devices.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Sequence

import torch
from torch import nn

from . import distributed


@dataclass(frozen=True)
class Mesh:
    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        """The data axis's extent: its devices in all processes."""
        return len(self.devices) * distributed.world_size()


def make_mesh(devices: Sequence | None = None) -> Mesh:
    """This process's ``devices`` (default: every visible CUDA device;
    raises without one)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device (pass devices, "
                               "or cpu_mesh(n) for the CPU)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    # an unindexed "cuda" is the current card, as a tensor's device names it
    devices = tuple(torch.device("cuda", torch.cuda.current_device())
                    if torch.device(d) == torch.device("cuda")
                    else torch.device(d) for d in devices)
    if not devices:
        raise ValueError("make_mesh: no devices")
    return Mesh(devices)


def cpu_mesh(n: int = 8) -> Mesh:
    """``n`` times the CPU device: a local mesh for tests and rehearsals."""
    return make_mesh([torch.device("cpu")] * n)


def process_local_slice(items, process_index: int, process_count: int):
    """The interleaved share of one global batch owned by
    ``process_index`` (``DistributedSampler``-style): every global
    position is on exactly one rank; with ``process_count`` 1 it is the
    identity."""
    return items[process_index::process_count]


def data_sharding(batch):
    """This rank's rows of a global batch (``process_local_slice`` at the
    process group's rank and world size), as the loaders slice it."""
    return process_local_slice(batch, distributed.rank(),
                               distributed.world_size())


def replicate(tree: nn.Module | list[torch.Tensor], mesh: Mesh) -> list:
    """``tree`` (a module or a list of tensors) as rank 0 holds it, once
    per local device: first a broadcast from rank 0 into ``tree``'s own
    tensors when the group has more than one rank, then a list with one
    copy per ``mesh.devices`` entry (``tree`` itself where it already lies
    on that device and is the only entry)."""
    module = isinstance(tree, nn.Module)
    tensors = list(tree.state_dict().values()) if module else list(tree)
    distributed.broadcast_(tensors)
    if len(mesh.devices) == 1 and tensors[0].device == mesh.devices[0]:
        return [tree]
    return [copy.deepcopy(tree).to(d) if module else
            [t.to(d, copy=True) for t in tensors] for d in mesh.devices]


def per_device(forward, mesh: Mesh) -> list:
    """One callable per ``mesh.devices`` entry: ``forward`` itself when it
    is a single callable (it must then run on any of them), else its
    entries, one per device."""
    fns = list(forward) if isinstance(forward, (list, tuple)) else \
        [forward] * len(mesh.devices)
    if len(fns) != len(mesh.devices):
        raise ValueError(f"{len(fns)} forwards for {len(mesh.devices)} "
                         "devices")
    return fns


def sharded_batch(forward, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``forward`` over ``x``'s batch sharded across ``mesh.devices``:
    device i runs rows ``[i*B/n, (i+1)*B/n)`` (moved there) through its
    forward (:func:`per_device`); the rows come back to ``x``'s device in
    order. B must divide by the device count, as JAX's batch sharding
    requires."""
    fns = per_device(forward, mesh)
    n = len(fns)
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} does not divide over the "
                         f"{n}-device mesh")
    parts = [fn(part.to(d)) for fn, part, d in zip(
        fns, x.chunk(n), mesh.devices)]
    return torch.cat([p.to(x.device) for p in parts])
