"""Multi-process launch wiring and the collectives of data-parallel
training (counterpart of ``food101_sr_tpu/parallel/distributed.py``).

JAX runs one program per host over every local device and XLA inserts the
collectives. The port runs one process per card (a host with k cards
trains with k processes) and calls its collectives itself: all built from
``all_reduce``, ``broadcast`` and ``barrier``, which both backends carry
for CUDA tensors.

Launch modes (checked in order), as in the JAX package:

* explicit flags: ``--coordinator host:port --num_processes N
  --process_id I`` on every process;
* environment: torchrun's ``MASTER_ADDR`` and ``MASTER_PORT`` (with
  ``WORLD_SIZE`` and ``RANK``), in place of ``JAX_COORDINATOR_ADDRESS``
  and its siblings;
* ``--distributed auto``: ``init_method="env://"``, every value from
  torchrun's environment; a missing variable is named.

For example, two cards on one host::

    torchrun --nproc_per_node 2 -m food101_sr_tpu_torch.train \\
        --distributed auto --architecture RESNET ...

or explicitly, one command per card::

    python -m food101_sr_tpu_torch.train --coordinator localhost:8476 \\
        --num_processes 2 --process_id 0 ...        # ... --process_id 1

The backend is chosen, never fallen back to: NCCL where each process on a
host has a card of its own, gloo on the CPU and where processes share a
card (NCCL refuses two ranks on one device). A host's process count is
``LOCAL_WORLD_SIZE`` (torchrun sets it); without it, a coordinator on the
loopback (``localhost``, ``127.*``, ``::1``) means one host, whose process
count is the world size, and any other coordinator is refused for a CUDA
launch, since the processes may span hosts: set ``LOCAL_WORLD_SIZE`` on
each host, or launch with torchrun. The rank's card is
``cuda:(local_rank % device_count)``.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

_ENV_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
_LOOPBACK = ("localhost", "::1", "[::1]")


def rank() -> int:
    """This process's rank in the group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The group's process count (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_world_size() -> int:
    """Processes on this host: torchrun's ``LOCAL_WORLD_SIZE``, else the
    world size."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))


def local_rank() -> int:
    """This process's index among the host's: torchrun's ``LOCAL_RANK``,
    else the rank modulo the host's process count."""
    return int(os.environ.get("LOCAL_RANK", rank() % local_world_size()))


def host_processes(coordinator: str, world: int) -> int:
    """This host's process count: ``LOCAL_WORLD_SIZE``, else ``world``
    when ``coordinator`` (host:port) is on the loopback, so that every
    process runs here. Raises otherwise: the group may span hosts, and
    their process counts cannot be told from here."""
    if os.environ.get("LOCAL_WORLD_SIZE"):
        return int(os.environ["LOCAL_WORLD_SIZE"])
    host = coordinator.rsplit(":", 1)[0]
    if host in _LOOPBACK or host.startswith("127."):
        return world
    raise ValueError(
        f"coordinator {coordinator} is not on the loopback, so the "
        f"{world} processes may span hosts: set LOCAL_WORLD_SIZE to the "
        "processes on this host (torchrun sets it), or use "
        "--coordinator localhost:PORT for one host")


def choose_backend(device_type: str, local_processes: int,
                   n_cards: int) -> str:
    """"nccl" when every one of ``local_processes`` on the host has a card
    of its own among ``n_cards``; "gloo" on the CPU or when they share."""
    if device_type != "cuda":
        return "gloo"
    return "nccl" if local_processes <= n_cards else "gloo"


def rank_device(device: str | torch.device) -> torch.device:
    """The device this process trains on: ``cuda`` becomes
    ``cuda:(local_rank % device_count)`` in a group (a rank owns one card);
    an explicit index or the CPU stays. Raises for CUDA without a card."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(f"rank {rank()}: no CUDA device for {device}")
    if device.index is None and world_size() > 1:
        device = torch.device("cuda", local_rank() % torch.cuda.device_count())
    return device


def maybe_initialize(coordinator: str = "", num_processes: int = 0,
                     process_id: int = -1, mode: str = "",
                     device: str | torch.device = "cuda") -> bool:
    """Bring up ``torch.distributed`` when a multi-process launch is
    requested; a no-op (False) for a single-process run. Idempotent: a
    second call, or one after the caller's own ``init_process_group``, is
    a no-op (True). ``device`` chooses the backend (module docstring)."""
    if dist.is_initialized():
        return True
    device = torch.device(device)
    env = os.environ
    if not coordinator and env.get("MASTER_ADDR") and mode != "auto":
        if not env.get("MASTER_PORT"):
            raise ValueError("MASTER_ADDR is set but MASTER_PORT is not")
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes <= 0:
        num_processes = int(env.get("WORLD_SIZE", "0"))
    if process_id < 0:
        process_id = int(env.get("RANK", "-1"))

    if mode == "auto":
        missing = [v for v in _ENV_VARS if not env.get(v)]
        if missing:
            raise ValueError(
                f"--distributed auto reads torchrun's environment; "
                f"{', '.join(missing)} not set (launch with torchrun, or "
                "pass --coordinator, --num_processes and --process_id)")
        kw = {"init_method": "env://"}
    elif coordinator:
        if num_processes <= 0 or process_id < 0:
            raise ValueError(
                "--coordinator requires --num_processes and --process_id "
                "(or WORLD_SIZE / RANK)")
        kw = {"init_method": f"tcp://{coordinator}",
              "world_size": num_processes, "rank": process_id}
    else:
        return False
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"process {process_id}: no CUDA device")
        if mode == "auto":
            coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        local = host_processes(coordinator, num_processes)
        n_cards = torch.cuda.device_count()
        why = f"{local} process(es) on {n_cards} card(s) on this host"
    else:
        local, n_cards, why = num_processes, 0, "the CPU"
    backend = choose_backend(device.type, local, n_cards)
    dist.init_process_group(backend=backend, **kw)
    print(f"torch.distributed initialized: process {process_id}/"
          f"{num_processes}, backend {backend} ({why})", flush=True)
    return True


def maybe_initialize_from_config(cfg: dict,
                                 device: str | torch.device = "cuda") -> bool:
    return maybe_initialize(
        coordinator=str(cfg.get("coordinator", "") or ""),
        num_processes=int(cfg.get("num_processes", 0) or 0),
        process_id=int(cfg.get("process_id", -1)
                       if cfg.get("process_id") is not None else -1),
        mode=str(cfg.get("distributed", "") or ""), device=device)


# ---------------------------------------------------------------------------
# collectives (no-ops in a world of 1)
# ---------------------------------------------------------------------------

def _coalesced_(tensors: list[torch.Tensor], collective) -> None:
    """Run ``collective`` in place on one flat buffer per (dtype, device)
    of ``tensors`` and copy the result back into each tensor, which keeps
    its own strides (fused optimizers refuse gradients in another memory
    format than their parameter's; collectives want dense buffers)."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for group in groups.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        collective(flat)
        torch._foreach_copy_(group, [v.view(t.shape) for v, t in zip(
            flat.split([t.numel() for t in group]), group)])


@torch.no_grad()
def all_reduce_mean_(tensors: list[torch.Tensor]) -> None:
    """In place, each tensor's mean over the ranks: one all-reduce of one
    flat buffer per dtype, divided by the world size."""
    w = world_size()
    if w == 1:
        return

    def mean_(flat):
        dist.all_reduce(flat)
        flat /= w

    _coalesced_(tensors, mean_)


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, differentiable: the backward sums the
    cotangents over the ranks too, so each rank's gradient carries the
    other ranks' losses' share through this value. ``t`` itself in a
    world of 1."""
    if world_size() == 1:
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t)


def global_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t``'s elements over the global batch (each rank holds
    an equal share), differentiable; ``t.mean()`` in a world of 1."""
    if world_size() == 1:
        return t.mean()
    return global_sum(t.sum()) / (t.numel() * world_size())


def agree(flag: bool, device: str | torch.device = "cpu") -> bool:
    """True on every rank when ``flag`` is True on any (a MAX all-reduce)."""
    if world_size() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


@torch.no_grad()
def broadcast_(tensors: list[torch.Tensor], src: int = 0) -> None:
    """In place, every tensor as rank ``src`` holds it."""
    if world_size() > 1:
        _coalesced_(tensors, lambda flat: dist.broadcast(flat, src))


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()
