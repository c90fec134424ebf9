"""Graceful-preemption guard for the training loop (counterpart of
``food101_sr_tpu/training/preempt.py``).

A SIGTERM (spot reclaim, maintenance) mid-epoch becomes a flag; the loop
polls it at each update boundary, where the train state is consistent,
saves the full state with the number of batches consumed, and exits.
``--resume`` fast-forwards the epoch-seeded loader to that batch, so the
resumed run replays the rest of the epoch exactly
(``tests/test_torch_loop.py``: resumed == uninterrupted, bit for bit).

Multi-process runs: every rank polls its own flag, and every
``sync_every`` updates the flags are agreed across the ranks (a MAX
all-reduce), so one rank's signal stops all of them at the same update
and no rank is left waiting in a collective.
"""
from __future__ import annotations

import signal
import threading

import torch

from ..parallel.distributed import agree, world_size


class PreemptionGuard:
    """Context manager that converts SIGTERM into a polled flag.

    The handler only sets a flag; the checkpoint I/O happens on the
    training thread. Python allows signal handlers on the main thread
    only, so off it the guard installs nothing and only ``request()``
    sets the flag.
    """

    def __init__(self, signals=(signal.SIGTERM,),
                 device: str | torch.device = "cpu"):
        self._signals = tuple(signals)
        self.device = device  # where the agreement's flag lives (NCCL: a card)
        self._old = {}
        self._installed = False
        self.requested = False

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            for sig in self._signals:
                self._old[sig] = signal.signal(sig, self._on_signal)
            self._installed = True
        return self

    def __exit__(self, *exc):
        if self._installed:
            for sig, old in self._old.items():
                signal.signal(sig, old)
            self._installed = False
        return False

    def _on_signal(self, signum, frame):
        self.requested = True

    def request(self):
        """Programmatic trigger (tests, drills, --preempt_after_updates)."""
        self.requested = True

    def poll(self, update_idx: int = 0, sync_every: int = 16) -> bool:
        """True when training should stop at this update boundary.

        One process: the local flag, at every update. Several: the flags
        agreed across ranks every ``sync_every`` updates, so every rank
        gets the same answer at the same update. ``update_idx`` is a
        0-based count that is the same on every rank and grows over the
        whole run (the loop passes the cumulative update count: an epoch
        shorter than ``sync_every`` would never reach an agreement if
        the count restarted each epoch)."""
        if world_size() == 1:
            return self.requested
        if (update_idx + 1) % max(int(sync_every), 1):
            return False
        return agree(self.requested, self.device)
