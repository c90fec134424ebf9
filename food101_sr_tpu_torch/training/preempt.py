"""Graceful-preemption guard for the training loop (counterpart of
``food101_sr_tpu/training/preempt.py``, single process).

A SIGTERM (spot reclaim, maintenance) mid-epoch becomes a flag; the loop
polls it at each update boundary, where the train state is consistent,
saves the full state with the number of batches consumed, and exits.
``--resume`` fast-forwards the epoch-seeded loader to that batch, so the
resumed run replays the rest of the epoch exactly
(``tests/test_torch_loop.py``: resumed == uninterrupted, bit for bit).
"""
from __future__ import annotations

import signal
import threading


class PreemptionGuard:
    """Context manager that converts SIGTERM into a polled flag.

    The handler only sets a flag; the checkpoint I/O happens on the
    training thread. Python allows signal handlers on the main thread
    only, so off it the guard installs nothing and only ``request()``
    sets the flag.
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = tuple(signals)
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

    def poll(self) -> bool:
        """True when training should stop at this update boundary (one
        process: the local flag; the JAX package's agreement across
        processes comes with multi-GPU training, ROADMAP item 10)."""
        return self.requested
