"""Keyed random streams: a generator that is a pure function of a few
integers, so a draw keyed by (seed, epoch, batch) repeats on a resume."""
from __future__ import annotations

import numpy as np
import torch


def keyed_generator(device: str | torch.device, *words: int
                    ) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``words`` (e.g.
    seed, epoch, batch) through numpy's ``SeedSequence``: the same words
    give the same draws, on a run and on its resume."""
    key = np.random.SeedSequence(list(words)).generate_state(
        2, np.uint64)[0]
    return torch.Generator(device).manual_seed(int(key >> np.uint64(1)))
