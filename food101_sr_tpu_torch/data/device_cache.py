"""Device-resident dataset cache: uint8 canvases in device memory and the
crop and flip drawn on the device (counterpart of
``food101_sr_tpu/data/device_cache.py``).

Each image is decoded once on the host into a fixed ``canvas x canvas``
uint8 square (``load_hr_crop(train=False)`` at canvas size: resize if
small, then centre crop), the stack is copied to the device, and each
training batch is drawn there: the epoch's rows, a random crop and a
random horizontal flip per sample, gathered in one indexing launch from
offsets that a few element-wise launches make on the batch's B values.
The host's work per step is one index upload.

The contract is JAX's:

- eval batches (``train=False``, canvas = crop) are byte-equal to
  ``SRDataLoader(train=False)``'s: the canvas build is the eval transform,
  and the device side is a gather;
- the epoch order is the host loader's, ``default_rng((seed, epoch,
  7))``, so each batch holds the canvases of the samples JAX's loader
  picks; the canvases themselves are byte-equal to JAX's;
- train crops come from the central canvas square, not the full image,
  and the crop and flip draws are not the host loader's: they come from a
  device ``torch.Generator`` keyed by (seed, epoch, batch)
  (``utils.rng.keyed_generator``), so a batch is a pure function of those and
  ``--resume`` replays it. JAX draws them with ``jax.random``; the two
  agree in contract (windows of the canvas, flipped or not), not in
  bytes.

Single-process, as JAX's: a process group of more than one rank refuses
it (each rank would hold the whole cache); ``HostCanvasLoader`` slices
each batch by rank.
"""
from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from ..parallel.distributed import rank, world_size
from ..parallel.mesh import process_local_slice
from ..utils.rng import keyed_generator
from .pipeline import check_divisible, load_hr_crop

_DEFAULT_BUDGET_GB = 4.0
_AUGMENT_KEY = 1  # the last word of the crop and flip draws' key


def default_canvas(crop_size: int, canvas: Optional[int], train: bool) -> int:
    """The cached square's side, by JAX's rule: ``canvas`` (at least the
    crop) for a train loader, ``max(256, crop)`` when None; exactly the
    crop for an eval loader (its batches then equal the host loader's)."""
    if not train:
        return int(crop_size)
    if canvas is None:
        canvas = max(256, int(crop_size))
    return max(int(canvas), int(crop_size))


def build_canvas_cache(source, indices: np.ndarray, canvas: int,
                       num_workers: Optional[int] = None) -> np.ndarray:
    """uint8 ``canvas x canvas`` centre crops (resize if small first) of
    ``source[i]`` for every i in ``indices``, decoded in a thread pool:
    JAX's ``build_canvas_cache``, byte for byte."""
    if num_workers is None:
        num_workers = min(16, os.cpu_count() or 1)
    rng = np.random.default_rng(0)  # unused by the centre-crop path

    def one(i):
        return load_hr_crop(source[int(i)], canvas, train=False, rng=rng)

    with ThreadPoolExecutor(max_workers=max(1, int(num_workers))) as pool:
        crops = list(pool.map(one, indices))
    return np.stack(crops) if crops else np.zeros(
        (0, canvas, canvas, 3), np.uint8)


def sample_batch(cache: torch.Tensor, pos: torch.Tensor, crop: int,
                 train: bool, generator: torch.Generator | None = None,
                 share: tuple[int, int] = (0, 1)) -> torch.Tensor:
    """Rows ``pos`` of the uint8 (N, S, S, 3) ``cache``, cropped to
    ``crop`` and, in training, cropped at random and flipped at random
    (top, left, then the flip, from ``generator``); else the centre crop,
    which for S = crop is the rows themselves. One gather for the whole
    batch: (B, crop, crop, 3) uint8 on the cache's device. ``share`` (rank,
    world): ``pos`` is that rank's interleaved share of a global batch of
    B * world; the draws are the global batch's, and the rank takes its
    rows of them."""
    b, s = pos.shape[0], cache.shape[1]
    if not train and s == crop:
        return cache.index_select(0, pos)
    dev = cache.device
    ar = torch.arange(crop, device=dev)
    if train:
        r, w = share
        n = (b * w,)
        tops, lefts = (process_local_slice(torch.randint(
            0, s - crop + 1, n, generator=generator, device=dev), r, w)
            for _ in range(2))
        flips = process_local_slice(
            torch.rand(n, generator=generator, device=dev) < 0.5, r, w)
        cols = lefts[:, None] + torch.where(flips[:, None], crop - 1 - ar, ar)
    else:
        tops = torch.full((b,), (s - crop) // 2, device=dev)
        cols = (s - crop) // 2 + ar.expand(b, crop)
    rows = tops[:, None] + ar
    return cache[pos[:, None, None], rows[:, :, None], cols[:, None, :]]


class EpochLoader:
    """The bookkeeping of ``SRDataLoader``'s protocol that the cache
    loaders share: the indices, batch geometry, seed and device
    (``_setup``), ``__len__`` (drop-remainder), ``set_epoch`` and the
    last pass's ``wait_s``, ``produce_s`` and ``batches``."""

    def _setup(self, source, indices, crop_size: int, batch_size: int,
               train: bool, shuffle: Optional[bool], seed: int, device):
        self.indices = np.asarray(
            indices if indices is not None else np.arange(len(source)),
            np.int64)
        self.crop_size = int(crop_size)
        self.batch_size = int(batch_size)
        self.train = bool(train)
        self.shuffle = self.train if shuffle is None else bool(shuffle)
        self.seed = int(seed)
        self.device = torch.device(device)
        self._epoch = self._start_batch = 0
        self.wait_s = self.produce_s = 0.0
        self.batches = 0
        self._share = (rank(), world_size())
        check_divisible(self.batch_size, self._share[1])

    def __len__(self):
        return len(self.indices) // self.batch_size

    def set_epoch(self, epoch: int, start_batch: int = 0):
        """``start_batch`` fast-forwards the next pass to that batch
        (mid-epoch resume): the draws are keyed by (seed, epoch, batch),
        so the tail equals the uninterrupted epoch's and the skipped
        batches cost nothing."""
        self._epoch = int(epoch)
        self._start_batch = int(start_batch)

    def _begin_pass(self) -> tuple[int, int]:
        """The (epoch, first batch) of the pass that starts; the next pass
        is the following epoch from its batch 0; the counters restart."""
        epoch, start = self._epoch, self._start_batch
        self._epoch, self._start_batch = epoch + 1, 0
        self.wait_s = self.produce_s = 0.0
        self.batches = 0
        return epoch, start


class DeviceCacheLoader(EpochLoader):
    """``SRDataLoader``'s protocol (``__len__``, ``set_epoch``, uint8
    NHWC batches on ``device``, drop-remainder, the ``wait_s``,
    ``produce_s`` and ``batches`` of the last pass) over a cache in device
    memory. ``canvas`` is the train loader's cached side (module
    docstring; :func:`default_canvas`); ``max_cache_gb`` refuses a cache
    larger than that. ``setup_s`` is the time the cache took to build and
    upload."""

    def __init__(
        self,
        source,
        indices: Optional[Sequence[int]] = None,
        crop_size: int = 200,
        batch_size: int = 16,
        train: bool = True,
        shuffle: Optional[bool] = None,
        seed: int = 0,
        device: str | torch.device = "cuda",
        canvas: Optional[int] = None,
        max_cache_gb: float = _DEFAULT_BUDGET_GB,
        num_workers: Optional[int] = None,
    ):
        if world_size() > 1:
            raise ValueError(
                "--cache_device is single-process only: in a multi-process "
                "run each process would replicate the full cache; use the "
                "host loader there (its per-process batch slicing already "
                "scales with process count)")
        self._setup(source, indices, crop_size, batch_size, train, shuffle,
                    seed, device)
        self.canvas = canvas = default_canvas(self.crop_size, canvas,
                                              self.train)
        need = len(self.indices) * canvas * canvas * 3
        if need > float(max_cache_gb) * (1 << 30):
            raise ValueError(
                f"device cache would need {need / (1 << 30):.2f} GiB "
                f"({len(self.indices)} images x {canvas}px canvas), over "
                f"the {max_cache_gb:.1f} GiB budget. Lower --subset, shrink "
                f"--cache_canvas, raise the budget, or drop --cache_device "
                f"(the host loader streams any size).")
        t0 = time.perf_counter()
        host = build_canvas_cache(source, self.indices, canvas, num_workers)
        self._cache = torch.from_numpy(host).to(self.device)
        self.setup_s = time.perf_counter() - t0

    def __iter__(self) -> Iterator[torch.Tensor]:
        epoch, start = self._begin_pass()
        n = len(self.indices)
        order = (np.random.default_rng((self.seed, epoch, 7))
                 .permutation(n) if self.shuffle else np.arange(n))
        for b in range(start, len(self)):
            t0 = time.perf_counter()
            pos = torch.from_numpy(
                order[b * self.batch_size:(b + 1) * self.batch_size]).to(
                self.device, non_blocking=True)
            gen = (keyed_generator(self.device, self.seed, epoch, b,
                                   _AUGMENT_KEY) if self.train else None)
            batch = sample_batch(self._cache, pos, self.crop_size,
                                 self.train, gen)
            self.produce_s += time.perf_counter() - t0
            self.batches += 1
            yield batch
