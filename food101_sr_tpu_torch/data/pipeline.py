"""Host -> device input pipeline (counterpart of
``food101_sr_tpu/data/pipeline.py``).

Work is split as in the JAX package:

  host (uint8):    source image (for JPEG bytes, only the crop region
                   is decoded) -> resize-if-small (Pillow's bicubic,
                   shorter side to the crop, ``pil_bicubic``) -> random or
                   centre crop -> random hflip
  device (a step): uint8 -> float / 255 ('ToTensor') -> antialiased
                   bicubic x1/scale degradation (``prepare_batch``)

Only uint8 HR crops cross to the device. ``SRDataLoader`` assembles
batches in a producer thread with a thread pool and copies each batch to
the loader's device there (a plain blocking copy, in stream order with the
consumer's work, so no event or ``record_stream`` is needed). Its batches
are byte for byte the JAX package's: the same seeded splits, the same
shuffle key ``(seed, epoch, 7)``, and the augmentation RNG keyed by
``(seed, epoch, global position)``, drawn top, left, then flip.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from ..native import decode_image, decode_jpeg_crop_rgb8, jpeg_dims
from ..ops.resize import degrade_bicubic
from ..parallel.distributed import rank, world_size
from ..parallel.mesh import process_local_slice
from .pil_bicubic import resize_bicubic_u8


# ---------------------------------------------------------------------------
# Per-sample host transform
# ---------------------------------------------------------------------------

def load_hr_crop(img: np.ndarray, crop_size: int, train: bool,
                 rng: np.random.Generator) -> np.ndarray:
    """uint8 (H, W, C) image -> uint8 HWC HR crop, as the JAX package's
    ``load_hr_crop`` makes it from the same image."""
    if img.ndim == 2:  # grey: three equal channels, as PIL's RGB view
        img = np.stack([img] * 3, axis=-1)
    h, w = img.shape[:2]
    if w < crop_size or h < crop_size:
        # torchvision Resize(int): shorter side -> crop_size, keep aspect.
        if w <= h:
            nw, nh = crop_size, max(crop_size, int(crop_size * h / w))
        else:
            nw, nh = max(crop_size, int(crop_size * w / h)), crop_size
        img = resize_bicubic_u8(img, (nw, nh))
        h, w = img.shape[:2]

    if train:
        top = int(rng.integers(0, h - crop_size + 1))
        left = int(rng.integers(0, w - crop_size + 1))
    else:
        top = (h - crop_size) // 2
        left = (w - crop_size) // 2
    crop = img[top : top + crop_size, left : left + crop_size, :3]

    if train and rng.random() < 0.5:
        crop = crop[:, ::-1, :]
    return np.ascontiguousarray(crop)


def load_sample(source, i: int, crop_size: int, train: bool,
                rng: np.random.Generator) -> np.ndarray:
    """One HR crop from ``source[i]``, as the JAX package's ``load_sample``
    makes it, drawing the RNG in the same order (top, left, then the
    flip). When the source has raw bytes (``bytes_at``) of a JPEG at
    least crop-sized on both sides, only the crop region is decoded: the
    codec's region decode gives full-decode-then-crop's pixels, so the
    batch is the same either way. Otherwise the bytes are decoded in full
    and go through ``load_hr_crop`` (Pillow-exact resize if small).

    The decoders give the JAX package's pixels on each of its paths: its
    libjpeg's region decode (arithmetic-coded and truncated streams
    included) and, where it falls back to PIL (CMYK, YCCK, lossless;
    small images), PIL's. A stream the JAX package's loader fails on too
    (a 12-bit JPEG, a broken file) raises, naming the file and the
    feature; the loader then fails the epoch."""
    if not hasattr(source, "bytes_at"):
        return load_hr_crop(source[i], crop_size, train, rng)
    data = source.bytes_at(i)
    try:
        dims = jpeg_dims(data)
        if dims is not None and dims[0] >= crop_size and dims[1] >= crop_size:
            w, h = dims
            if train:
                top = int(rng.integers(0, h - crop_size + 1))
                left = int(rng.integers(0, w - crop_size + 1))
            else:
                top = (h - crop_size) // 2
                left = (w - crop_size) // 2
            crop = decode_jpeg_crop_rgb8(data, left, top, crop_size,
                                         crop_size)
            if train and rng.random() < 0.5:
                crop = crop[:, ::-1, :]
            return np.ascontiguousarray(crop)
        img = decode_image(data)
    except ValueError as e:  # UnsupportedImage too: same type, named file
        paths = getattr(source, "paths", None)
        raise type(e)(f"{paths[i] if paths else f'item {i}'}: {e}") from e
    return load_hr_crop(img, crop_size, train, rng)


# ---------------------------------------------------------------------------
# Device-side batch preparation (inside a step)
# ---------------------------------------------------------------------------

def prepare_batch(hr_u8: torch.Tensor, scale_factor: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8 NHWC HR batch -> (lr, hr) float32 in [0, 1], (N, C, H, W).
    ``hr`` is the NHWC bytes viewed as NCHW, so channels-last in memory;
    ``lr`` is the antialiased bicubic ``1/scale_factor`` degradation."""
    hr = hr_u8.permute(0, 3, 1, 2).float() / 255.0
    return degrade_bicubic(hr, scale_factor), hr


# ---------------------------------------------------------------------------
# Split helpers (seeded versions of the reference's random_split usage)
# ---------------------------------------------------------------------------

def subset_indices(n: int, fraction: float, seed: int = 0) -> np.ndarray:
    """Proxy mode: keep a random ``fraction`` of the dataset, seeded."""
    if fraction >= 1.0:
        return np.arange(n)
    keep = int(n * fraction)
    return np.random.default_rng(seed).permutation(n)[:keep]


def train_val_split(indices: np.ndarray, val_fraction: float = 0.1, seed: int = 1):
    """90/10 split, seeded."""
    perm = np.random.default_rng(seed).permutation(len(indices))
    n_train = int(len(indices) * (1.0 - val_fraction))
    return indices[perm[:n_train]], indices[perm[n_train:]]


def check_divisible(batch_size: int, world: int) -> None:
    """A global batch must split evenly over the ranks."""
    if batch_size % world:
        raise ValueError(f"global batch_size={batch_size} must divide "
                         f"evenly across {world} processes")


# ---------------------------------------------------------------------------
# Batched loader with background prefetch
# ---------------------------------------------------------------------------

class SRDataLoader:
    """Iterates uint8 NHWC HR-crop batches, as tensors on ``device``, from
    a producer thread. Batches drop the remainder, so every step sees a
    full batch.

    After each pass, ``wait_s`` is the time the consumer spent blocked on
    the queue, ``produce_s`` the producer's time spent assembling and
    copying batches, and ``batches`` the batches delivered.

    In a process group, ``batch_size`` is the global batch: each rank
    loads its interleaved share of every batch (``process_local_slice``),
    the RNG keyed by global position, so the rows are those of the
    single-process run."""

    def __init__(
        self,
        source,
        indices: Optional[Sequence[int]] = None,
        crop_size: int = 200,
        batch_size: int = 16,
        train: bool = True,
        shuffle: Optional[bool] = None,
        seed: int = 0,
        prefetch: int = 4,
        device: str | torch.device = "cuda",
        num_workers: Optional[int] = None,  # None -> one per CPU core (<=16)
    ):
        self.source = source
        self.indices = np.asarray(
            indices if indices is not None else np.arange(len(source))
        )
        self.crop_size = crop_size
        self.batch_size = batch_size
        self.train = train
        self.shuffle = train if shuffle is None else shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.device = torch.device(device)
        if num_workers is None:
            num_workers = min(16, os.cpu_count() or 1)
        self.num_workers = max(1, int(num_workers))
        self._epoch = 0
        self._start_batch = 0
        self.wait_s = self.produce_s = 0.0
        self.batches = 0
        self._rank, self._world = rank(), world_size()
        check_divisible(self.batch_size, self._world)

    def __len__(self):
        return len(self.indices) // self.batch_size

    def set_epoch(self, epoch: int, start_batch: int = 0):
        """Pin the shuffle/augment seed epoch. ``start_batch`` fast-forwards
        the NEXT pass to that batch (mid-epoch preemption resume): the
        augmentation RNG is keyed by global sample position, so skipped
        batches are never decoded and the tail is byte-identical to the
        uninterrupted epoch's."""
        self._epoch = int(epoch)
        self._start_batch = int(start_batch)

    def _produce(self, order: np.ndarray, out: queue.Queue, epoch: int,
                 start_batch: int, stop: threading.Event):
        """Assemble batches with a thread pool: the JPEG codec (a ctypes
        call) and numpy's larger array operations release the GIL, so the
        workers overlap, but
        their Python between those calls competes for the GIL with the
        consumer's thread (PERF.md §5 measures what that costs the train
        step). The augmentation RNG is derived per (seed, epoch, global
        position), so batches do not depend on worker scheduling."""

        def one(pos_and_idx):
            pos, i = pos_and_idx
            rng = np.random.default_rng((self.seed, epoch, int(pos)))
            return load_sample(self.source, int(i), self.crop_size,
                               self.train, rng)

        try:
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                for start in range(start_batch * self.batch_size,
                                   len(order) - self.batch_size + 1,
                                   self.batch_size):
                    if stop.is_set():
                        break
                    t0 = time.perf_counter()
                    idx = order[start : start + self.batch_size]
                    work = process_local_slice(
                        list(enumerate(idx, start=start)), self._rank,
                        self._world)
                    batch = np.stack(list(pool.map(one, work)))
                    batch = torch.from_numpy(batch).to(self.device)
                    self.produce_s += time.perf_counter() - t0
                    out.put(batch)
        except BaseException as e:  # a worker error (corrupt file, OOM)
            # must fail the epoch loudly, not truncate it
            out.put(e)
        finally:
            out.put(None)

    def __iter__(self) -> Iterator[torch.Tensor]:
        order = self.indices
        if self.shuffle:
            order = np.random.default_rng((self.seed, self._epoch, 7)).permutation(
                self.indices
            )
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        self.wait_s = self.produce_s = 0.0
        self.batches = 0
        t = threading.Thread(
            target=self._produce,
            args=(order, q, self._epoch, self._start_batch, stop), daemon=True
        )
        t.start()
        self._epoch += 1
        self._start_batch = 0  # one-shot: only the resumed epoch skips
        try:
            while True:
                t0 = time.perf_counter()
                batch = q.get()
                self.wait_s += time.perf_counter() - t0
                if batch is None:
                    break
                if isinstance(batch, BaseException):
                    raise RuntimeError(
                        "data loader worker failed; epoch aborted") from batch
                self.batches += 1
                yield batch
        finally:
            # a consumer that stops early (preemption, an error) must not
            # leave the producer blocked on a full queue
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
