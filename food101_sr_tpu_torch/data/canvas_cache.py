"""Disk-staged canvas cache: decode the dataset once into a memory-mapped
uint8 store, then train without decoding (counterpart of
``food101_sr_tpu/data/canvas_cache.py``).

``CanvasStore`` has the JAX package's layout and content key: a directory
``canvas_<key>`` holding ``canvases.npy`` ((n, S, S, 3) uint8, opened
zero-copy as a memmap), ``rows.npy`` (the source index of each row, int64)
and ``meta.json`` (format version 1), keyed by the source's fingerprint,
the indices and the canvas side. A store either package built opens in
the other. Builds are atomic (a sibling temporary directory renamed into
place).

Two loaders read it, with ``device_cache``'s canvas and augmentation
contract (eval batches byte-equal to ``SRDataLoader``'s; train crops and
flips drawn on the device, keyed by (seed, epoch, batch)):

- ``HostCanvasLoader``: a producer thread gathers each batch's canvases
  out of the memmap into pinned memory and copies them to the device on a
  side stream, recording an event that the consumer's stream waits on
  before it reads the batch. In a process group each rank gathers its
  interleaved share of the global batch and takes its rows of the global
  batch's crop and flip draws;
- ``DeviceWindowLoader``: a ring window of canvases in device memory. Each
  step draws its batch from the window (uniform with replacement) and then
  refreshes ``ceil(batch / reuse)`` ring slots from the epoch stream, so
  the host copies ``reuse`` times fewer bytes per step. The refresh is an
  H2D copy into the window on a side stream, ordered after the step's
  draw by an event recorded on the consumer's stream, and the next draw
  waits for the refresh's own event. The window is a pure function of the
  stream position: a resume rebuilds it there. Single-process, as JAX's.
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import shutil
import tempfile
import threading
import time
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from ..parallel.distributed import world_size
from ..utils.rng import keyed_generator
from .device_cache import (_AUGMENT_KEY, EpochLoader, build_canvas_cache,
                           default_canvas, sample_batch)
from .pipeline import process_local_slice

_FORMAT_VERSION = 1


def _source_fingerprint(source) -> str:
    fp = getattr(source, "fingerprint", None)
    if callable(fp):
        return fp()
    return f"{type(source).__name__}:{len(source)}"


class CanvasStore:
    """A memmapped stack of uint8 canvases and its metadata (module
    docstring)."""

    def __init__(self, path: str):
        with open(os.path.join(path, "meta.json")) as f:
            self.meta = json.load(f)
        if self.meta.get("version") != _FORMAT_VERSION:
            raise ValueError(
                f"canvas store {path} has format version "
                f"{self.meta.get('version')}; this build reads "
                f"{_FORMAT_VERSION}: rebuild the store")
        self.path = path
        self.canvas = int(self.meta["canvas"])
        self.canvases = np.load(os.path.join(path, "canvases.npy"),
                                mmap_mode="r")
        self.rows = np.load(os.path.join(path, "rows.npy"))
        self._row_of = {int(src): r for r, src in enumerate(self.rows)}

    def __len__(self):
        return self.canvases.shape[0]

    def row_for(self, source_index: int) -> int:
        return self._row_of[int(source_index)]

    def gather(self, source_indices, out: np.ndarray) -> np.ndarray:
        """The canvases of ``source_indices`` into ``out`` (one copy out of
        the memmap per row)."""
        for k, i in enumerate(source_indices):
            out[k] = self.canvases[self._row_of[int(i)]]
        return out

    @staticmethod
    def key(source, indices: np.ndarray, canvas: int) -> str:
        h = hashlib.sha1()
        h.update(_source_fingerprint(source).encode())
        h.update(np.asarray(indices, np.int64).tobytes())
        h.update(str(int(canvas)).encode())
        return h.hexdigest()[:16]

    @classmethod
    def build(cls, source, indices: np.ndarray, canvas: int, path: str,
              num_workers: Optional[int] = None,
              chunk: int = 512) -> "CanvasStore":
        """Decode ``source[i]`` for every i into the store at ``path``, a
        chunk at a time (the host holds one chunk, not the dataset), in a
        sibling temporary directory renamed into place."""
        indices = np.asarray(indices, np.int64)
        canvas = int(canvas)
        parent = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(parent, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix=".canvas_build_", dir=parent)
        try:
            arr = np.lib.format.open_memmap(
                os.path.join(tmp, "canvases.npy"), mode="w+", dtype=np.uint8,
                shape=(len(indices), canvas, canvas, 3))
            for start in range(0, len(indices), chunk):
                part = indices[start:start + chunk]
                arr[start:start + len(part)] = build_canvas_cache(
                    source, part, canvas, num_workers)
            arr.flush()
            del arr
            np.save(os.path.join(tmp, "rows.npy"), indices)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump({"version": _FORMAT_VERSION, "canvas": canvas,
                           "n": int(len(indices)),
                           "fingerprint": _source_fingerprint(source)}, f)
            try:
                os.rename(tmp, path)
            except OSError:
                pass  # a concurrent builder renamed first: use its store
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return cls(path)

    @classmethod
    def open_or_build(cls, source, indices: np.ndarray, canvas: int,
                      cache_dir: str, num_workers: Optional[int] = None,
                      max_store_gb: float = 64.0) -> "CanvasStore":
        """The store for (source, indices, canvas) under ``cache_dir``:
        opened when it exists (no decoding), built otherwise; a store
        larger than ``max_store_gb`` is refused."""
        indices = np.asarray(indices, np.int64)
        need = len(indices) * int(canvas) ** 2 * 3
        if need > float(max_store_gb) * (1 << 30):
            raise ValueError(
                f"canvas store would need {need / (1 << 30):.1f} GiB "
                f"({len(indices)} images x {canvas}px), over the "
                f"{max_store_gb:.1f} GiB budget; shrink --cache_canvas or "
                f"raise --cache_host_budget_gb if that is intended.")
        path = os.path.join(cache_dir,
                            f"canvas_{cls.key(source, indices, canvas)}")
        if os.path.isdir(path):
            return cls(path)
        return cls.build(source, indices, canvas, path,
                         num_workers=num_workers)


def _host_buffer(shape: tuple, device: torch.device) -> torch.Tensor:
    """uint8 host memory for one H2D copy: pinned for a CUDA device (the
    copy is then asynchronous, and PyTorch keeps the block from reuse
    until the copy is done)."""
    return torch.empty(shape, dtype=torch.uint8,
                       pin_memory=device.type == "cuda")


def _drain(t: threading.Thread, q: queue.Queue, stop: threading.Event):
    """Stop a producer that may be blocked on a full queue."""
    stop.set()
    while t.is_alive():
        try:
            q.get(timeout=0.05)
        except queue.Empty:
            pass


class HostCanvasLoader(EpochLoader):
    """``SRDataLoader``'s protocol over a :class:`CanvasStore` under
    ``cache_dir`` (built on first use): batches of whole canvases copied
    to ``device`` by a producer thread, cropped and flipped there in
    training (module docstring). ``wait_s`` is the consumer's time blocked
    on the queue, ``produce_s`` the producer's per pass, ``batches`` the
    batches delivered; ``setup_s`` the time the store took to open, or to
    build when it was not there."""

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
        cache_dir: str = "canvas_cache",
        canvas: Optional[int] = None,
        max_store_gb: float = 64.0,
        num_workers: Optional[int] = None,
    ):
        self._setup(source, indices, crop_size, batch_size, train, shuffle,
                    seed, device)
        self.prefetch = int(prefetch)
        self.canvas = default_canvas(self.crop_size, canvas, self.train)
        t0 = time.perf_counter()
        self.store = CanvasStore.open_or_build(
            source, self.indices, self.canvas, cache_dir,
            num_workers=num_workers, max_store_gb=max_store_gb)
        self.setup_s = time.perf_counter() - t0

    def _produce(self, order: np.ndarray, out: queue.Queue, start_batch: int,
                 stop: threading.Event):
        """Gather each batch's canvases and start its copy to the device
        on a side stream; the queue carries (tensor, event, batch)."""
        dev, b_sz, s = self.device, self.batch_size, self.canvas
        r, w = self._share
        try:
            side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
            for b in range(start_batch, len(self)):
                if stop.is_set():
                    break
                t0 = time.perf_counter()
                host = _host_buffer((b_sz // w, s, s, 3), dev)
                self.store.gather(process_local_slice(
                    order[b * b_sz:(b + 1) * b_sz], r, w), host.numpy())
                event = None
                if side is not None:
                    with torch.cuda.stream(side):
                        batch = host.to(dev, non_blocking=True)
                        event = torch.cuda.Event()
                        event.record(side)
                else:
                    batch = host.to(dev)
                self.produce_s += time.perf_counter() - t0
                out.put((batch, event, b))
        except BaseException as e:  # fail the epoch loudly, not short
            out.put(e)
        finally:
            out.put(None)

    def __iter__(self) -> Iterator[torch.Tensor]:
        epoch, start = self._begin_pass()
        order = self.indices
        if self.shuffle:
            order = np.random.default_rng(
                (self.seed, epoch, 7)).permutation(self.indices)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        t = threading.Thread(target=self._produce,
                             args=(order, q, start, stop), daemon=True)
        t.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self.wait_s += time.perf_counter() - t0
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise RuntimeError(
                        "canvas-cache loader worker failed; epoch aborted"
                    ) from item
                batch, event, b = item
                if event is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(event)
                    batch.record_stream(stream)
                self.batches += 1
                if not self.train:
                    yield batch  # canvas = crop: the host loader's bytes
                    continue
                pos = torch.arange(len(batch), device=self.device)
                yield sample_batch(batch, pos, self.crop_size, True,
                                   keyed_generator(self.device, self.seed,
                                                   epoch, b, _AUGMENT_KEY),
                                   share=self._share)
        finally:
            _drain(t, q, stop)


class DeviceWindowLoader(EpochLoader):
    """Train-only loader: a ring window of ``window`` canvases in device
    memory over a :class:`CanvasStore`, ``reuse`` draws per upload in
    expectation (module docstring; JAX's ``DeviceWindowLoader``, the
    ``--cache_host_reuse`` path). tf.data ``shuffle(buffer)`` semantics
    over the repeated epoch stream: each canvas is uploaded once every
    ``reuse`` epochs, and a batch may hold duplicates. ``len`` is N //
    batch and every batch is a pure function of (seed, epoch, step).
    ``window`` defaults to ``min(max(4 * batch, 512), window_budget_gb)``
    canvases, at most N, a multiple of the refresh quantum. ``wait_s``,
    ``produce_s``, ``batches`` and ``setup_s`` as ``HostCanvasLoader``'s."""

    def __init__(
        self,
        source,
        indices: Optional[Sequence[int]] = None,
        crop_size: int = 200,
        batch_size: int = 16,
        train: bool = True,
        seed: int = 0,
        prefetch: int = 4,
        device: str | torch.device = "cuda",
        cache_dir: str = "canvas_cache",
        canvas: Optional[int] = None,
        max_store_gb: float = 64.0,
        num_workers: Optional[int] = None,
        reuse: int = 8,
        window: Optional[int] = None,
        window_budget_gb: float = 1.0,
    ):
        if not train:
            raise ValueError(
                "DeviceWindowLoader is train-only (its with-replacement "
                "window sampling is an augmentation-time tradeoff); eval "
                "uses HostCanvasLoader, whose batches are byte-equal to the "
                "streaming loader's")
        if world_size() > 1:
            raise ValueError(
                "--cache_host_reuse is single-process only; multi-process "
                "runs shard the batch across per-process loaders already")
        self._setup(source, indices, crop_size, batch_size, True, True,
                    seed, device)
        self.prefetch = int(prefetch)
        self.reuse = max(1, int(reuse))
        self.canvas = default_canvas(self.crop_size, canvas, True)
        t0 = time.perf_counter()
        self.store = CanvasStore.open_or_build(
            source, self.indices, self.canvas, cache_dir,
            num_workers=num_workers, max_store_gb=max_store_gb)
        self.setup_s = time.perf_counter() - t0

        # R ring slots a step; the window a multiple of R, so that a
        # refresh never wraps
        self._refresh = max(1, -(-self.batch_size // self.reuse))
        n = len(self.indices)
        canvas_bytes = self.canvas * self.canvas * 3
        cap = int(float(window_budget_gb) * (1 << 30) // canvas_bytes)
        w = int(window) if window else min(max(4 * self.batch_size, 512), cap)
        w = min(w, n)
        w = max(self._refresh, w - w % self._refresh)
        if w * canvas_bytes > float(window_budget_gb) * (1 << 30):
            raise ValueError(
                f"window of {w} canvases x {self.canvas}px needs "
                f"{w * canvas_bytes / (1 << 30):.2f} GiB of device memory, "
                f"over the {window_budget_gb:.1f} GiB budget; shrink "
                f"--cache_window or --cache_canvas")
        self.window = w
        self._side = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)
        self._window_dev: torch.Tensor | None = None
        self._refreshed = None  # the last refresh's event (CUDA)
        self._pos = None  # stream position after the window's last canvas
        self._perm_cache = None

    # -- the epoch stream: the indices in epoch order, epoch after epoch --

    def _perm(self, perm_epoch: int) -> np.ndarray:
        """Epoch ``perm_epoch``'s order of the indices, the host loader's
        ``(seed, epoch, 7)`` (one cached: a chunk spans at most two)."""
        cached = self._perm_cache
        if cached is None or cached[0] != perm_epoch:
            cached = (perm_epoch, np.random.default_rng(
                (self.seed, perm_epoch, 7)).permutation(self.indices))
            self._perm_cache = cached
        return cached[1]

    def _stream_chunk(self, start: int, count: int,
                      out: np.ndarray | None = None) -> np.ndarray:
        """The canvases at stream positions [start, start + count):
        position p is epoch p // N's order at p % N."""
        n = len(self.indices)
        if out is None:
            out = np.empty((count, self.canvas, self.canvas, 3), np.uint8)
        src = [self._perm(p // n)[p % n] for p in range(start, start + count)]
        return self.store.gather(src, out)

    def _epoch_start_pos(self, epoch: int) -> int:
        return self.window + epoch * len(self) * self._refresh

    def _rebuild_window(self, pos: int):
        """The window the stream holds at position ``pos``: positions
        [pos - W, pos), each at its ring row p % W (``np.roll``), as
        sequential refreshes leave them."""
        chunk = self._stream_chunk(pos - self.window, self.window)
        chunk = np.roll(chunk, pos % self.window, axis=0)
        if self._refreshed is not None:  # the old window's last write
            torch.cuda.current_stream(self.device).wait_event(
                self._refreshed)
        self._window_dev = torch.from_numpy(chunk).to(self.device)
        if self._side is not None:
            # the refreshes write it on the side stream: keep its memory
            # until they are done, whenever it is freed
            self._window_dev.record_stream(self._side)
        self._pos = pos

    def _produce(self, out: queue.Queue, pos: int, steps: int,
                 stop: threading.Event):
        """Assemble each step's refresh chunk in host memory (pinned on
        CUDA) ahead of the consumer."""
        shape = (self._refresh, self.canvas, self.canvas, 3)
        try:
            for t in range(steps):
                if stop.is_set():
                    break
                t0 = time.perf_counter()
                host = _host_buffer(shape, self.device)
                self._stream_chunk(pos + t * self._refresh, self._refresh,
                                   host.numpy())
                self.produce_s += time.perf_counter() - t0
                out.put(host)
        except BaseException as e:
            out.put(e)
        finally:
            out.put(None)

    def _draw(self, gen: torch.Generator) -> torch.Tensor:
        pos = torch.randint(0, self.window, (self.batch_size,),
                            generator=gen, device=self.device)
        return sample_batch(self._window_dev, pos, self.crop_size, True, gen)

    def __iter__(self) -> Iterator[torch.Tensor]:
        # a pass that does not start where the last one ended (a resume's
        # set_epoch) rebuilds the window for its stream position
        epoch, start_batch = self._begin_pass()
        start = self._epoch_start_pos(epoch) + start_batch * self._refresh
        if self._pos != start:
            self._rebuild_window(start)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        t = threading.Thread(target=self._produce,
                             args=(q, start, len(self) - start_batch, stop),
                             daemon=True)
        t.start()
        step = start_batch
        cuda = self._side is not None
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self.wait_s += time.perf_counter() - t0
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise RuntimeError(
                        "window loader worker failed; epoch aborted"
                    ) from item
                # draw from the current window, then retire its oldest R
                # slots: a batch never sees the canvases its step uploads
                cur = torch.cuda.current_stream(self.device) if cuda else None
                if cuda and self._refreshed is not None:
                    cur.wait_event(self._refreshed)
                batch = self._draw(keyed_generator(
                    self.device, self.seed, epoch, step, _AUGMENT_KEY))
                ptr = self._pos % self.window
                slots = self._window_dev[ptr:ptr + self._refresh]
                if cuda:
                    drawn = torch.cuda.Event()
                    drawn.record(cur)
                    self._side.wait_event(drawn)
                    with torch.cuda.stream(self._side):
                        slots.copy_(item, non_blocking=True)
                        self._refreshed = torch.cuda.Event()
                        self._refreshed.record(self._side)
                else:
                    slots.copy_(item)
                self._pos += self._refresh
                step += 1
                self.batches += 1
                yield batch
        finally:
            _drain(t, q, stop)
