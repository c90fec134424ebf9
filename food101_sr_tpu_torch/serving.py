"""SR serving engine (counterpart of the engine part of the JAX package's
``serve.py``): a micro-batcher that coalesces concurrent same-shape
requests into one device batch, and a server core that takes uint8 HWC
images and returns the x``scale`` uint8 result.

The HTTP front end and the image codecs are not part of this module; the
engine works on numpy arrays.

    server = SRServer("AttentionSR")          # seeded weights, bf16, cuda
    sr = server.upscale(lr_uint8_hwc)         # (H*4, W*4, 3) uint8
    server.close()
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable

import numpy as np
import torch
from torch import nn

from .models import get_model
from .parallel.spatial import plan_windows, receptive_radius

_STOP = object()  # queue sentinel: close() puts it behind all pending work


class MicroBatcher:
    """Coalesces concurrent same-shape requests into one device batch.

    Request threads enqueue (array, event, slot); one daemon batcher thread
    owns the device: it takes the first pending item, drains whatever else
    arrives within the collect window with the same shape (up to
    ``max_batch``), runs ONE forward over the stacked batch, and hands each
    row back. ``close()`` serves what is queued, then stops the thread.
    """

    def __init__(self, fwd: Callable[[np.ndarray], np.ndarray],
                 max_batch: int = 8, window_ms: float = 3.0,
                 adaptive: bool = False):
        self._fwd = fwd
        self.max_batch = max_batch
        self.window = window_ms / 1e3
        # Adaptive coalescing: keep the short window until the previous
        # dispatch went out >= 75% full (evidence of load), then extend the
        # collect deadline toward the measured batch-exec EMA, capped at
        # 100 ms, so sparse traffic never waits out a long window.
        self.adaptive = adaptive
        self._ema_exec_s = 0.0
        self._last_fill = 0
        self.n_batches = 0
        self.n_items = 0
        self._q: queue.Queue = queue.Queue()
        self._lock = threading.Lock()  # orders submits against close()
        self._closed = False
        self._thread = threading.Thread(target=self._run, name="sr-batcher",
                                        daemon=True)
        self._thread.start()

    def collect_window(self) -> float:
        """Collect deadline for the next group (seconds)."""
        if (not self.adaptive or self._ema_exec_s <= 0
                or self._last_fill * 4 < self.max_batch * 3):
            return self.window
        return min(max(self.window, 0.75 * self._ema_exec_s), 0.1)

    def submit(self, x: np.ndarray) -> np.ndarray:
        """x: [H, W, C] uint8. Blocks until its SR row is ready."""
        return self.submit_many([x])[0]

    def submit_many(self, xs) -> list:
        """Enqueue several items at once, then wait for all of them, so the
        batcher groups them (and concurrent same-shape items of other
        requests) into ``max_batch`` device batches."""
        pending = []
        with self._lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            for x in xs:
                ev, slot = threading.Event(), {}
                self._q.put((x, ev, slot))
                pending.append((ev, slot))
        outs = []
        for ev, slot in pending:
            ev.wait()
            if "err" in slot:
                raise slot["err"]
            outs.append(slot["out"])
        return outs

    def close(self, timeout: float = 30.0) -> None:
        """Serve what is queued, stop the batcher thread, and wait for it."""
        with self._lock:
            if not self._closed:
                self._closed = True
                self._q.put(_STOP)
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError("MicroBatcher thread did not stop")

    def _run(self):
        pending = None  # item of another bucket, leads the next round
        while True:
            first = pending if pending is not None else self._q.get()
            pending = None
            if first is _STOP:
                return
            group = [first]
            shape = first[0].shape
            deadline = time.perf_counter() + self.collect_window()
            while len(group) < self.max_batch:
                timeout = deadline - time.perf_counter()
                if timeout <= 0:
                    break
                try:
                    item = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if item is not _STOP and item[0].shape == shape:
                    group.append(item)
                else:
                    pending = item
                    break
            try:
                t0 = time.perf_counter()
                out = self._fwd(np.stack([g[0] for g in group]))
                batch_s = time.perf_counter() - t0
            except Exception as e:  # noqa: BLE001 - handed to the callers
                for _, ev, slot in group:
                    slot["err"] = e
                    ev.set()
                continue
            self._ema_exec_s = (batch_s if self._ema_exec_s == 0 else
                                0.7 * self._ema_exec_s + 0.3 * batch_s)
            self._last_fill = len(group)
            self.n_batches += 1
            self.n_items += len(group)
            for i, (_, ev, slot) in enumerate(group):
                slot["out"] = out[i]
                ev.set()


class SRServer:
    """Serving core: uint8 HWC in, uint8 HWC out at ``scale`` times the size.

    Small images (padded by edge replication to a multiple of ``tile``) ride
    the micro-batcher whole; larger ones are cut into ``tile + 2*halo``
    windows (halo = the model's receptive-field radius, so the result equals
    the whole-image forward) that ride the same batcher. ToTensor and the
    255-quantization run on the device. ``model`` overrides the registry
    net (it must expose ``scale_factor`` and ``num_residuals``);
    ``state_dict`` loads weights with ``strict=True``; otherwise the weights
    are seeded from ``generator`` (seed 0 when None). ``window_ms`` and
    ``adaptive_window`` set the micro-batcher's collect window
    (:class:`MicroBatcher`), with the JAX ``SRServer``'s defaults.
    """

    def __init__(self, architecture: str = "AttentionSR",
                 state_dict: dict | None = None, *, scale: int = 4,
                 tile: int = 64, dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None,
                 model: nn.Module | None = None, max_batch: int = 8,
                 window_ms: float = 3.0, adaptive_window: bool = False):
        self.device = torch.device(device)
        self.dtype = dtype
        if model is None:
            model = get_model(architecture, scale_factor=scale, dtype=dtype,
                              device=self.device, generator=generator)
        self.model = model.to(device=self.device, dtype=dtype,
                              memory_format=torch.channels_last).eval()
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        self.scale = self.model.scale_factor
        self.tile = tile
        self.halo = receptive_radius(self.model)
        self.batcher = MicroBatcher(self._sr_u8, max_batch=max_batch,
                                    window_ms=window_ms,
                                    adaptive=adaptive_window)
        self.n_served = 0
        self._served_lock = threading.Lock()

    @torch.inference_mode()
    def forward_u8(self, x8: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 on the device -> (B, sH, sW, 3) uint8, B <=
        max_batch. The net always runs ``max_batch`` rows (zero rows fill
        the rest): cuDNN picks its algorithm per shape, and in bf16 two
        algorithms round differently, by several uint8 levels on random
        weights. One shape per bucket makes a request's result independent
        of how many others shared its batch."""
        n, pad = x8.shape[0], self.batcher.max_batch - x8.shape[0]
        if pad < 0:
            raise ValueError(f"forward_u8: {n} rows > max_batch "
                             f"{self.batcher.max_batch}")
        if pad:
            x8 = torch.cat([x8, x8.new_zeros((pad, *x8.shape[1:]))])
        # NHWC bytes viewed as (B, 3, H, W): already channels-last, no copy
        x = (x8.permute(0, 3, 1, 2).float() / 255.0).to(self.dtype)
        y = self.model(x)[:n].float()
        y8 = (y.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
        return y8.permute(0, 2, 3, 1)

    def _sr_u8(self, stack: np.ndarray) -> np.ndarray:
        return self.forward_u8(torch.from_numpy(stack).to(self.device)) \
            .cpu().numpy()

    def upscale(self, img: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8 -> (H*scale, W*scale, 3) uint8."""
        if img.dtype != np.uint8 or img.ndim != 3:
            raise ValueError(f"upscale: needs an (H, W, C) uint8 array, got "
                             f"{img.dtype} {img.shape}")
        h, w = img.shape[:2]
        ph, pw = (-h) % self.tile, (-w) % self.tile
        xp = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge")
        if max(xp.shape[0], xp.shape[1]) <= self.tile + 2 * self.halo:
            out = self.batcher.submit(xp)
        else:
            out = self._upscale_tiled(xp)
        with self._served_lock:
            self.n_served += 1
        return out[: h * self.scale, : w * self.scale]

    def _upscale_tiled(self, xp: np.ndarray) -> np.ndarray:
        """Overlap windows -> micro-batcher -> stitched SR, submitted in
        bounded chunks so a huge image never holds every SR window in host
        memory at once."""
        h, w, c = xp.shape
        tile, s = self.tile, self.scale
        starts_h, starts_w, win_h, win_w = plan_windows(h, w, tile, self.halo)
        coords = [(i, sh, j, sw) for i, sh in enumerate(starts_h)
                  for j, sw in enumerate(starts_w)]
        sr = np.empty((h * s, w * s, c), np.uint8)
        chunk = 4 * self.batcher.max_batch
        for c0 in range(0, len(coords), chunk):
            part = coords[c0:c0 + chunk]
            wins = [np.ascontiguousarray(xp[sh:sh + win_h, sw:sw + win_w])
                    for _, sh, _, sw in part]
            for (i, sh, j, sw), out in zip(part,
                                           self.batcher.submit_many(wins)):
                off_h = (i * tile - sh) * s
                off_w = (j * tile - sw) * s
                sr[i * tile * s:(i + 1) * tile * s,
                   j * tile * s:(j + 1) * tile * s] = \
                    out[off_h:off_h + tile * s, off_w:off_w + tile * s]
        return sr

    def close(self) -> None:
        """Stop the batcher thread (after serving what is queued)."""
        self.batcher.close()
