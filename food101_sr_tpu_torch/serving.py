"""SR serving engine (counterpart of the engine part of the JAX package's
``serve.py``): a micro-batcher that coalesces concurrent same-shape
requests into one device batch, and a server core that takes uint8 HWC
images and returns the x``scale`` uint8 result.

The engine works on numpy arrays; the HTTP front end is ``serve.py``,
the offline CLI ``predict.py`` and the image codecs ``native``.

    server = SRServer("AttentionSR")          # seeded weights, bf16, cuda
    server.warmup()                           # cuDNN picks per bucket
    sr = server.upscale(lr_uint8_hwc)         # (H*4, W*4, 3) uint8
    server.close()

    SRServer("auto", state_dict=sd)           # the net that sd's keys and
                                              # shapes describe
    SRServer("auto", checkpoint="w/run_best.pth")   # a torch checkpoint file
    SRServer("AttentionSR", tta=True)         # x8 self-ensemble per image
    SRServer("RESNET", quantize="int8")       # dynamic-int8 body convs
    SRServer("AttentionSR", use_mesh=True)    # one replica per local card
"""
from __future__ import annotations

import functools
import queue
import threading
import time
from typing import Callable

import numpy as np
import torch
from torch import nn

from .models import architecture_of, get_model, model_for_params
from .ops.tta import self_ensemble
from .parallel.mesh import Mesh, cpu_mesh, make_mesh, replicate, sharded_batch
from .parallel.spatial import plan_windows, receptive_radius
from .training.checkpoint import load_checkpoint

_STOP = object()  # queue sentinel: close() puts it behind all pending work


class _Call:
    """Queue item of :meth:`MicroBatcher.call`: a function, not an image."""

    def __init__(self, fn: Callable[[], object]):
        self.fn = fn


def _identity(x):
    return x


def _no_sync() -> None:
    pass


class MicroBatcher:
    """Coalesces concurrent same-shape requests into one device batch.

    Request threads enqueue (array, event, slot); one daemon batcher thread
    owns the device: it takes the first pending item, drains whatever else
    arrives within the collect window with the same shape (up to
    ``max_batch``), runs ONE forward over the stacked batch, and hands each
    row back. ``close()`` serves what is queued, then stops the thread.

    A batch passes three stages: ``h2d`` (the stacked uint8 array to the
    device), ``fwd`` and ``d2h`` (the rows back to numpy), each the
    identity by default, so ``fwd`` alone may map arrays to arrays. The
    batcher thread adds each batch's seconds to ``t_collect_s`` (the
    collect window), ``t_h2d_s`` and ``t_exec_fetch_s`` (forward and D2H;
    the device runs asynchronously, so only their sum is one stage), and
    its rows to ``rows_fetched``. With ``instrument``, ``sync`` (e.g.
    ``torch.cuda.synchronize``) runs between the forward and the D2H, and
    ``t_exec_s`` and ``t_d2h_s`` split the sum: an extra wait per batch,
    for attribution runs only.
    """

    def __init__(self, fwd: Callable, max_batch: int = 8,
                 window_ms: float = 3.0, adaptive: bool = False, *,
                 h2d: Callable[[np.ndarray], object] = _identity,
                 d2h: Callable[[object], np.ndarray] = _identity,
                 sync: Callable[[], None] = _no_sync,
                 instrument: bool = False):
        self._fwd, self._h2d, self._d2h, self._sync = fwd, h2d, d2h, sync
        self.instrument = instrument
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
        # per-stage seconds, written by the batcher thread only
        self.t_collect_s = 0.0
        self.t_h2d_s = 0.0
        self.t_exec_fetch_s = 0.0
        self.t_exec_s = 0.0   # instrument only
        self.t_d2h_s = 0.0    # instrument only
        self.rows_fetched = 0
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
        return self._wait(self._put(xs))

    def call(self, fn: Callable[[], object]):
        """Run ``fn()`` on the batcher thread, between device batches, and
        return its result. That thread runs every forward, and PyTorch
        keeps cuDNN and cuBLAS handles per thread: a warm-up forward made
        here is one the first request finds done, where one made on
        another thread leaves the handles to that request. Counts nothing
        in the batch counters."""
        return self._wait(self._put([_Call(fn)]))[0]

    def _put(self, xs) -> list:
        pending = []
        with self._lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            for x in xs:
                ev, slot = threading.Event(), {}
                self._q.put((x, ev, slot))
                pending.append((ev, slot))
        return pending

    @staticmethod
    def _wait(pending: list) -> list:
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
            if isinstance(first[0], _Call):
                _, ev, slot = first
                try:
                    slot["out"] = first[0].fn()
                except Exception as e:  # noqa: BLE001 - handed to the caller
                    slot["err"] = e
                ev.set()
                continue
            group = [first]
            shape = first[0].shape
            t_win0 = time.perf_counter()
            deadline = t_win0 + self.collect_window()
            while len(group) < self.max_batch:
                timeout = deadline - time.perf_counter()
                if timeout <= 0:
                    break
                try:
                    item = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if (item is not _STOP and not isinstance(item[0], _Call)
                        and item[0].shape == shape):
                    group.append(item)
                else:
                    pending = item
                    break
            self.t_collect_s += time.perf_counter() - t_win0
            try:
                t0 = time.perf_counter()
                dev = self._h2d(np.stack([g[0] for g in group]))
                t1 = time.perf_counter()
                dev_out = self._fwd(dev)
                if self.instrument:
                    self._sync()
                    t2 = time.perf_counter()
                    out = self._d2h(dev_out)
                    t3 = time.perf_counter()
                    self.t_exec_s += t2 - t1
                    self.t_d2h_s += t3 - t2
                else:
                    out = self._d2h(dev_out)
                    t3 = time.perf_counter()
            except Exception as e:  # noqa: BLE001 - handed to the callers
                for _, ev, slot in group:
                    slot["err"] = e
                    ev.set()
                continue
            batch_s = t3 - t1
            self.t_h2d_s += t1 - t0
            self.t_exec_fetch_s += batch_s
            self.rows_fetched += len(group)
            self._ema_exec_s = (batch_s if self._ema_exec_s == 0 else
                                0.7 * self._ema_exec_s + 0.3 * batch_s)
            self._last_fill = len(group)
            self.n_batches += 1
            self.n_items += len(group)
            for i, (_, ev, slot) in enumerate(group):
                slot["out"] = out[i]
                ev.set()


def load_generator_weights(path: str) -> dict:
    """The generator state_dict held by one of the port's torch checkpoint
    files (``training.checkpoint``), as the JAX ``serve.py`` reads its
    Orbax ones: a best file (a bare state_dict, or ``{"params": sd}``) or
    a rolling ``*_last`` full-state file, whose ``g`` gives its EMA
    weights where the run kept an EMA and its raw params otherwise."""
    tree = load_checkpoint(path)
    if "g" in tree and "params" not in tree:
        g = tree["g"]
        return {**g["params"], **(g.get("ema_params") or {})}
    if isinstance(tree.get("params"), dict):
        return tree["params"]
    return tree


class SRServer:
    """Serving core: uint8 HWC in, uint8 HWC out at ``scale`` times the size.

    Small images (padded by edge replication to a multiple of ``tile``) ride
    the micro-batcher whole; larger ones are cut into ``tile + 2*halo``
    windows (halo = the model's receptive-field radius,
    ``parallel.spatial.receptive_radius``, so the result equals the
    whole-image forward) that ride the same batcher. ToTensor and the
    255-quantization run on the device. ``architecture`` is a registry
    name (SRCNN, RESNET, AttentionSR, RRDB), or "auto" with a
    ``state_dict`` or a ``checkpoint`` file: the net is then built from the
    weights' keys and shapes (``models.model_for_params``). ``model``
    overrides the registry net (it must expose ``scale_factor``; its halo
    comes from its class or depth); ``state_dict`` (or the weights in
    ``checkpoint``, :func:`load_generator_weights`) loads with
    ``strict=True``; otherwise the weights are seeded from ``generator``
    (seed 0 when None). ``window_ms`` and ``adaptive_window`` set the
    micro-batcher's collect window (:class:`MicroBatcher`), with the JAX
    ``SRServer``'s defaults; ``instrument`` splits its execute and D2H
    times. ``tta`` serves the x8 self-ensemble (``ops.tta``) of every
    device batch. ``png_level`` is the zlib level of the HTTP front end's
    PNG responses.

    ``phase_tail`` (default on, as in the JAX server) runs the upsample
    tail of RESNET, AttentionSR and RRDB in phase space at LR resolution
    (``ops.subpixel_conv``): the same function and weights; SRCNN has no
    tail. ``quantize`` ("int8", "int8_dot") runs their body convs in
    dynamic int8 (``ops.quantize``); SRCNN refuses it. A ``model``
    override comes with its own flags. Under ``quantize`` tiling is exact
    only up to quantization error: the per-sample activation scales
    depend on a window's content, so the same pixel in two overlapping
    windows lands on slightly different int8 grids (the float paths stay
    exact).

    ``use_mesh`` serves over a mesh of local devices (JAX's data-sharded
    server): ``mesh``, by default every visible card (``make_mesh()``; on
    the CPU one CPU device), holds one replica of the model per device,
    ``max_batch`` is rounded up to a multiple of the device count, and
    each device always runs ``max_batch / n`` rows of every device batch
    (one shape per device, ROADMAP fault 3).
    """

    def __init__(self, architecture: str = "AttentionSR",
                 state_dict: dict | None = None, *,
                 checkpoint: str | None = None, scale: int = 4,
                 tile: int = 64, dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None,
                 model: nn.Module | None = None, max_batch: int = 8,
                 window_ms: float = 3.0, adaptive_window: bool = False,
                 tta: bool = False, png_level: int = 1,
                 instrument: bool = False, quantize: str = "",
                 phase_tail: bool = True, use_mesh: bool = False,
                 mesh: Mesh | None = None):
        if checkpoint:
            if state_dict is not None:
                raise ValueError("SRServer: give a state_dict or a "
                                 "checkpoint, not both")
            state_dict = load_generator_weights(checkpoint)
        self.device = torch.device(device)
        self.dtype = dtype
        self.tta = tta
        self.png_level = png_level
        override = model is not None
        if model is None and architecture == "auto":
            if state_dict is None:
                raise ValueError('SRServer: architecture="auto" needs a '
                                 "state_dict or a checkpoint")
            model = model_for_params(state_dict, scale_factor=scale,
                                     dtype=dtype, device=self.device,
                                     quantize=quantize, phase_tail=phase_tail)
            state_dict = None  # loaded
        elif model is None:
            model = get_model(architecture, scale_factor=scale, dtype=dtype,
                              device=self.device, generator=generator,
                              quantize=quantize, phase_tail=phase_tail)
        self.model = model.to(device=self.device, dtype=dtype,
                              memory_format=torch.channels_last).eval()
        # what the net runs (an override's own settings)
        self.quantize = getattr(self.model, "quantize", "")
        self.phase_tail = getattr(self.model, "phase_tail", False)
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        # an override is known by its class (or its depth), never by the
        # default name
        self.architecture = (architecture_of(self.model)
                             if override or architecture == "auto"
                             else architecture)
        self.scale = self.model.scale_factor
        self.tile = tile
        self.halo = receptive_radius(self.architecture, self.model)
        self.mesh = None
        if use_mesh:
            self.mesh = mesh or (make_mesh() if self.device.type == "cuda"
                                 else cpu_mesh(1))
            n = len(self.mesh.devices)
            max_batch = -(-max_batch // n) * n  # a multiple of the mesh
            self.replicas = replicate(self.model, self.mesh)
        sync = (functools.partial(torch.cuda.synchronize, self.device)
                if self.device.type == "cuda" else _no_sync)
        self.batcher = MicroBatcher(
            self.forward_u8, max_batch=max_batch, window_ms=window_ms,
            adaptive=adaptive_window, instrument=instrument,
            h2d=lambda stack: torch.from_numpy(stack).to(self.device),
            d2h=lambda y8: y8.cpu().numpy(), sync=sync)
        self.n_served = 0
        self._served_lock = threading.Lock()
        # host seconds of the front end's decode and encode (handler threads)
        self.t_decode_s = 0.0
        self.t_encode_s = 0.0

    def add_host_time(self, which: str, dt: float) -> None:
        """Add ``dt`` seconds to ``t_decode_s`` ("decode") or
        ``t_encode_s`` (anything else), from any thread."""
        with self._served_lock:
            if which == "decode":
                self.t_decode_s += dt
            else:
                self.t_encode_s += dt

    @torch.inference_mode()
    def forward_u8(self, x8: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 on the device -> (B, sH, sW, 3) uint8, B <=
        max_batch. The net always runs ``max_batch`` rows (zero rows fill
        the rest), under ``tta`` both of the ensemble's forwards
        ``4 * max_batch``: cuDNN picks its algorithm per shape, and in bf16
        two algorithms round differently, by several uint8 levels on random
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
        if self.mesh is not None:
            y = sharded_batch([functools.partial(self._net, m)
                               for m in self.replicas], x, self.mesh)
        else:
            y = self._net(self.model, x)
        # the clip and 255-quantization in the output's dtype, as the JAX
        # server's: a bfloat16 output is scaled and rounded in bfloat16,
        # where 255.5 rounds to 256, which XLA's conversion saturates
        y8 = (y[:n].clamp(0.0, 1.0) * 255.0 + 0.5).clamp(max=255.0).to(
            torch.uint8)
        return y8.permute(0, 2, 3, 1)

    def _net(self, model: nn.Module, x: torch.Tensor) -> torch.Tensor:
        return self_ensemble(model, x) if self.tta else model(x)

    def warmup(self, sizes=None) -> None:
        """Run one ``max_batch``-row forward per LR bucket before taking
        traffic (the JAX server compiles its programs here): cuDNN picks
        its algorithms and the allocator grows on a shape's first call,
        which would otherwise land on the first request of each bucket.
        Every device batch has ``max_batch`` rows, so one forward per
        bucket covers it. The forwards run on the batcher thread
        (:meth:`MicroBatcher.call`), whose per-thread cuDNN and cuBLAS
        handles traffic uses. ``sizes``: (h, w) padded LR buckets, by
        default the single-tile bucket and the tiled path's window.
        Touches no batcher counter."""
        if sizes is None:
            win = self.tile + 2 * self.halo
            sizes = [(self.tile, self.tile), (win, win)]

        def run():
            for h, w in sizes:
                self.forward_u8(torch.zeros(
                    (self.batcher.max_batch, h, w, 3), dtype=torch.uint8,
                    device=self.device))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        self.batcher.call(run)

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
