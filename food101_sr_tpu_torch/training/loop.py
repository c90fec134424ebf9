"""The training runtime (counterpart of ``food101_sr_tpu/training/loop.py``):
epoch loop, validation, plateau LR, early stop, best and rolling
checkpoints, resume, preemption, final test evaluation; supervised or,
with ``loss_function="gan"``, the relativistic GAN (a D step every
``d_update_every`` batches, a G step every batch).

The host owns control flow (epochs, logging cadence, plateau decisions,
early stop, the D cadence); the steps' math, their diagnostics and their
non-finite guards stay on the device, and metric tensors become Python
floats only on log boundaries. ``train(config, device="cuda")`` runs on
the card and raises without one; the tests pass ``device="cpu"``.

Each epoch's record also carries the input and step times: the train
part's wall time and images/s (loader included), the step alone (CUDA
events around each step on the card; the host clock on the CPU, where a
step runs synchronously), the consumer's wait on the loader's queue per
step and the producer's time per batch.
"""
from __future__ import annotations

import os
import time
from typing import Any, Mapping

import numpy as np
import torch

try:  # tqdm bars around the hot loops, where tqdm is installed
    from tqdm import tqdm
except ImportError:  # pragma: no cover
    def tqdm(it, **_kw):
        return it

from ..data import Food101Source, SRDataLoader, SyntheticSource, prepare_batch
from ..data import subset_indices, train_val_split
from ..losses import get_loss_function
from ..metrics import MetricsCalculator
from ..models import Discriminator, build_model, get_model
from ..utils import RunLogger
from .checkpoint import (load_checkpoint, load_train_checkpoint,
                         save_checkpoint, save_train_checkpoint,
                         warm_start_params)
from .diagnostics import FIRST_LAST
from .preempt import PreemptionGuard
from .schedule import EarlyStopping, ReduceLROnPlateau
from .state import SRTrainState, make_adam
from .steps import (make_accum_apply, make_eval_step, make_forward,
                    make_gan_d_step, make_gan_g_step, make_grad_step,
                    make_train_step, snapshot_buffers)

# The JAX package's keys and defaults (``food101_sr_tpu/training/loop.py``).
# Values the port does not run yet raise in ``check_ported``.
DEFAULTS: dict[str, Any] = {
    "architecture": "SRCNN",
    "batch_size": 16,
    "lr": 4e-4,
    "epochs": 10,
    "loss_function": "nlpd",
    "subset": 1.0,
    "pretrained_weights": "",
    "patience": 5,
    "save_name": "model_best",
    "dataset": "food101",       # food101 | synthetic
    "data_root": "./data",
    "crop_size": 200,
    "scale_factor": 4,
    "dtype": "float32",
    "seed": 0,
    "weights_dir": "weights",
    "log_every": 100,
    "synthetic_size": 512,
    "d_update_every": 5,
    "use_wandb": None,
    "run_name": None,
    "resume": "",               # path to a *_last.pth full-state checkpoint
    "profile_steps": 0,         # >0: torch.profiler trace of that many steps
    "profile_dir": "runs/profile",
    "ema": 0.0,                 # >0: EMA decay of the params; the EMA is
                                # validated and saved as the best checkpoint
    "grad_accum": 1,            # k>1: each update = k sequential microbatches
                                # of batch_size/k
    "quantize": "",
    "phase_tail": True,         # accepted; the port runs the materialized
                                # tail, the same function, until
                                # ops/subpixel_conv.py is ported (item 4)
    "cache_device": False,
    "cache_canvas": 0,
    "cache_budget_gb": 4.0,
    "cache_host": "",
    "cache_host_budget_gb": 64.0,
    "cache_host_reuse": 0,
    "cache_window": 0,
    "preempt_after_updates": 0,  # >0: a graceful preemption after that many
                                 # updates, the path a SIGTERM takes
    "coordinator": "",
    "num_processes": 0,
    "process_id": -1,
    "distributed": "",
}

# key -> (the values the port does not run, or None for "any value but
# the default"; the ROADMAP item that brings it)
_NOT_PORTED = {
    "dtype": (("bfloat16",), "ROADMAP item 9c (bf16 training)"),
    "quantize": (None, "ROADMAP item 8 (quantization and QAT)"),
    **{k: (None, "ROADMAP item 9b (the device and canvas caches)")
       for k in ("cache_device", "cache_canvas", "cache_budget_gb",
                 "cache_host", "cache_host_budget_gb", "cache_host_reuse",
                 "cache_window")},
    **{k: (None, "ROADMAP item 10 (multi-GPU)")
       for k in ("coordinator", "num_processes", "process_id",
                 "distributed")},
}


def check_ported(cfg: Mapping[str, Any]) -> None:
    """Raise NotImplementedError for a setting the port does not run yet,
    naming the ROADMAP item that brings it: nothing is silently ignored."""
    for key, (values, item) in _NOT_PORTED.items():
        v = cfg.get(key, DEFAULTS[key])
        if (v in values) if values is not None else v != DEFAULTS[key]:
            raise NotImplementedError(
                f"{key}={v!r} is not ported to PyTorch yet: {item}")


def _build_sources(cfg):
    if cfg["dataset"] == "synthetic":
        n = int(cfg["synthetic_size"])
        return (SyntheticSource(n=n, seed=cfg["seed"]),
                SyntheticSource(n=max(n // 4, 8), seed=cfg["seed"] + 100))
    return (Food101Source(cfg["data_root"], "train"),
            Food101Source(cfg["data_root"], "test"))


def _noise_generator(seed: int, epoch: int, batch_idx: int,
                    device: torch.device) -> torch.Generator:
    """The D step's instance-noise generator, keyed by (seed, epoch,
    batch), so that a resumed run replays the same noise."""
    key = np.random.SeedSequence([seed, epoch, batch_idx]).generate_state(
        2, np.uint64)[0]
    return torch.Generator(device).manual_seed(int(key >> np.uint64(1)))


def _mean(values):
    return float(np.mean(values)) if values else 0.0


class _StepClock:
    """Time of the train steps alone over one epoch: CUDA events around
    each step on the card, read once at the epoch's end; the host clock on
    the CPU, where a step runs synchronously."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.pairs: list = []
        self.host_s = 0.0
        self.n = 0

    def start(self):
        if self.cuda:
            self._ev = torch.cuda.Event(enable_timing=True)
            self._ev.record()
        else:
            self._t = time.perf_counter()

    def stop(self):
        self.n += 1
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.pairs.append((self._ev, end))
        else:
            self.host_s += time.perf_counter() - self._t

    def mean_ms(self) -> float:
        if not self.n:
            return 0.0
        if self.cuda:
            self.pairs[-1][1].synchronize()
            return sum(a.elapsed_time(b) for a, b in self.pairs) / self.n
        return self.host_s / self.n * 1e3


def train(config: Mapping[str, Any] | None = None,
          device: str | torch.device = "cuda") -> dict:
    """Train with ``config`` (``DEFAULTS`` fills the rest) on ``device``.
    Returns the final test ``{psnr, ssim, lpips, nlpd}`` of the best
    checkpoint and the best ``val_psnr``; a preempted run returns
    ``{"preempted": True, "val_psnr"}``."""
    cfg = {**DEFAULTS, **(config or {})}
    check_ported(cfg)
    device = torch.device(device)
    torch.empty(0, device=device)  # raises without the device; no fallback
    with RunLogger(cfg, name=cfg.get("run_name"),
                   use_wandb=cfg.get("use_wandb")) as logger:
        cfg = {**DEFAULTS, **logger.config}  # sweep agents may override keys
        return _train_impl(cfg, logger, device)


def _train_impl(cfg: dict, logger: RunLogger, device: torch.device) -> dict:
    scale = int(cfg["scale_factor"])
    crop = int(cfg["crop_size"])
    is_gan = cfg["loss_function"] == "gan"
    print(f"Running on {device} "
          f"({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'host'})"
          f" | Arch: {cfg['architecture']}")

    # --- data -----------------------------------------------------------
    train_source, test_source = _build_sources(cfg)
    idx = subset_indices(len(train_source), float(cfg["subset"]), cfg["seed"])
    if float(cfg["subset"]) < 1.0:
        print(f"PROXY MODE: Training on {len(idx)} images.")
    train_idx, val_idx = train_val_split(idx, 0.1, cfg["seed"] + 1)
    test_idx = subset_indices(len(test_source), float(cfg["subset"]), cfg["seed"])
    print(f"Dataset: Train={len(train_idx)} | Val={len(val_idx)} | "
          f"Test={len(test_idx)}")

    batch = int(cfg["batch_size"])
    accum = max(int(cfg.get("grad_accum", 1) or 1), 1)
    if accum > 1 and is_gan:
        raise ValueError(
            "--grad_accum applies to supervised losses only (the GAN "
            "branch alternates two optimizers on the reference's 5-step "
            "cadence; accumulate there by lowering d_update_every "
            "instead)")
    if batch % accum:
        raise ValueError(
            f"batch_size={batch} must be divisible by grad_accum={accum}")
    micro = batch // accum

    def _loader(source, indices, train):
        # drop-remainder loaders; the eval batch is clamped so that a tiny
        # subset still fills one batch. The train loader yields
        # microbatches (batch / grad_accum), position-keyed, so k of them
        # hold exactly the samples of the unsplit batch.
        b = micro if train else min(batch, max(len(indices), 1))
        return SRDataLoader(source, indices, crop_size=crop, batch_size=b,
                            train=train, seed=cfg["seed"], device=device)

    train_loader = _loader(train_source, train_idx, True)
    val_loader = _loader(train_source, val_idx, False)
    test_loader = _loader(test_source, test_idx, False)
    for name, loader in (("train", train_loader), ("val", val_loader),
                         ("test", test_loader)):
        if len(loader) == 0:
            raise ValueError(
                f"{name} loader yields zero batches: {len(loader.indices)} "
                f"samples can't fill a batch of {loader.batch_size}. "
                f"Increase the dataset/subset or shrink batch_size.")
    if accum > 1 and len(train_loader) < accum:
        # without this, every microbatch hits the mid-group `continue` and
        # the run "succeeds" with zero optimizer updates ever applied
        raise ValueError(
            f"train loader yields {len(train_loader)} microbatches per epoch "
            f"but --grad_accum {accum} needs {accum} per update; no update "
            f"would ever run. Increase the dataset/subset or shrink "
            f"batch_size/grad_accum.")

    # --- model & state ----------------------------------------------------
    model = get_model(cfg["architecture"], scale_factor=scale, device=device,
                      generator=torch.Generator().manual_seed(cfg["seed"]))
    if cfg["pretrained_weights"]:
        loaded = load_checkpoint(cfg["pretrained_weights"], device)
        model.load_state_dict(warm_start_params(
            model.state_dict(), loaded.get("params", loaded)))

    ema_decay = float(cfg["ema"]) or None
    lr = float(cfg["lr"])
    state = SRTrainState.create(
        model, make_adam(lr, clip_norm=1.0 if is_gan else None),
        ema=ema_decay is not None)
    first, last = FIRST_LAST[cfg["architecture"]]
    # a GAN run validates (and plateaus) on the MAE
    criterion = get_loss_function("mae" if is_gan else cfg["loss_function"],
                                  weights_dir=cfg["weights_dir"],
                                  device=device)
    train_step = make_train_step(model, criterion, scale, first, last,
                                 ema_decay=ema_decay)
    d_state = None
    if is_gan:
        d_model = build_model(
            Discriminator, device=device,
            generator=torch.Generator().manual_seed(cfg["seed"] + 2))
        # the plateau schedule sets G's learning rate only
        d_state = SRTrainState.create(d_model, make_adam(lr * 0.1))
        percep = get_loss_function("perceptual",
                                   weights_dir=cfg["weights_dir"],
                                   device=device)
        d_step = make_gan_d_step(model, d_model, scale)
        g_gan_step = make_gan_g_step(model, d_model, percep, scale, first,
                                     last, ema_decay=ema_decay)
        d_every = int(cfg["d_update_every"])
    if accum > 1:
        grad_step = make_grad_step(model, criterion, scale)
        accum_apply = make_accum_apply(accum, first, last,
                                       ema_decay=ema_decay)
    eval_step = make_eval_step(model, criterion, scale)
    forward = make_forward(model)
    metrics_calc = MetricsCalculator(device=device,
                                     weights_dir=cfg["weights_dir"])

    scheduler = ReduceLROnPlateau(float(cfg["lr"]), mode="max", factor=0.5,
                                  patience=2)
    stopper = EarlyStopping(patience=int(cfg["patience"]))
    ckpt_path = os.path.join(cfg["weights_dir"], f"{cfg['save_name']}_best.pth")
    last_path = os.path.join(cfg["weights_dir"], f"{cfg['save_name']}_last.pth")

    # --- preemption resume (full state incl. optimizer + host control) ----
    start_epoch, start_batch = 0, 0
    if cfg["resume"]:
        state, start_epoch, start_batch = load_train_checkpoint(
            cfg["resume"], state, scheduler, stopper, d_state)
        if start_batch % accum:
            raise ValueError(
                f"checkpoint resumes mid-epoch at microbatch {start_batch}, "
                f"not a multiple of --grad_accum {accum}: it was written "
                f"under a different accumulation grouping")
        print(f"Resumed from {cfg['resume']} at epoch {start_epoch}"
              + (f" batch {start_batch}" if start_batch else "")
              + f" (step {int(state.step)}, lr {scheduler.lr})")
    state.set_learning_rate(scheduler.lr)

    # --- epoch loop --------------------------------------------------------
    # SIGTERM -> flag -> full-state save at the next update boundary and a
    # clean exit; --resume re-enters the epoch at that exact batch
    guard = PreemptionGuard()
    preempted = False
    updates_done = 0
    preempt_after = int(cfg.get("preempt_after_updates") or 0)
    with guard:
        for epoch in range(start_epoch, int(cfg["epochs"])):
            skip = start_batch if epoch == start_epoch else 0
            train_loader.set_epoch(epoch, start_batch=skip)  # exact replay
            bar = tqdm(train_loader, total=len(train_loader) - skip,
                       desc=f"Epoch {epoch + 1}/{cfg['epochs']}", leave=False)
            profile_steps = (int(cfg["profile_steps"])
                             if epoch == start_epoch else 0)
            profiler = None
            # a window of profile_steps updates in the first epoch, after
            # the first update (or group) has run once
            trace_start = skip + (1 if accum == 1 else accum)
            trace_len = profile_steps * accum  # microbatches per update
            if profile_steps and trace_start >= len(train_loader):
                print(f"WARNING: epoch has {len(train_loader)} microbatches "
                      f"<= trace start {trace_start}; the trace includes "
                      f"the first steps")
                trace_start = skip
            d_metrics = {}
            clock = _StepClock(device)
            t_epoch = time.perf_counter()
            for batch_idx, hr_u8 in enumerate(bar, start=skip):
                if profile_steps and batch_idx == trace_start:
                    profiler = _start_profiler(device)
                if profiler is not None and batch_idx == trace_start + trace_len:
                    _stop_profiler(profiler, cfg["profile_dir"], device)
                    profiler = None
                clock.start()
                if is_gan:
                    if batch_idx % d_every == 0:
                        d_state, d_metrics = d_step(
                            state, d_state, hr_u8,
                            _noise_generator(cfg["seed"] + 3, epoch,
                                            batch_idx, device))
                    state, d_state, metrics = g_gan_step(state, d_state,
                                                         hr_u8)
                    logical_idx = batch_idx
                elif accum == 1:
                    state, metrics = train_step(state, hr_u8)
                    logical_idx = batch_idx
                else:
                    # k loader microbatches -> one guarded update; a
                    # trailing partial group at epoch end is dropped
                    if batch_idx % accum == 0:
                        grads_sum = loss_sum = None
                        # the group's guard puts the buffers back to here
                        snap = snapshot_buffers(model)
                    loss_i, g_i = grad_step(hr_u8)
                    if grads_sum is None:
                        grads_sum, loss_sum = g_i, loss_i
                    else:
                        torch._foreach_add_(grads_sum, g_i)
                        loss_sum = loss_sum + loss_i
                    if batch_idx % accum != accum - 1:
                        clock.stop()
                        continue  # mid-group: no update, no metrics to log
                    state, metrics = accum_apply(state, grads_sum, loss_sum,
                                                 snap)
                    grads_sum = None
                    logical_idx = batch_idx // accum
                clock.stop()

                if logical_idx % int(cfg["log_every"]) == 0:
                    log_data = {k: float(v) for k, v in metrics.items()}
                    log_data.update({k: float(v)
                                     for k, v in d_metrics.items()})
                    logger.log(log_data)
                    if (log_data.get("nonfinite_steps", 0)
                            or log_data.get("nonfinite_steps_D", 0)):
                        print(f"WARNING: non-finite loss/grads at epoch "
                              f"{epoch} update {logical_idx}; update skipped "
                              f"(state kept)")
                # graceful preemption, only at update boundaries
                updates_done += 1
                if preempt_after and updates_done >= preempt_after:
                    guard.request()
                if guard.poll():
                    preempted = True
                    break
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            train_s = time.perf_counter() - t_epoch
            if profiler is not None:  # epoch shorter than the trace window
                _stop_profiler(profiler, cfg["profile_dir"], device)
            if preempted:
                save_train_checkpoint(state, epoch, scheduler, stopper,
                                      last_path, d_state=d_state,
                                      batch=batch_idx + 1)
                print(f"Preemption: full state saved mid-epoch {epoch} after "
                      f"batch {batch_idx} -> {last_path}; continue with "
                      f"--resume {last_path}")
                break

            # --- validation -------------------------------------------------
            # with --ema, validation (and so the plateau, early-stop and
            # best-checkpoint decisions) runs on the EMA weights
            eval_params = state.ema_params()
            psnrs, losses = [], []
            for hr_u8 in val_loader:
                out = eval_step(hr_u8, eval_params)
                psnrs.append(float(out["psnr"]))
                losses.append(float(out["val_loss"]))
            avg_psnr, avg_val_loss = _mean(psnrs), _mean(losses)

            new_lr = scheduler.step(avg_psnr)
            state.set_learning_rate(new_lr)
            print(f"   -> Val PSNR: {avg_psnr:.2f} | Val Loss: "
                  f"{avg_val_loss:.4f} | LR: {new_lr}")
            n_skipped = int(state.skipped)  # exact cumulative
            if n_skipped:
                print(f"WARNING: {n_skipped} update(s) skipped so far by the "
                      f"non-finite guard")
            n_steps = train_loader.batches
            timing = {
                "time/train_s": train_s,
                "time/images_per_s": n_steps * micro / train_s,
                "time/step_ms": clock.mean_ms(),
                "time/loader_wait_ms": train_loader.wait_s / max(n_steps, 1) * 1e3,
                "time/loader_produce_ms": train_loader.produce_s / max(n_steps, 1) * 1e3,
            }
            print("   -> " + " | ".join(f"{k[5:]} {v:.3f}"
                                        for k, v in timing.items()))
            logger.log({"epoch": epoch, "val_psnr": avg_psnr,
                        "val_loss": avg_val_loss, "lr": new_lr,
                        "nonfinite_total": n_skipped, **timing})

            if stopper.update(avg_psnr):
                save_checkpoint({**model.state_dict(), **(eval_params or {})},
                                ckpt_path)
                logger.save(ckpt_path)
            # rolling full-state checkpoint for preemption resume (--resume)
            save_train_checkpoint(state, epoch, scheduler, stopper, last_path,
                                  d_state=d_state)
            if stopper.should_stop:
                print("Early stopping triggered")
                break

    if preempted:
        # the grace window is for saving, not for a full test sweep; the
        # resumed run finishes the epoch and evaluates as usual
        logger.log({"preempted": 1})
        return {"preempted": True,
                "val_psnr": stopper.best if np.isfinite(stopper.best) else 0.0}

    # --- final test eval -----------------------------------------------------
    print("\nRunning Final Test Set Evaluation...")
    best = (load_checkpoint(ckpt_path, device) if os.path.exists(ckpt_path)
            else None)  # None: zero-epoch runs evaluate the live weights
    test_metrics = {"psnr": [], "ssim": [], "lpips": [], "nlpd": []}
    for hr_u8 in tqdm(test_loader, total=len(test_loader),
                      desc="Testing", leave=False):
        lr_img, hr = prepare_batch(hr_u8, scale)
        sr = forward(lr_img, best)
        # the calculator takes NHWC, as the JAX package's does
        batch_res = metrics_calc.compute(sr.permute(0, 2, 3, 1),
                                         hr.permute(0, 2, 3, 1))
        for k in test_metrics:
            test_metrics[k].append(batch_res[k])
    final = {k: _mean(v) for k, v in test_metrics.items()}
    print(f"Final Test Results: {final}")
    logger.log({f"test_{k}": v for k, v in final.items()})
    # the best validation PSNR (the sweep objective) rides along so model
    # selection never touches the test metrics; 0 for zero-epoch runs
    final["val_psnr"] = stopper.best if np.isfinite(stopper.best) else 0.0
    return final


def _start_profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profiler(prof, profile_dir: str, device: torch.device) -> None:
    """Stop the trace once the device has run what was launched in it, and
    write it as ``trace.json`` (Chrome trace format) under ``profile_dir``."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"Wrote device trace to {path}")
