"""Checkpoints as torch files (counterpart of
``food101_sr_tpu/training/checkpoint.py``, which writes Orbax).

Two kinds, as in the JAX package:

* the best checkpoint (``save_checkpoint`` of a ``model.state_dict()``):
  the weights alone, in the reference's ``.pth`` key layout, so it loads
  with ``strict=True`` into a registry model (and is what
  ``convert.params_from_jax`` makes of a JAX params tree);
* the full-state checkpoint (``save_train_checkpoint``) for ``--resume``:
  ``{"g": SRTrainState.state_dict(), "host": {"epoch", "batch",
  "scheduler", "stopper"}}``, and for a GAN run ``"d"``, the
  discriminator's state (its ``params`` hold its buffers: spectral-norm
  vectors and BatchNorm running stats). ``batch`` is 0 for the per-epoch
  rolling save and the number of microbatches consumed for a mid-epoch
  preemption save, where ``--resume`` re-enters the epoch.

``load_checkpoint`` also reads the port's packed weights files
(``training.packed``, ``.f101w``: its committed winners), by their magic:
a state_dict, float tensors as float32. Training checkpoints stay torch
files.

Files are written to a temporary name and renamed, so a crash mid-write
leaves the previous checkpoint whole. In a multi-process run the state is
the same on every rank, so the loop saves from rank 0 alone (no two
writers of one file), holds the other ranks at a barrier before they read
the best checkpoint, and every rank resumes from the same file. Loading uses
``torch.load(weights_only=True)``: tensors, numbers, strings and
containers only.
"""
from __future__ import annotations

import os
from typing import Any

import torch

from .packed import is_packed, unpack_state_dict


def save_checkpoint(tree: Any, path: str) -> str:
    """Save ``tree`` (tensors in nested dicts) at ``path``; returns the
    absolute path."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, device: str | torch.device = "cpu") -> Any:
    """The tree saved at ``path``, its tensors on ``device``: a torch file,
    or a packed weights file (its state_dict; ``PackError`` where it
    cannot be decoded)."""
    path = os.path.abspath(path)
    if is_packed(path):
        return {k: v.to(device) for k, v in unpack_state_dict(path).items()}
    return torch.load(path, map_location=device, weights_only=True)


def save_train_checkpoint(state, epoch: int, scheduler, stopper, path: str,
                          d_state=None, batch: int = 0) -> str:
    """Full-state checkpoint for preemption resume: the train state (and
    the discriminator's, when given) and the host's control state (epoch,
    microbatches of it consumed, plateau scheduler, early stopper)."""
    tree = {
        "g": state.state_dict(),
        "host": {"epoch": int(epoch), "batch": int(batch),
                 "scheduler": scheduler.state_dict(),
                 "stopper": stopper.state_dict()},
    }
    if d_state is not None:
        tree["d"] = d_state.state_dict()
    return save_checkpoint(tree, path)


def load_train_checkpoint(path: str, state, scheduler, stopper,
                          d_state=None):
    """Restore a ``save_train_checkpoint`` file into a freshly built state
    (same model and optimizer configuration), and its ``d`` into
    ``d_state`` when given, in place, onto the states' device. Returns
    (state, start_epoch, start_batch): resume at epoch ``start_epoch``,
    skipping its first ``start_batch`` microbatches."""
    tree = load_checkpoint(path, state.device)
    state.load_state_dict(_reconcile_optional(tree["g"], state))
    if d_state is not None:
        if "d" not in tree:
            raise ValueError(f"{path} holds no discriminator state (not a "
                             "GAN run's checkpoint)")
        d_state.load_state_dict(_reconcile_optional(tree["d"], d_state))
    scheduler.load_state_dict(tree["host"]["scheduler"])
    stopper.load_state_dict(tree["host"]["stopper"])
    batch = int(tree["host"].get("batch", 0))
    epoch = int(tree["host"]["epoch"])
    # batch 0: the epoch completed -> start the next one. batch > 0: the
    # epoch was preempted mid-flight -> re-enter it at that batch.
    return state, (epoch if batch else epoch + 1), batch


def _reconcile_optional(g: dict, state) -> dict:
    """Optional-state drift between the checkpoint and the fresh state: a
    resume with the EMA switched on seeds it from the restored params, one
    with it switched off drops it, and a checkpoint without ``skipped``
    restarts the counter at 0."""
    g = dict(g)
    if state.ema is None:
        g.pop("ema_params", None)
    elif "ema_params" not in g:
        g["ema_params"] = {k: g["params"][k].clone() for k in state.names}
    if "skipped" not in g:
        g["skipped"] = torch.zeros((), dtype=torch.int32)
    return g


def warm_start_params(init: dict[str, torch.Tensor],
                      loaded: dict[str, torch.Tensor]) -> dict:
    """strict=False-style warm start of a state_dict: take the loaded
    tensor where the key and the shape match the fresh ``init``, keep the
    init elsewhere (and ignore loaded keys the model does not have)."""
    merged = {}
    for k, v in init.items():
        lv = loaded.get(k)
        merged[k] = lv if (isinstance(lv, torch.Tensor)
                           and lv.shape == v.shape) else v
    return merged
