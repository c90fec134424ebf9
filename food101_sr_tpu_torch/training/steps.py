"""Train and eval step factories (counterpart of the supervised part of
``food101_sr_tpu/training/steps.py``).

A step takes the uint8 NHWC HR batch on the device and degrades it there
(``data.prepare_batch``); only uint8 crops cross from the host. The train
step updates the state in place and returns it with a dict of 0-d device
tensors, so nothing in it waits for the device: the diagnostics, the
non-finite guard and the optimizer update all run there. The eval step
and the forward take an optional parameter dict (the EMA, a loaded
checkpoint), applied with ``torch.func.functional_call`` so the live
parameters stay as they are. The GAN steps come with the GAN slice of the
port (ROADMAP item 6).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn
from torch.func import functional_call

from ..data.pipeline import prepare_batch
from ..metrics.metrics import psnr
from .diagnostics import grad_norm, layer_grad_ratio, update_ratio
from .state import SRTrainState


def loss_and_grads(model: nn.Module, loss_fn: Callable, scale: int,
                   hr_u8: torch.Tensor) -> tuple[torch.Tensor, list]:
    """Loss and raw gradients of one uint8 HR batch, the model in train
    mode: the gradients come in the order of ``model.parameters()`` (those
    that require a gradient); a parameter the loss does not reach gets
    zeros, as in JAX."""
    lr_img, hr = prepare_batch(hr_u8, scale)
    if not model.training:
        model.train()
    loss = loss_fn(model(lr_img), hr)
    params = [p for p in model.parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, params, materialize_grads=True)
    return loss.detach(), list(grads)


def _finite_guard(loss: torch.Tensor, gnorm: torch.Tensor) -> torch.Tensor:
    """True when the loss and the global gradient norm are finite (the
    norm is not finite iff a gradient is, or when it overflows)."""
    return torch.isfinite(loss) & torch.isfinite(gnorm)


@torch.no_grad()
def _finalize_update(state: SRTrainState, grads: list, loss: torch.Tensor,
                     first: str, last: str, ema_decay: float | None):
    """Diagnostics on the raw gradients, the non-finite guard, and the
    guarded update (``SRTrainState.apply_updates``)."""
    gnorm = grad_norm(grads)
    ok = _finite_guard(loss, gnorm)
    metrics = {
        "train_loss": loss,
        "dynamics/grad_norm": gnorm,
        "dynamics/layer_ratio": layer_grad_ratio(
            dict(zip(state.names, grads)), first, last),
        "dynamics/update_ratio": update_ratio(state.params, grads,
                                              state.learning_rate),
        "nonfinite_steps": 1.0 - ok.float(),
    }
    state.apply_updates(grads, ok, ema_decay)
    metrics["nonfinite_total"] = state.skipped.clone()
    return state, metrics


def make_train_step(model: nn.Module, loss_fn: Callable, scale: int,
                    first: str, last: str, ema_decay: float | None = None):
    """Supervised step ``step(state, hr_u8) -> (state, metrics)``: loss,
    gradients, diagnostics, non-finite guard and optimizer update (and the
    params EMA when ``ema_decay`` is set and the state keeps one).
    ``state`` must be built over ``model``."""

    def train_step(state: SRTrainState, hr_u8: torch.Tensor):
        if state.model is not model:
            raise ValueError("train_step: the state holds another model")
        loss, grads = loss_and_grads(model, loss_fn, scale, hr_u8)
        return _finalize_update(state, grads, loss, first, last, ema_decay)

    return train_step


# ---------------------------------------------------------------------------
# Gradient accumulation (--grad_accum k): each update is computed from k
# sequential microbatches of batch_size/k. The loader keys sample order and
# augmentation by global position, so the k microbatches hold the samples
# of the unsplit batch, and the losses are batch means, so the averaged
# microbatch gradients equal the big-batch gradient.
# ---------------------------------------------------------------------------

def make_grad_step(model: nn.Module, loss_fn: Callable, scale: int):
    """Gradient-only microbatch step ``grad_step(hr_u8) -> (loss, grads)``
    at the current parameters; no update (``make_accum_apply`` applies the
    group once)."""

    def grad_step(hr_u8: torch.Tensor):
        return loss_and_grads(model, loss_fn, scale, hr_u8)

    return grad_step


def make_accum_apply(accum: int, first: str, last: str,
                     ema_decay: float | None = None):
    """``apply(state, grads_sum, loss_sum) -> (state, metrics)``: one
    guarded update from ``accum`` summed microbatch gradients. The average
    (sum / accum) is what the guard sees, so one NaN microbatch skips the
    whole group and leaves the state as it was."""
    inv = 1.0 / float(accum)

    @torch.no_grad()
    def apply_step(state: SRTrainState, grads_sum: list,
                   loss_sum: torch.Tensor):
        grads = torch._foreach_mul(grads_sum, inv)
        return _finalize_update(state, grads, loss_sum * inv, first, last,
                                ema_decay)

    return apply_step


def _apply(model: nn.Module, x: torch.Tensor,
           params: dict[str, torch.Tensor] | None) -> torch.Tensor:
    """``model(x)``, or with ``params`` in place of the module's own
    tensors of those names."""
    return model(x) if params is None else functional_call(model, params,
                                                           (x,))


def make_eval_step(model: nn.Module, loss_fn: Callable, scale: int):
    """Validation step ``eval_step(hr_u8, params=None) -> {"psnr",
    "val_loss"}``: batch PSNR on clamped images and the raw loss, the
    model in eval mode, on ``params`` (by name) when given."""

    @torch.no_grad()
    def eval_step(hr_u8: torch.Tensor,
                  params: dict[str, torch.Tensor] | None = None
                  ) -> dict[str, torch.Tensor]:
        lr_img, hr = prepare_batch(hr_u8, scale)
        sr = _apply(model.eval(), lr_img, params)
        return {"psnr": psnr(sr.clamp(0.0, 1.0), hr.clamp(0.0, 1.0)),
                "val_loss": loss_fn(sr, hr)}

    return eval_step


def make_forward(model: nn.Module):
    """``forward(lr_img, params=None) -> sr``, the model in eval mode, no
    gradients, on ``params`` (by name) when given."""

    @torch.no_grad()
    def forward(lr_img: torch.Tensor,
                params: dict[str, torch.Tensor] | None = None
                ) -> torch.Tensor:
        return _apply(model.eval(), lr_img, params)

    return forward
