"""Train and eval step factories (counterpart of the supervised part of
``food101_sr_tpu/training/steps.py``).

A step takes the uint8 NHWC HR batch on the device and degrades it there
(``data.prepare_batch``); only uint8 crops cross from the host. The train
step updates the state in place and returns it with a dict of 0-d device
tensors, so nothing in it waits for the device: the diagnostics, the
non-finite guard and the optimizer update all run there. The eval step
and the forward take an optional parameter dict (the EMA, a loaded
checkpoint), applied with ``torch.func.functional_call`` so the live
parameters stay as they are. Every step keeps the buffers that its
train-mode forwards change in place under the same guard: the
generator's (ResNetSR's BatchNorm running stats) and, in the GAN steps
(``make_gan_d_step``, ``make_gan_g_step``), the discriminator's
(spectral-norm vectors, BatchNorm running stats).

In a process group of more than one rank each rank steps on its share of
the global batch and the steps agree by explicit collectives, where JAX's
mesh lets XLA insert them: the gradients and the loss are averaged over
the ranks (one all-reduce of a flat buffer per dtype) before the
diagnostics, the guard and the update, which then see the same values on
every rank; batch means that the losses take inside (the relativistic
GAN's logit means) and BatchNorm's statistics are global-batch ones; the
eval metrics are averaged. A world of 1 runs none of it.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..data.pipeline import prepare_batch
from ..losses import mae_loss, tv_loss
from ..metrics.metrics import psnr
from ..models.layers import chained_power_iterations
from ..parallel.distributed import all_reduce_mean_, global_mean, world_size
from .diagnostics import grad_norm, layer_grad_ratio, update_ratio
from .state import SRTrainState


def snapshot_buffers(model: nn.Module) -> tuple[list, list]:
    """The module's buffers and copies of them, for the guard: a skipped
    step puts the copies back."""
    bufs = list(model.buffers())
    return bufs, [b.clone() for b in bufs]


@torch.no_grad()
def _keep_if(ok: torch.Tensor, snapshot: tuple[list, list]) -> None:
    """Where ``ok`` is False, put the snapshot's values back."""
    for b, old in zip(*snapshot):
        b.copy_(torch.where(ok, b, old))


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
                     first: str, last: str, ema_decay: float | None,
                     snapshot: tuple[list, list] | None = None):
    """The gradients and loss averaged over the ranks, then diagnostics on
    the raw gradients, the non-finite guard, and the guarded update
    (``SRTrainState.apply_updates``); a skipped update also puts back the
    model's buffers from ``snapshot``, taken before the step's
    forwards."""
    all_reduce_mean_([*grads, loss])
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
    if snapshot is not None:
        _keep_if(ok, snapshot)
    metrics["nonfinite_total"] = state.skipped.clone()
    return state, metrics


def make_train_step(model: nn.Module, loss_fn: Callable, scale: int,
                    first: str, last: str, ema_decay: float | None = None):
    """Supervised step ``step(state, hr_u8) -> (state, metrics)``: loss,
    gradients, diagnostics, non-finite guard and optimizer update (and the
    params EMA when ``ema_decay`` is set and the state keeps one); a
    skipped update leaves the model's buffers as they were too.
    ``state`` must be built over ``model``."""

    def train_step(state: SRTrainState, hr_u8: torch.Tensor):
        if state.model is not model:
            raise ValueError("train_step: the state holds another model")
        snap = snapshot_buffers(model)
        loss, grads = loss_and_grads(model, loss_fn, scale, hr_u8)
        return _finalize_update(state, grads, loss, first, last, ema_decay,
                                snap)

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
    group once). The model's buffers (BatchNorm running stats) advance
    through the group's microbatches in turn, as JAX threads its
    collections."""

    def grad_step(hr_u8: torch.Tensor):
        return loss_and_grads(model, loss_fn, scale, hr_u8)

    return grad_step


def make_accum_apply(accum: int, first: str, last: str,
                     ema_decay: float | None = None):
    """``apply(state, grads_sum, loss_sum, snapshot=None) -> (state,
    metrics)``: one guarded update from ``accum`` summed microbatch
    gradients. The average (sum / accum) is what the guard sees, so one
    NaN microbatch skips the whole group and leaves the state as it was,
    the model's buffers too when ``snapshot`` (``snapshot_buffers``, taken
    before the group's first microbatch) is given."""
    inv = 1.0 / float(accum)

    @torch.no_grad()
    def apply_step(state: SRTrainState, grads_sum: list,
                   loss_sum: torch.Tensor,
                   snapshot: tuple[list, list] | None = None):
        grads = torch._foreach_mul(grads_sum, inv)
        return _finalize_update(state, grads, loss_sum * inv, first, last,
                                ema_decay, snapshot)

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
        loss = loss_fn(sr, hr)
        sr_c, hr_c = sr.clamp(0.0, 1.0), hr.clamp(0.0, 1.0)
        if world_size() == 1:
            return {"psnr": psnr(sr_c, hr_c), "val_loss": loss}
        # the global batch's PSNR: of the mean squared error over ranks
        mse = torch.mean((sr_c - hr_c) ** 2)
        all_reduce_mean_([mse, loss])
        return {"psnr": 10.0 * torch.log10(1.0 / mse), "val_loss": loss}

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


# ---------------------------------------------------------------------------
# GAN branch (the reference's relativistic GAN): D and G steps. The loop
# runs the D step every ``d_update_every`` batches and the G step on every
# batch.
# ---------------------------------------------------------------------------

def add_noise(img: torch.Tensor, sigma: float = 0.15,
              noise: torch.Tensor | torch.Generator | None = None
              ) -> torch.Tensor:
    """Instance noise ``img + sigma * N(0, 1)``: the draws are ``noise``
    when it is a tensor of ``img``'s shape, else drawn from the generator
    ``noise`` on ``img``'s device."""
    if sigma <= 0:
        return img
    if not isinstance(noise, torch.Tensor):
        noise = torch.randn(img.shape, generator=noise, device=img.device,
                            dtype=img.dtype)
    return img + sigma * noise


def _bce(logits: torch.Tensor, label: float) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(
        logits, torch.full_like(logits, label))


def make_gan_d_step(g_model: nn.Module, d_model: nn.Module, scale: int,
                    noise_sigma: float = 0.2):
    """Discriminator step ``d_step(g_state, d_state, hr_u8, noise) ->
    (d_state, metrics)``: relativistic average BCE-with-logits with labels
    0.9 / 0.1, instance noise of ``noise_sigma`` on both inputs. ``noise``
    is a ``torch.Generator`` on the batch's device, or the two draws
    ``(real, fake)`` as (N, 3, H, W) tensors.

    As in the JAX package, the fake comes from an eval-mode G forward
    without a graph, so the D step leaves G as it is; real and fake go
    through D in two train-mode forwards, real first, each one power
    iteration and one BatchNorm update, the second chained to the first
    (``chained_power_iterations``). A non-finite loss or gradient leaves
    D's parameters, moments and buffers as they were and ticks its
    ``skipped``."""

    def d_step(g_state: SRTrainState, d_state: SRTrainState,
               hr_u8: torch.Tensor, noise):
        if g_state.model is not g_model or d_state.model is not d_model:
            raise ValueError("d_step: a state holds another model")
        lr_img, hr = prepare_batch(hr_u8, scale)
        with torch.no_grad():
            fake = g_model.eval()(lr_img)
        n_real, n_fake = noise if isinstance(noise, (tuple, list)) else \
            (noise, noise)
        noisy_real = add_noise(hr, noise_sigma, n_real)
        noisy_fake = add_noise(fake, noise_sigma, n_fake)
        snap = snapshot_buffers(d_model)
        d_model.train()
        with chained_power_iterations(d_model):
            real_logits = d_model(noisy_real)
            fake_logits = d_model(noisy_fake)
            loss = (_bce(real_logits - global_mean(fake_logits), 0.9)
                    + _bce(fake_logits - global_mean(real_logits), 0.1)) / 2.0
            grads = list(torch.autograd.grad(loss, d_state.params,
                                             materialize_grads=True))
        loss = loss.detach()
        with torch.no_grad():
            probs = [torch.sigmoid(real_logits).mean(),
                     torch.sigmoid(fake_logits).mean()]
            all_reduce_mean_([*grads, loss, *probs])
            ok = _finite_guard(loss, grad_norm(grads))
            d_state.apply_updates(grads, ok)
            _keep_if(ok, snap)
            metrics = {
                "train_loss_D": loss,
                "gan_dynamics/prob_real": probs[0],
                "gan_dynamics/prob_fake": probs[1],
                "nonfinite_steps_D": 1.0 - ok.float(),
                "nonfinite_total_D": d_state.skipped.clone(),
            }
        return d_state, metrics

    return d_step


def make_gan_g_step(g_model: nn.Module, d_model: nn.Module,
                    perceptual_fn: Callable, scale: int, first: str,
                    last: str, w_pixel: float = 1e-2, w_percep: float = 1.0,
                    w_adv: float = 1e-5, w_tv: float = 2e-5,
                    ema_decay: float | None = None):
    """Generator step ``g_step(g_state, d_state, hr_u8) -> (g_state,
    d_state, metrics)``: ``w_pixel * MAE + w_percep * perceptual + w_adv *
    BCE(fake - mean(real), 1) + w_tv * TV`` with the reference's weights,
    and the supervised step's diagnostics and guarded update (and EMA).
    D runs in train mode on the fake (sr) first, then on the real (hr,
    without a graph: its logits are constants of the loss), so its
    spectral vectors and running stats advance as the JAX package's do;
    a skipped step puts them and G's own buffers back too, and leaves D's
    ``skipped`` as it was."""

    def g_step(g_state: SRTrainState, d_state: SRTrainState,
               hr_u8: torch.Tensor):
        if g_state.model is not g_model or d_state.model is not d_model:
            raise ValueError("g_step: a state holds another model")
        lr_img, hr = prepare_batch(hr_u8, scale)
        snap, g_snap = snapshot_buffers(d_model), snapshot_buffers(g_model)
        g_model.train()
        d_model.train()
        sr = g_model(lr_img)
        fake_logits = d_model(sr)
        with torch.no_grad():
            real_logits = d_model(hr)
        loss = (w_pixel * mae_loss(sr, hr) + w_percep * perceptual_fn(sr, hr)
                + w_adv * _bce(fake_logits - global_mean(real_logits), 1.0)
                + w_tv * tv_loss(sr))
        grads = list(torch.autograd.grad(loss, g_state.params,
                                         materialize_grads=True))
        g_state, metrics = _finalize_update(g_state, grads, loss.detach(),
                                            first, last, ema_decay, g_snap)
        _keep_if(metrics["nonfinite_steps"] == 0, snap)
        return g_state, d_state, metrics

    return g_step
