"""Train state and optimizer construction (counterpart of
``food101_sr_tpu/training/state.py``: ``SRTrainState`` and ``make_adam``).

JAX's state is an immutable pytree; here the model's parameters, the
optimizer's moments, the step count, the params EMA and the ``skipped``
counter are tensors on the model's device, updated in place. The update is
guarded without a host sync: the optimizer is a fused PyTorch optimizer
(``fused=True``), whose kernels take a ``found_inf`` flag on the device
and, when it is 1, leave the parameters, the moments and the step count as
they were (the same flag ``torch.amp.GradScaler`` uses); the step count,
the EMA and ``skipped`` are selected by the same flag.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch import nn

from .diagnostics import grad_norm


@dataclass(frozen=True)
class Transform:
    """An optimizer recipe: ``make(params, lr)`` builds a fused
    ``torch.optim.Optimizer`` over ``params``; ``clip_norm`` clips the
    global gradient norm first, as ``optax.clip_by_global_norm`` does."""

    make: Callable[[list, float], torch.optim.Optimizer]
    learning_rate: float
    clip_norm: float | None = None


def make_adam(lr: float, clip_norm: float | None = None) -> Transform:
    """Adam with betas (0.5, 0.999) and eps 1e-8, as the reference
    configures it, with optional global-norm clipping (the GAN generator
    clips at 1.0)."""
    return Transform(lambda params, lr_: torch.optim.Adam(
        params, lr=lr_, betas=(0.5, 0.999), eps=1e-8, fused=True),
        lr, clip_norm)


def clip_by_global_norm(grads: list[torch.Tensor], norm: torch.Tensor,
                        max_norm: float) -> None:
    """In place, optax's rule: ``g / norm * max_norm`` when ``norm >=
    max_norm``, ``g`` untouched otherwise (``clip_grad_norm_`` adds 1e-6
    to the norm and is a different function). No host sync."""
    keep = norm < max_norm
    torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(keep, 1.0, max_norm).to(norm))


class SRTrainState:
    """Model, fused optimizer, ``step``, optional params ``ema`` and
    ``skipped`` (int32 count of updates the non-finite guard refused), all
    on the model's device. Build with :meth:`create`."""

    def __init__(self, model: nn.Module, tx: Transform, ema: bool = False):
        self.model = model
        named = [(k, p) for k, p in model.named_parameters()
                 if p.requires_grad]
        self.names = [k for k, _ in named]
        self.params = [p for _, p in named]
        self.tx = tx
        self.optimizer = tx.make(self.params, tx.learning_rate)
        if not self.optimizer.defaults.get("fused"):
            raise ValueError("SRTrainState: the optimizer must be fused (it "
                             "takes found_inf, the guard's device flag)")
        dev = self.params[0].device
        self.step = torch.zeros((), dtype=torch.int32, device=dev)
        self.skipped = torch.zeros((), dtype=torch.int32, device=dev)
        self.ema = ([p.detach().clone() for p in self.params] if ema
                    else None)

    @classmethod
    def create(cls, model: nn.Module, tx: Transform,
               ema: bool = False) -> "SRTrainState":
        return cls(model, tx, ema)

    @property
    def learning_rate(self) -> float:
        return self.optimizer.param_groups[0]["lr"]

    def set_learning_rate(self, lr: float) -> "SRTrainState":
        """The plateau schedule's path: every later update uses ``lr``;
        nothing is rebuilt."""
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        return self

    @torch.no_grad()
    def apply_updates(self, grads: list[torch.Tensor],
                      ok: torch.Tensor | None = None,
                      ema_decay: float | None = None) -> "SRTrainState":
        """One update from ``grads`` (one per ``params``): the clip, the
        optimizer step, ``step + 1`` and the EMA. Where the device flag
        ``ok`` is False, the parameters, moments, ``step`` and EMA stay
        bit for bit as they were and ``skipped`` goes up by 1. The
        gradients stay in each parameter's ``.grad`` (clipped, when the
        clip is on) until the next update."""
        if ok is None:
            ok = torch.ones((), dtype=torch.bool, device=self.step.device)
        for p, g in zip(self.params, grads, strict=True):
            p.grad = g
        if self.tx.clip_norm is not None:
            clip_by_global_norm(grads, grad_norm(grads), self.tx.clip_norm)
        opt = self.optimizer
        opt.grad_scale, opt.found_inf = None, (~ok).float()
        try:
            opt.step()
        finally:
            del opt.grad_scale, opt.found_inf
        if self.ema is not None and ema_decay is not None:
            # ema + w * (params - ema), w = ok * (1 - decay): w = 0 keeps
            # the EMA exactly (the params are finite when the guard skips)
            w = ok.float() * float(np.float32(1.0) - np.float32(ema_decay))
            delta = torch._foreach_sub(self.params, self.ema)
            torch._foreach_mul_(delta, w)
            torch._foreach_add_(self.ema, delta)
        self.step += ok.int()
        self.skipped += (~ok).int()
        return self
