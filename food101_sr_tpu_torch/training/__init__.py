"""The training runtime (counterpart of ``food101_sr_tpu/training``): the
supervised and GAN steps, their state and diagnostics, the epoch loop with
its schedules, checkpoints, resume and preemption."""
from .checkpoint import (load_checkpoint, load_train_checkpoint,
                         save_checkpoint, save_train_checkpoint,
                         warm_start_params)
from .diagnostics import (FIRST_LAST, grad_norm, layer_grad_ratio,
                          update_ratio, weight_norm)
from .loop import DEFAULTS, train
from .preempt import PreemptionGuard
from .schedule import EarlyStopping, ReduceLROnPlateau
from .state import SRTrainState, Transform, make_adam
from .steps import (add_noise, loss_and_grads, make_accum_apply,
                    make_eval_step, make_forward, make_gan_d_step,
                    make_gan_g_step, make_grad_step, make_train_step,
                    snapshot_buffers)

__all__ = [
    "DEFAULTS", "EarlyStopping", "FIRST_LAST", "PreemptionGuard",
    "ReduceLROnPlateau", "SRTrainState", "Transform", "add_noise",
    "grad_norm", "layer_grad_ratio", "load_checkpoint",
    "load_train_checkpoint", "loss_and_grads", "make_accum_apply",
    "make_adam", "make_eval_step", "make_forward", "make_gan_d_step",
    "make_gan_g_step", "make_grad_step", "make_train_step",
    "save_checkpoint", "save_train_checkpoint", "snapshot_buffers", "train",
    "update_ratio",
    "warm_start_params", "weight_norm",
]
