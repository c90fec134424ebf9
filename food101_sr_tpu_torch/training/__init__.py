"""The supervised training step (counterpart of
``food101_sr_tpu/training``). The loop, the schedules, the checkpoints and
the loader come with the training runtime (ROADMAP item 9)."""
from .diagnostics import (FIRST_LAST, grad_norm, layer_grad_ratio,
                          update_ratio, weight_norm)
from .state import SRTrainState, Transform, make_adam
from .steps import (loss_and_grads, make_eval_step, make_forward,
                    make_train_step)

__all__ = [
    "FIRST_LAST", "SRTrainState", "Transform", "grad_norm",
    "layer_grad_ratio", "loss_and_grads", "make_adam", "make_eval_step",
    "make_forward", "make_train_step", "update_ratio",
    "weight_norm",
]
