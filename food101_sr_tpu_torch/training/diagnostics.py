"""Training-dynamics diagnostics, computed on the device without a host
sync (counterpart of ``food101_sr_tpu/training/diagnostics.py``). Norms
are taken in float32 over lists of tensors (a parameter or gradient
list)."""
from __future__ import annotations

import torch


def _global_norm(tensors) -> torch.Tensor:
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def grad_norm(grads) -> torch.Tensor:
    """Global L2 gradient norm."""
    return _global_norm(grads)


def weight_norm(params) -> torch.Tensor:
    """Global L2 weight norm."""
    return _global_norm(params)


def layer_grad_ratio(grads: dict[str, torch.Tensor], first: str,
                     last: str) -> torch.Tensor:
    """Vanishing-gradient probe: the gradient norm of top-level module
    ``first`` over that of ``last`` (e.g. 'input_conv' / 'output_conv');
    ``grads`` maps parameter names (``model.named_parameters()``) to
    gradients."""
    def norm(module):
        return _global_norm([g for k, g in grads.items()
                             if k.split(".")[0] == module])
    return norm(first) / (norm(last) + 1e-8)


def update_ratio(params, grads, lr: float) -> torch.Tensor:
    """Relative update size ``||lr * g|| / ||w||`` (0 when ``||w|| == 0``)."""
    pn = _global_norm(params)
    un = _global_norm(grads) * lr
    return torch.where(pn == 0, 0.0, un / pn)


# First/last top-level modules per architecture (parameter registration
# order: input conv first, output conv last).
FIRST_LAST = {
    "SRCNN": ("conv1", "conv3"),
    "RESNET": ("input_conv", "output_conv"),
    "AttentionSR": ("input_conv", "output_conv"),
    "RRDB": ("input_conv", "output_conv"),
}
