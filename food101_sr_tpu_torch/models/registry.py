"""Model registry (counterpart of ``food101_sr_tpu/models/registry.py``):
name -> module at the reference's sizes (SRCNN hidden 64; RESNET 16
blocks x 64 channels; AttentionSR 32 blocks x 96 channels; RRDB 23 RRDBs
x 64 channels, growth 32), and the architecture of a state_dict read from
its keys and tensor shapes.

Each entry takes the scale and the JAX registry's ``quantize``,
``phase_tail``, ``remat`` and dtype (``compute_dtype`` here) flags as
keywords; SRCNN has neither a body stack nor a tail, so it ignores
``phase_tail`` and ``remat`` and ``get_model`` refuses it a ``quantize``
mode.
"""
from __future__ import annotations

import torch
from torch import nn

from .attention_sr import AttentionSR
from .layers import init_weights
from .resnet_sr import ResNetSR
from .rrdb import RRDBNet
from .srcnn import SRCNN

_REGISTRY = {
    "SRCNN": lambda scale, quantize="", phase_tail=False, compute_dtype=None,
    remat=False: SRCNN(scale_factor=scale, hidden_dim=64,
                       compute_dtype=compute_dtype),
    "RESNET": lambda scale, **flags: ResNetSR(
        scale_factor=scale, num_residuals=16, num_channels=64, **flags),
    "AttentionSR": lambda scale, **flags: AttentionSR(
        scale_factor=scale, num_residuals=32, num_channels=96, **flags),
    "RRDB": lambda scale, **flags: RRDBNet(
        scale_factor=scale, num_channels=64, growth=32, num_blocks=23,
        **flags),
}

_QUANTIZE_MODES = ("", "int8", "int8_dot", "qat")


def _check_quantize(arch: str, quantize: str) -> None:
    """JAX's refusals: SRCNN has no body stack to quantize, and an unknown
    mode is an error."""
    if quantize and arch not in ("RESNET", "AttentionSR", "RRDB"):
        raise ValueError(f"quantize: {arch} has no quantizable body stack")
    if quantize not in _QUANTIZE_MODES:
        raise ValueError(f"Unknown quantize mode: {quantize!r}")


def build_model(module_fn, dtype: torch.dtype = torch.float32,
                device: str | torch.device = "cuda",
                generator: torch.Generator | None = None,
                remat: bool = False) -> nn.Module:
    """Construct ``module_fn()`` without touching the global RNG, draw its
    weights from ``generator`` (seed 0 when None), and move it to
    ``device``/``dtype`` in eval mode, 4-D weights in channels-last memory
    (the format the nets run in). ``remat=True`` turns on the block
    recomputation (``layers.run_blocks``) of every net in it that has a
    block stack; False leaves the nets as ``module_fn`` made them."""
    with torch.device("meta"):
        model = module_fn()
    model = model.to_empty(device="cpu")
    init_weights(model, generator if generator is not None
                 else torch.Generator().manual_seed(0))
    if remat:
        for m in model.modules():
            if hasattr(m, "remat"):
                m.remat = True
    return model.to(device=device, dtype=dtype,
                    memory_format=torch.channels_last).eval()


def get_model(name: str, scale_factor: int = 4,
              dtype: torch.dtype = torch.float32,
              device: str | torch.device = "cuda",
              generator: torch.Generator | None = None,
              quantize: str = "", phase_tail: bool = False,
              compute_dtype: torch.dtype | None = None,
              remat: bool = False) -> nn.Module:
    """Registry model ``name`` with seeded random weights, on ``device``.

    ``dtype`` is the parameters' dtype (a served bf16 net casts the whole
    module once); ``compute_dtype`` keeps them in ``dtype`` and runs the
    convs and linears in ``compute_dtype``, casting at each call, as the
    JAX registry's ``dtype=`` does (bf16 training on float32 master
    weights).

    ``quantize="int8"`` (or ``"int8_dot"``, the same computation here)
    runs the body convs of RESNET, AttentionSR and RRDB in dynamic int8
    for inference; ``"qat"`` is the trainable twin on fake-quantized
    weights and activations (``ops.quantize``). The weights are the float
    ones either way. ``phase_tail`` runs the upsample tail in phase space
    (``ops.subpixel_conv``), the same function and weights. ``remat``
    recomputes each block of the body stack in the backward of a
    differentiated pass (``layers.run_blocks``, JAX's ``nn.remat`` per
    block): the same gradients for less activation memory; SRCNN has no
    block stack and ignores it. JAX's defaults: all three off."""
    if name not in _REGISTRY:
        raise ValueError(f"Unknown architecture: {name}")
    _check_quantize(name, quantize)
    return build_model(lambda: _REGISTRY[name](
        scale_factor, quantize=quantize, phase_tail=phase_tail,
        compute_dtype=compute_dtype, remat=remat), dtype, device, generator)


def model_names() -> list[str]:
    return list(_REGISTRY)


def param_count(model: nn.Module) -> int:
    """Total parameter count (the running stats are buffers, as in JAX's
    ``batch_stats``, and are not counted)."""
    return sum(p.numel() for p in model.parameters())


def architecture_of(model: nn.Module) -> str | None:
    """Registry name of a port generator's class; None for another
    module."""
    for name, cls in (("SRCNN", SRCNN), ("RESNET", ResNetSR),
                      ("AttentionSR", AttentionSR), ("RRDB", RRDBNet)):
        if isinstance(model, cls):
            return name
    return None


def detect_architecture(state_dict: dict) -> str:
    """Architecture name from a state_dict's keys (checkpoints store no
    metadata: the tensors are the schema)."""
    keys = set(state_dict)
    if "net.0.weight_orig" in keys:
        return "Discriminator"
    if "conv1.weight" in keys and "input_conv.weight" not in keys:
        return "SRCNN"
    if any(k.startswith("rrdb.") for k in keys):
        return "RRDB"
    if "res_blocks.0.se.fc.0.weight" in keys:
        return "AttentionSR"
    if "res_blocks.0.bn1.weight" in keys:
        return "RESNET"
    raise ValueError("unrecognized checkpoint: the state_dict matches no "
                     "known architecture")


def _count(keys, prefix: str) -> int:
    """1 + the largest index ``i`` of keys ``{prefix}.{i}.*``."""
    return 1 + max(int(k.split(".")[1]) for k in keys
                   if k.startswith(prefix + "."))


def model_for_params(state_dict: dict, scale_factor: int = 4,
                     dtype: torch.dtype = torch.float32,
                     device: str | torch.device = "cuda",
                     quantize: str = "", phase_tail: bool = False,
                     compute_dtype: torch.dtype | None = None,
                     remat: bool = False) -> nn.Module:
    """The generator matching ``state_dict``, with its widths and depths
    read from the tensor shapes (so non-registry variants load without
    flags) and the weights loaded strictly, on ``device`` in eval mode;
    ``quantize``, ``phase_tail``, ``compute_dtype`` and ``remat`` as in
    :func:`get_model` (a QAT checkpoint holds the float weights, so it
    loads unchanged; the RRDB dense layout does not show in the weights,
    so it is "auto").

    For the post-upsampling nets the checkpoint's upsample stages set the
    scale and override ``scale_factor``: each stage's factor comes from
    its conv's cout = 64 * s^2. SRCNN's weights are scale-independent, so
    ``scale_factor`` is taken as given there."""
    arch = detect_architecture(state_dict)
    if arch == "Discriminator":
        raise ValueError("model_for_params: a Discriminator state_dict is "
                         "not a generator")
    _check_quantize(arch, quantize)
    sd = state_dict
    if arch == "SRCNN":
        hidden = sd["conv2.weight"].shape[0]
        return _loaded(lambda: SRCNN(scale_factor, hidden,
                                     compute_dtype=compute_dtype), sd, dtype,
                       device)
    # one conv (the only biased layer) per stage
    n_up = sum(1 for k in sd if k.startswith("upsample.")
               and k.endswith(".bias"))
    scale = 1
    for i in range(n_up):
        cout = sd[f"upsample.{3 * i}.weight"].shape[0]
        s = round((cout / 64) ** 0.5)
        if cout != 64 * s * s:
            # not an assert: under ``python -O`` it would vanish and a
            # malformed checkpoint would silently serve the wrong scale
            raise ValueError(
                f"upsample.{3 * i}: weight cout {cout} is not 64*s^2 for any "
                "integer s: a malformed or unsupported upsample stage")
        scale *= s
    nf = sd["input_conv.weight"].shape[0]
    if arch == "RRDB":
        growth = sd["rrdb.0.dense1.conv1.weight"].shape[0]
        blocks = _count(sd, "rrdb")
        return _loaded(lambda: RRDBNet(scale, nf, growth, blocks,
                                       quantize=quantize,
                                       phase_tail=phase_tail,
                                       compute_dtype=compute_dtype,
                                       remat=remat),
                       sd, dtype, device)
    cls = AttentionSR if arch == "AttentionSR" else ResNetSR
    n_res = _count(sd, "res_blocks")
    return _loaded(lambda: cls(scale, nf, n_res, quantize=quantize,
                               phase_tail=phase_tail,
                               compute_dtype=compute_dtype, remat=remat),
                   sd, dtype, device)


def _loaded(module_fn, state_dict: dict, dtype: torch.dtype,
            device: str | torch.device) -> nn.Module:
    """``module_fn()`` with ``state_dict`` loaded strictly, without drawing
    an init first."""
    with torch.device("meta"):
        model = module_fn()
    model = model.to_empty(device="cpu")
    model.load_state_dict(state_dict, strict=True)
    return model.to(device=device, dtype=dtype,
                    memory_format=torch.channels_last).eval()
