"""Weight carry-over from the JAX package: a Flax params tree of numpy
arrays -> a state_dict for the port's modules. The mappings only
transpose, so they carry a gradient tree of the same structure as well.

The key sets are the reference PyTorch layouts that the JAX package's
``tools/export_sr_checkpoint.py`` writes (``export_srnet``,
``export_discriminator``), so the results load into
:class:`~food101_sr_tpu_torch.models.AttentionSR` and
:class:`~food101_sr_tpu_torch.models.Discriminator` with ``strict=True``.
Conv kernels go HWIO -> OIHW, dense kernels (in, out) -> (out, in), each
scalar PReLU slope becomes a one-element weight, and a spectral-norm
``v`` goes from the (kh, kw, in) order to (in, kh, kw).
"""
from __future__ import annotations

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32))


def _conv(sd: dict, prefix: str, p: dict) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["conv"]["kernel"])
                                .transpose(3, 2, 0, 1))
    sd[f"{prefix}.bias"] = _t(p["conv"]["bias"])


def _prelu(p: dict) -> torch.Tensor:
    return _t(p["alpha"]).reshape(1)


def params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """AttentionSR params tree (``{"input_conv": {"conv": {"kernel", ...}},
    "res_0": ..., "up_0": ...}``) -> state_dict."""
    if "se" not in params.get("res_0", {}):
        raise ValueError("params_from_jax: not an AttentionSR params tree")
    sd: dict[str, torch.Tensor] = {}
    for name in ("input_conv", "mid_conv", "output_conv"):
        _conv(sd, name, params[name])
    sd["prelu.weight"] = _prelu(params["prelu"])
    n_blocks = 1 + max(int(k.split("_")[1]) for k in params
                       if k.startswith("res_"))
    for i in range(n_blocks):
        blk, r = params[f"res_{i}"], f"res_blocks.{i}"
        _conv(sd, f"{r}.conv1", blk["conv1"])
        _conv(sd, f"{r}.conv2", blk["conv2"])
        sd[f"{r}.prelu.weight"] = _prelu(blk["prelu"])
        sd[f"{r}.se.fc.0.weight"] = _t(np.asarray(blk["se"]["fc1"]["kernel"]).T)
        sd[f"{r}.se.fc.2.weight"] = _t(np.asarray(blk["se"]["fc2"]["kernel"]).T)
    # upsample Sequential: [conv, PixelShuffle, PReLU] per stage
    n_up = sum(1 for k in params if k.startswith("up_"))
    for s in range(n_up):
        blk = params[f"up_{s}"]
        _conv(sd, f"upsample.{3 * s}", blk["conv"])
        sd[f"upsample.{3 * s + 2}.weight"] = _prelu(blk["prelu"])
    return sd


def alexnet_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """``AlexNetFeatures`` params tree (``{"conv_0": {"kernel", "bias"},
    ...}``, kernels HWIO) -> state_dict of
    :class:`~food101_sr_tpu_torch.models.feature_nets.AlexNetFeatures`."""
    sd: dict[str, torch.Tensor] = {}
    for name in sorted(params):
        sd[f"{name}.weight"] = _t(np.asarray(params[name]["kernel"])
                                  .transpose(3, 2, 0, 1))
        sd[f"{name}.bias"] = _t(params[name]["bias"])
    return sd


def vgg19_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """``VGG19Features`` params tree (``conv_0`` .. ``conv_15``, the same
    flat layout as AlexNet's) -> state_dict of
    :class:`~food101_sr_tpu_torch.models.feature_nets.VGG19Features`."""
    return alexnet_from_jax(params)


def _bn(sd: dict, prefix: str, p: dict, stats: dict) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(stats["mean"])
    sd[f"{prefix}.running_var"] = _t(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)


def discriminator_from_jax(params: dict, extra: dict
                           ) -> dict[str, torch.Tensor]:
    """``Discriminator`` params and extra collections (``batch_stats``,
    ``spectral``) -> state_dict of
    :class:`~food101_sr_tpu_torch.models.Discriminator`: ``weight_orig``,
    ``weight_u``, ``weight_v`` (re-ordered to (in, kh, kw)) and ``bias``
    per spectral-norm layer, BatchNorm weights with their running stats and
    a zero ``num_batches_tracked``."""
    stats, spectral = extra["batch_stats"], extra["spectral"]
    sd: dict[str, torch.Tensor] = {}
    for i, prefix in enumerate(("net.0", "net.2", "net.5", "net.8")):
        name = f"block_{i}"
        kernel = np.asarray(params[name]["sn"]["kernel"], np.float32)
        kh, kw, cin, _ = kernel.shape
        sd[f"{prefix}.weight_orig"] = _t(kernel.transpose(3, 2, 0, 1))
        sd[f"{prefix}.weight_u"] = _t(spectral[name]["sn"]["u"])
        v = np.asarray(spectral[name]["sn"]["v"]).reshape(kh, kw, cin)
        sd[f"{prefix}.weight_v"] = _t(v.transpose(2, 0, 1).ravel())
        if "bias" in params[name]:
            sd[f"{prefix}.bias"] = _t(params[name]["bias"])
    for i, prefix in ((1, "net.3"), (2, "net.6"), (3, "net.9")):
        _bn(sd, prefix, params[f"bn_{i}"], stats[f"bn_{i}"])
    for name, prefix in (("fc1", "classifier.2"), ("fc2", "classifier.4")):
        sd[f"{prefix}.weight_orig"] = _t(np.asarray(params[name]["sn"]
                                                    ["kernel"]).T)
        sd[f"{prefix}.weight_u"] = _t(spectral[name]["sn"]["u"])
        sd[f"{prefix}.weight_v"] = _t(spectral[name]["sn"]["v"])
        sd[f"{prefix}.bias"] = _t(params[name]["bias"])
    return sd
