"""Weight carry-over from the JAX package: a Flax params tree of numpy
arrays -> a state_dict for the port's modules. The mappings only
transpose, so they carry a gradient tree of the same structure as well.

The key sets of SRCNN, ResNetSR and AttentionSR are the reference PyTorch
layouts that the JAX package's ``tools/export_sr_checkpoint.py`` writes
(``export_srcnn``, ``export_srnet``, ``export_discriminator``), so the
results load into the port's modules with ``strict=True``. No exporter
covers RRDBNet; the port's layout is

    input_conv.{weight,bias}                         <- input_conv
    rrdb.{i}.dense{j}.conv{k}.{weight,bias}          <- rrdb_{i}/dense{j}/conv{k}
    mid_conv.{weight,bias}                           <- mid_conv
    upsample.{3s}.{weight,bias}                      <- up_{s}/conv
    upsample.{3s+2}.weight                           <- up_{s}/prelu
    output_conv.{weight,bias}                        <- output_conv

(i < num_blocks, j in 1..3, k in 1..5), the same for the ``split`` and
``concat`` dense layouts, whose params trees are one.

Conv kernels go HWIO -> OIHW, dense kernels (in, out) -> (out, in), each
scalar PReLU slope becomes a one-element weight, a BatchNorm's
scale/bias and ``batch_stats`` mean/var become its weight/bias and
running stats with a zero ``num_batches_tracked``, and a spectral-norm
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


def jax_architecture(params: dict) -> str:
    """Architecture of a JAX params tree, by the rules of the JAX
    package's ``detect_architecture``."""
    if "block_0" in params:
        return "Discriminator"
    if "conv1" in params and "input_conv" not in params:
        return "SRCNN"
    if "rrdb_0" in params:
        return "RRDB"
    if "se" in params.get("res_0", {}):
        return "AttentionSR"
    if "bn1" in params.get("res_0", {}):
        return "RESNET"
    raise ValueError("unrecognized params tree: it matches no known "
                     "architecture")


def _n_indexed(params: dict, prefix: str) -> int:
    return 1 + max(int(k.split("_")[1]) for k in params
                   if k.startswith(prefix + "_"))


def _tail(sd: dict, params: dict) -> None:
    """upsample Sequential: [conv, PixelShuffle, PReLU] per stage, then the
    output conv."""
    n_up = sum(1 for k in params if k.startswith("up_"))
    for s in range(n_up):
        blk = params[f"up_{s}"]
        _conv(sd, f"upsample.{3 * s}", blk["conv"])
        sd[f"upsample.{3 * s + 2}.weight"] = _prelu(blk["prelu"])
    _conv(sd, "output_conv", params["output_conv"])


def _srcnn(params: dict, extra: dict | None) -> dict:
    sd: dict[str, torch.Tensor] = {}
    for i in (1, 2, 3):
        _conv(sd, f"conv{i}", params[f"conv{i}"])
    return sd


def _srnet(params: dict, extra: dict | None) -> dict:
    """AttentionSR and ResNetSR (``export_srnet``'s layout). A ResNetSR
    tree's BatchNorms get their running stats from ``extra["batch_stats"]``
    when ``extra`` is given; without it (a gradient tree) only the
    parameters are mapped."""
    attention = "se" in params["res_0"]
    stats = None if extra is None or attention else extra["batch_stats"]

    def st(*path):
        node = stats
        for key in path:
            node = None if node is None else node[key]
        return node

    sd: dict[str, torch.Tensor] = {}
    _conv(sd, "input_conv", params["input_conv"])
    sd["prelu.weight"] = _prelu(params["prelu"])
    for i in range(_n_indexed(params, "res")):
        blk, r = params[f"res_{i}"], f"res_blocks.{i}"
        _conv(sd, f"{r}.conv1", blk["conv1"])
        if not attention:
            _bn(sd, f"{r}.bn1", blk["bn1"], st(f"res_{i}", "bn1"))
        sd[f"{r}.prelu.weight"] = _prelu(blk["prelu"])
        _conv(sd, f"{r}.conv2", blk["conv2"])
        if attention:
            sd[f"{r}.se.fc.0.weight"] = _t(np.asarray(blk["se"]["fc1"]
                                                      ["kernel"]).T)
            sd[f"{r}.se.fc.2.weight"] = _t(np.asarray(blk["se"]["fc2"]
                                                      ["kernel"]).T)
        else:
            _bn(sd, f"{r}.bn2", blk["bn2"], st(f"res_{i}", "bn2"))
    _conv(sd, "mid_conv", params["mid_conv"])
    if not attention:
        _bn(sd, "bn_mid", params["bn_mid"], st("bn_mid"))
    _tail(sd, params)
    return sd


def _rrdb(params: dict, extra: dict | None) -> dict:
    sd: dict[str, torch.Tensor] = {}
    _conv(sd, "input_conv", params["input_conv"])
    for i in range(_n_indexed(params, "rrdb")):
        for j in (1, 2, 3):
            dense = params[f"rrdb_{i}"][f"dense{j}"]
            for k in range(1, 6):
                _conv(sd, f"rrdb.{i}.dense{j}.conv{k}", dense[f"conv{k}"])
    _conv(sd, "mid_conv", params["mid_conv"])
    _tail(sd, params)
    return sd


_GENERATORS = {"SRCNN": _srcnn, "RESNET": _srnet, "AttentionSR": _srnet,
               "RRDB": _rrdb}


def params_from_jax(params: dict, extra: dict | None = None
                    ) -> dict[str, torch.Tensor]:
    """A generator's params tree (SRCNN, RESNET, AttentionSR or RRDB,
    told apart by its structure) -> state_dict. ``extra`` holds the JAX
    state's other collections; a ResNetSR needs its ``batch_stats`` for
    the BatchNorms' running stats (a gradient tree has none)."""
    arch = jax_architecture(params)
    if arch not in _GENERATORS:
        raise ValueError(f"params_from_jax: a {arch} tree is not a "
                         "generator (see discriminator_from_jax)")
    return _GENERATORS[arch](params, extra)


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


def _bn(sd: dict, prefix: str, p: dict, stats: dict | None) -> None:
    """A BatchNorm's weight and bias, and with ``stats`` its running stats
    and a zero ``num_batches_tracked``."""
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    if stats is None:
        return
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
