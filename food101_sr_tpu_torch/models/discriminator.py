"""The relativistic-GAN critic with spectral norm (counterpart of
``food101_sr_tpu/models/discriminator.py``).

Four SN-conv blocks (3->nf s1 with bias, ->2nf, ->4nf, ->8nf s2 without
bias; BatchNorm after blocks 2-4; LeakyReLU 0.2 after each) -> global mean
-> SN-Linear(8nf->100) -> LeakyReLU -> SN-Linear(100->1), one logit per
image. Modules sit at the reference's ``nn.Sequential`` indices
(``net.{0,2,5,8}`` convs, ``net.{3,6,9}`` BatchNorms,
``classifier.{2,4}`` linears), the keys ``convert.discriminator_from_jax``
writes, so a JAX discriminator loads with ``strict=True``.

BatchNorm is ``layers.BatchNorm2d`` (momentum 0.1, eps 1e-5, float32
statistics and normalization): the JAX package's ``TorchBatchNorm``
re-creates torch's unbiased running variance, and flax's momentum 0.9 is
torch's 0.1.

``compute_dtype`` runs the convs and linears in that dtype on float32
parameters, spectral vectors and running stats, as JAX's
``Discriminator(dtype=...)``: the logits come out in the compute dtype.
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import (BatchNorm2d, LeakyReLU, SNConv2d, SNLinear,
                     set_compute_dtype)


class GlobalMean(nn.Module):
    """(N, C, H, W) -> (N, C), a plain mean over H and W (the JAX package
    takes ``jnp.mean``; the SE squeeze's kernel K2 is not used here)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean((2, 3))


class Discriminator(nn.Module):
    def __init__(self, in_nc: int = 3, nf: int = 64,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()

        def act():
            return LeakyReLU(0.2)

        self.net = nn.Sequential(
            SNConv2d(in_nc, nf, 3, 1, bias=True), act(),
            SNConv2d(nf, nf * 2, 3, 2, bias=False), BatchNorm2d(nf * 2),
            act(),
            SNConv2d(nf * 2, nf * 4, 3, 2, bias=False),
            BatchNorm2d(nf * 4), act(),
            SNConv2d(nf * 4, nf * 8, 3, 2, bias=False),
            BatchNorm2d(nf * 8), act())
        self.classifier = nn.Sequential(
            GlobalMean(), nn.Flatten(), SNLinear(nf * 8, 100), act(),
            SNLinear(100, 1))
        set_compute_dtype(self, compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.classifier(self.net(x))
