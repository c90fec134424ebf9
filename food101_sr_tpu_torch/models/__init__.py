from .attention_sr import AttentionSR
from .discriminator import Discriminator
from .feature_nets import AlexNetFeatures, VGG19Features
from .layers import (AttentionResidualBlock, Conv, SEBlock, SNConv2d,
                     SNLinear, chained_power_iterations, init_weights,
                     scale_stages, upsample_block)
from .registry import build_model, get_model

__all__ = [
    "AlexNetFeatures", "AttentionResidualBlock", "AttentionSR", "Conv",
    "Discriminator", "SEBlock", "SNConv2d", "SNLinear", "VGG19Features",
    "build_model", "chained_power_iterations", "get_model", "init_weights",
    "scale_stages", "upsample_block",
]
