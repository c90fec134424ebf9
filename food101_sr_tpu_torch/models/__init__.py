from .attention_sr import AttentionSR
from .discriminator import Discriminator
from .feature_nets import AlexNetFeatures, VGG19Features
from .layers import (AttentionResidualBlock, BatchNorm2d, Conv,
                     ResidualBlock, SEBlock, SNConv2d, SNLinear,
                     chained_power_iterations, init_weights, scale_stages,
                     set_compute_dtype, upsample_block, upsample_tail)
from .registry import (architecture_of, build_model, detect_architecture,
                       get_model, model_for_params, model_names, param_count)
from .resnet_sr import ResNetSR
from .rrdb import RRDB, ResidualDenseBlock, RRDBNet
from .srcnn import SRCNN

__all__ = [
    "AlexNetFeatures", "AttentionResidualBlock", "AttentionSR",
    "BatchNorm2d", "Conv", "Discriminator", "RRDB", "RRDBNet",
    "ResNetSR", "ResidualBlock", "ResidualDenseBlock", "SEBlock", "SNConv2d",
    "SNLinear", "SRCNN", "VGG19Features", "architecture_of", "build_model",
    "chained_power_iterations", "detect_architecture", "get_model",
    "init_weights", "model_for_params", "model_names", "param_count",
    "scale_stages", "set_compute_dtype", "upsample_block", "upsample_tail",
]
