from .attention_sr import AttentionSR
from .layers import (AttentionResidualBlock, Conv, SEBlock, init_weights,
                     scale_stages, upsample_block)
from .registry import build_model, get_model

__all__ = [
    "AttentionResidualBlock", "AttentionSR", "Conv", "SEBlock",
    "build_model", "get_model", "init_weights",
    "scale_stages", "upsample_block",
]
