from .pil_bicubic import resize_bicubic_u8
from .pipeline import (SRDataLoader, load_hr_crop, load_sample,
                       prepare_batch, subset_indices, train_val_split)
from .sources import Food101Source, SyntheticSource

__all__ = [
    "Food101Source", "SRDataLoader", "SyntheticSource", "load_hr_crop",
    "load_sample", "prepare_batch", "resize_bicubic_u8", "subset_indices",
    "train_val_split",
]
