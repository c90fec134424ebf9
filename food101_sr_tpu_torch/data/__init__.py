from .pil_bicubic import resize_bicubic_u8
from .pipeline import (SRDataLoader, load_hr_crop, prepare_batch,
                       subset_indices, train_val_split)
from .sources import SyntheticSource

__all__ = [
    "SRDataLoader", "SyntheticSource", "load_hr_crop",
    "prepare_batch", "resize_bicubic_u8", "subset_indices",
    "train_val_split",
]
