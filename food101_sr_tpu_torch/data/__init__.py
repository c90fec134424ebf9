from .canvas_cache import CanvasStore, DeviceWindowLoader, HostCanvasLoader
from .device_cache import DeviceCacheLoader, build_canvas_cache
from .pil_bicubic import resize_bicubic_u8
from .pipeline import (SRDataLoader, load_hr_crop, load_sample,
                       prepare_batch, process_local_slice, subset_indices,
                       train_val_split)
from .sources import Food101Source, SyntheticSource

__all__ = [
    "CanvasStore", "DeviceCacheLoader", "DeviceWindowLoader",
    "Food101Source", "HostCanvasLoader", "SRDataLoader", "SyntheticSource",
    "build_canvas_cache", "load_hr_crop",
    "load_sample", "prepare_batch", "process_local_slice",
    "resize_bicubic_u8", "subset_indices",
    "train_val_split",
]
