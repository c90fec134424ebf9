from .gaussian import depthwise_blur, gaussian_kernel_2d
from .pallas_blur import blur, blur_kernel, depthwise_blur_fast
from .precision import full_fp32
from .resize import (degrade_bicubic, resample_matrix, resize2d,
                     resize_bicubic_torch, resize_bilinear_torch)
from .spatial_mean import (kernel_layout, mean_kernel, mean_nhwc_kernel,
                           mean_plane_kernel, spatial_mean_plain)

__all__ = [
    "blur", "blur_kernel", "degrade_bicubic", "depthwise_blur",
    "depthwise_blur_fast", "full_fp32", "gaussian_kernel_2d",
    "kernel_layout", "mean_kernel", "mean_nhwc_kernel", "mean_plane_kernel",
    "resample_matrix", "resize2d", "resize_bicubic_torch",
    "resize_bilinear_torch", "spatial_mean_plain",
]
