from .metrics import MetricsCalculator, psnr, ssim

__all__ = ["MetricsCalculator", "psnr", "ssim"]
