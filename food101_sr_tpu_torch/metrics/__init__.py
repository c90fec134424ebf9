from .metrics import LPIPSAlex, MetricsCalculator, psnr, ssim

__all__ = ["LPIPSAlex", "MetricsCalculator", "psnr", "ssim"]
