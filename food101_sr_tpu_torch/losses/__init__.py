from .nlpd import laplacian_pyramid, nlpd_loss

__all__ = ["laplacian_pyramid", "nlpd_loss"]
