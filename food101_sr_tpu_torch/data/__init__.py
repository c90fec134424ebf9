from .pipeline import prepare_batch

__all__ = ["prepare_batch"]
