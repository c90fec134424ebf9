from .logging import RunLogger

__all__ = ["RunLogger"]
