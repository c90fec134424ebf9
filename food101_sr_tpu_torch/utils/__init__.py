from .logging import RunLogger
from .rng import keyed_generator

__all__ = ["RunLogger", "keyed_generator"]
