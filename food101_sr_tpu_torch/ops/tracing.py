"""Helpers for code that ``torch.export`` traces.

An export runs the Python code of a forward on fake tensors under the
tracer's dispatch modes. A cache that builds a tensor on its first call
would keep a fake one if that first call fell inside a trace, and hand it
to every later eager call (or to the next export, which refuses it as a
constant). :func:`outside_trace` lets such a cache build real tensors
whatever the caller is doing; a tensor made there and used in a trace
becomes a constant of the exported program.
"""
from __future__ import annotations

import contextlib

from torch.utils._python_dispatch import _disable_current_modes


@contextlib.contextmanager
def outside_trace():
    """Within the block, tensors are real: the dispatch modes of a trace
    in progress (fake tensors, the tracer's proxies) are off, and come
    back on exit. Outside a trace the block runs as it is."""
    with _disable_current_modes():
        yield
