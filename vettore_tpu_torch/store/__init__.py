"""Canonical host-side record stores.

The canonical store is host memory (:class:`MemoryStore`); device tensors
are always rebuildable from it.
"""

from .base import Store
from .memory import MemoryStore

__all__ = ["Store", "MemoryStore"]
