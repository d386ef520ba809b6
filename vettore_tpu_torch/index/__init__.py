"""Device-resident acceleration indexes (rebuildable from the canonical store)."""

from .base import Index
from .flat import FlatIndex

__all__ = ["Index", "FlatIndex"]
