"""Geometry-specific dispersion functions: the slab (`slab`) and the
cylinder (`cylinder`)."""
from . import cylinder, slab  # noqa: F401
