"""Geometry-specific dispersion functions: the slab (`slab`) and the
cylinder (`cylinder`)."""
