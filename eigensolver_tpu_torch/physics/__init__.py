"""Geometry-specific dispersion functions (cylinder; slab is ROADMAP A3)."""
