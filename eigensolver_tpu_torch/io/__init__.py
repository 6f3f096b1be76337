"""File output of synthesized fields (VTK)."""
from . import vtk  # noqa: F401
from ..roots import load_pickle, save_pickle  # noqa: F401  (re-export)
