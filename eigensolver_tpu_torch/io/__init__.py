"""File output of synthesized fields (VTK)."""
