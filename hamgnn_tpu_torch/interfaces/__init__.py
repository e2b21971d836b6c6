"""Interfaces to other formats (flax parameters, PyG pickles)."""
