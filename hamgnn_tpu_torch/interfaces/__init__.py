"""Interfaces to other formats: flax parameters, PyG pickles, and the DFT codes'
containers (OpenMX SCFOUT, SIESTA HSX, ABACUS CSR) with their native readers."""
