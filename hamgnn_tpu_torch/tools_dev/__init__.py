"""Developer probes: per-primitive Hopper kernels held against plain PyTorch."""
