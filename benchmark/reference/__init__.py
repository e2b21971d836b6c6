"""The plain reference of the benchmark's configurations: HamGNN's ConvE3
representation, the OpenMX non-SOC and SOC heads, the masked losses and
amsgrad, in plain PyTorch and float32 with no CUDA kernel.

Frozen copies of the port's plain model path (each file names its source),
with the kernel dispatch, the halo partition, the band branch and the
precision switches taken out.  It imports nothing of the program: the
benchmark gives both the same inputs and weights, and this package works out
again every table the program derives (coupling tensors, plans, merge
matrices, basis tables).
"""
