"""Hand-written Hopper kernels of the port, with their plain versions.

``ops`` is the public entry: a CUDA tensor goes to the kernel, a CPU
tensor to the plain PyTorch version in ``ref``.
"""
