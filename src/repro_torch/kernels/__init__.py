"""Hand-written Hopper kernels (CUDA C++ under csrc/) with their plain
PyTorch versions."""
