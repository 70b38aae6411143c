"""Hand-written CUDA kernels for Hopper, built with nvcc at first use."""
