"""Grid operators, the init, and the CUDA kernel wrappers."""
