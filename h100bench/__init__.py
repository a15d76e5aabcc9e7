"""The H100 benchmark of the PyTorch and CUDA port,
``levelsetfortran_tpu_torch``: run one cell with ``python -m
h100bench.run``.  Imports neither JAX nor the JAX package."""
