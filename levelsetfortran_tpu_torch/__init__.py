"""levelsetfortran_tpu_torch — the level-set engine on PyTorch and CUDA.

The single-device pipeline of ``levelsetfortran_tpu`` (STL -> exact
signed-distance init -> WENO5/Godunov reinitialization -> min/max
curvature-flow smoothing -> surface-node advection -> .vti/.s3d outputs)
ported to PyTorch, with the TPU's Pallas kernels rewritten by hand in CUDA
for Hopper (``csrc/``).  Imports neither JAX nor the JAX package.
"""

from .config import LevelSetConfig, QuirkConfig, REFERENCE_PARITY
from .grid.grid import Grid3D, from_bbox, from_surface
from .io.s3d import read_s3d, write_s3d
from .io.stl import SurfaceMesh, read_stl, write_stl
from .io.vti import read_vti, write_vti
from .pipeline.run import run, run_mesh

__version__ = "0.1.0"
