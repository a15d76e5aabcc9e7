"""levelsetfortran_tpu_torch — the level-set engine on PyTorch and CUDA.

The single-device pipeline of ``levelsetfortran_tpu`` (STL -> exact
signed-distance init -> WENO5/Godunov reinitialization -> min/max
curvature-flow smoothing -> surface-node advection -> .vti/.s3d outputs)
and its differentiable path (rendered pixels -> STL vertex gradients)
ported to PyTorch, with the TPU's Pallas kernels rewritten by hand in CUDA
for Hopper (``csrc/``); ``run_batch`` serves several geometries through the
solver stages together (the kernels' pack modes, optionally in shares over
the cards); ``parallel`` cuts a grid into blocks over a shard mesh, in one
process or across several.  Imports neither JAX nor the JAX package.
The solvers and the sharded solver are lazy top-level names, as in the JAX
package.
"""

from .config import LevelSetConfig, QuirkConfig, REFERENCE_PARITY
from .grid.grid import Grid3D, from_bbox, from_surface
from .io.s3d import read_s3d, write_s3d
from .io.stl import SurfaceMesh, read_stl, write_stl
from .io.vti import read_vti, write_vti
from .pipeline.batch import BatchItem, run_batch
from .pipeline.differentiable import (image_loss_and_vertex_grad,
                                      render_from_vertices)
from .pipeline.run import run, run_mesh

__version__ = "0.1.0"


def __getattr__(name):
    if name == "reinit":
        from .solvers.reinit import reinit
        return reinit
    if name == "minmax_flow":
        from .solvers.minmax_flow import minmax_flow
        return minmax_flow
    if name == "advect_nodes":
        from .solvers.advect import advect_nodes
        return advect_nodes
    if name == "ShardedLevelSet":
        from .parallel.sharded import ShardedLevelSet
        return ShardedLevelSet
    raise AttributeError(name)
