"""Domain decomposition: a 3-D grid cut into blocks over a logical mesh of
shards, in one process or across several (port of
``levelsetfortran_tpu/parallel``)."""

from .distributed import init_distributed, is_primary
from .mesh import ShardMesh, make_mesh
from .sharded import ShardedLevelSet, dryrun
