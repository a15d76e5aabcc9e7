"""K7, the exact-distance init's selection scan (``init_select_kernel``).

Work: every (grid point, candidate triangle) pair of the 16^3-block
culling of the mesh (:func:`..reference.geometry.culling_rows`), each
pair one evaluation of the region-based distance and the tie test: the
four dot products (20), d1..d6 (6), va, vb, vc (9), the region tests (17),
the region's distance and its clamp (8), the running minimum (2), the tie
test and its term (8): 70 float operations.  Bytes are a few per
candidate and bound nothing.
"""

from __future__ import annotations

from h100bench.reference import geometry

from . import bound_s as _bound

KERNELS = ("init_select_kernel",)
OPS_PER_PAIR = 70


def pairs(soup, dx: float, pad_cells: int, block: int = 16) -> int:
    """The pairs of one mesh's init on its ``from_surface`` grid."""
    verts, elems = geometry.soup_mesh(soup)
    grid = geometry.from_surface(verts, dx, pad_cells)
    return geometry.culling_rows(grid, verts, elems, block=block).pairs


def bound_s(n_pairs: int) -> float:
    return _bound(ops=OPS_PER_PAIR * n_pairs)
