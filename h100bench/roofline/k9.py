"""K9, the reference-mode init's nearest-centroid search
(``ops/init_sign.py:nearest_centroid``): its kernels are those launched
inside the program's span ``lsf.init.reference.nearest``, whatever
implements the search.

Work: every (point of the init's box, triangle centroid) pair once.  Per
pair, from ``nearest_centroid``: the dot product p.c, 3 products and 2
sums (5); ``|c|^2 - 2 dot``, a product and a difference (2); the compare
against the least term so far (1): 8 float operations (``|c|^2`` is once
a centroid, not a pair).  Bytes: the points and the centroids read once
(12 each), one index written a point (8).
"""

from __future__ import annotations

import math

from h100bench.reference import geometry, refinit

from . import bound_s as _bound

SPAN = "lsf.init.reference.nearest"
OPS_PER_PAIR = 8


def sizes(soup, dx: float, pad_cells: int) -> tuple:
    """(the box's points, the centroids) of one mesh on its
    ``from_surface`` grid."""
    verts, elems = geometry.soup_mesh(soup)
    grid = geometry.from_surface(verts, dx, pad_cells)
    box = refinit.subbox(grid, verts)
    return math.prod(i1 - i0 + 1 for i0, i1 in box), len(elems)


def pairs(soup, dx: float, pad_cells: int) -> int:
    points, centroids = sizes(soup, dx, pad_cells)
    return points * centroids


def bound_s(points: int, centroids: int) -> float:
    return _bound(ops=OPS_PER_PAIR * points * centroids,
                  nbytes=12 * (points + centroids) + 8 * points)
