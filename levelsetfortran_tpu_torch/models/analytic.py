"""Analytic signed-distance fields and procedural test meshes, in numpy
(port of ``levelsetfortran_tpu/models/analytic.py``).

The SDFs are the oracles of the tests and of ``chip_smoke.py``; the mesh
functions give STL-equivalent triangle soups (including the twin of the
reference's twoCube10.stl fixture) without binary blobs in the repo.
"""

from __future__ import annotations

import numpy as np

from ..io.stl import SurfaceMesh, _finish


def sdf_sphere(p: np.ndarray, center, radius) -> np.ndarray:
    return np.sqrt(np.sum((p - np.asarray(center)) ** 2, axis=-1)) - radius


def sdf_box(p: np.ndarray, center, half_extent) -> np.ndarray:
    """Exact box SDF (negative inside)."""
    q = np.abs(p - np.asarray(center)) - np.asarray(half_extent)
    outside = np.sqrt(np.sum(np.maximum(q, 0.0) ** 2, axis=-1))
    inside = np.minimum(np.max(q, axis=-1), 0.0)
    return outside + inside


def sdf_torus(p: np.ndarray, center, major, minor) -> np.ndarray:
    q = p - np.asarray(center)
    ring = np.sqrt(q[..., 0] ** 2 + q[..., 1] ** 2) - major
    return np.sqrt(ring ** 2 + q[..., 2] ** 2) - minor


def sdf_union(*sdfs):
    out = sdfs[0]
    for s in sdfs[1:]:
        out = np.minimum(out, s)
    return out


def sdf_two_cubes(p: np.ndarray, spacing: float = 10.0,
                  size: float = 1.0) -> np.ndarray:
    """Two cubes ``spacing`` apart along x: the twoCube10.stl twin's SDF."""
    h = size / 2.0
    a = sdf_box(p, (h, h, h), (h, h, h))
    b = sdf_box(p, (spacing + size + h, h, h), (h, h, h))
    return sdf_union(a, b)


_BOX_FACES = [(0, -1), (0, 1), (1, -1), (1, 1), (2, -1), (2, 1)]


def box_mesh(center=(0.0, 0.0, 0.0), half_extent=(1.0, 1.0, 1.0),
             subdiv: int = 1, *, subdivisions: int | None = None
             ) -> SurfaceMesh:
    """Outward-oriented triangulated box with ``subdiv`` quads per edge."""
    if subdivisions is not None:
        subdiv = int(subdivisions)
    c = np.asarray(center, dtype=np.float64)
    h = np.asarray(half_extent, dtype=np.float64)
    tris = []
    for axis, side in _BOX_FACES:
        u_axis, v_axis = [a for a in range(3) if a != axis]
        us = np.linspace(-h[u_axis], h[u_axis], subdiv + 1)
        vs = np.linspace(-h[v_axis], h[v_axis], subdiv + 1)
        for iu in range(subdiv):
            for iv in range(subdiv):
                quad = []
                for du, dv in [(0, 0), (1, 0), (1, 1), (0, 1)]:
                    p = np.zeros(3)
                    p[axis] = side * h[axis]
                    p[u_axis] = us[iu + du]
                    p[v_axis] = vs[iv + dv]
                    quad.append(c + p)
                if (side > 0) == (axis != 1):
                    tris += [[quad[0], quad[1], quad[2]],
                             [quad[0], quad[2], quad[3]]]
                else:
                    tris += [[quad[0], quad[2], quad[1]],
                             [quad[0], quad[3], quad[2]]]
    return _finish(np.asarray(tris, dtype=np.float32).reshape(-1, 3))


def icosphere_mesh(center=(0.0, 0.0, 0.0), radius: float = 1.0,
                   subdiv: int = 2, *, subdivisions: int | None = None
                   ) -> SurfaceMesh:
    """Subdivided icosahedron projected to a sphere, outward-oriented
    (``subdiv`` 5 gives 20,480 triangles)."""
    if subdivisions is not None:
        subdiv = int(subdivisions)
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], dtype=np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], dtype=np.int64)
    for _ in range(subdiv):
        new_faces = []
        mids = {}
        verts_list = list(verts)

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in mids:
                m = (verts_list[i] + verts_list[j]) / 2.0
                m /= np.linalg.norm(m)
                mids[key] = len(verts_list)
                verts_list.append(m)
            return mids[key]

        for f in faces:
            a, b, c2 = (int(v) for v in f)
            ab, bc, ca = midpoint(a, b), midpoint(b, c2), midpoint(c2, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c2, ca, bc],
                          [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, dtype=np.int64)
    verts = np.asarray(center) + radius * verts
    return _finish(verts[faces].reshape(-1, 3).astype(np.float32))


def two_cubes_mesh(spacing: float = 10.0, size: float = 1.0,
                   subdiv: int = 1) -> SurfaceMesh:
    """Two cubes spaced along x — procedural twin of twoCube10.stl."""
    h = size / 2.0
    a = box_mesh((h, h, h), (h, h, h), subdiv)
    b = box_mesh((spacing + size + h, h, h), (h, h, h), subdiv)
    tri_a = a.vertices[a.elements].reshape(-1, 3)
    tri_b = b.vertices[b.elements].reshape(-1, 3)
    return _finish(np.concatenate([tri_a, tri_b]).astype(np.float32))
