"""The bodies the configurations name, their seeded variants, and the STL
files the jobs read.

The generators are frozen numpy copies of the program's procedural meshes
(an icosphere, a triangulated box, the twin of the upstream sample
``twoCube10.stl``), returned as float32 triangle soups: what an STL file
holds.  A job's body is the base body scaled about its bounding-box
centre and, where the traffic lets it turn, rotated about a seeded
axis.  The scales of a pool are fixed points of the traffic's range, so
every seed does the same work; the seed orders them within small blocks
and draws the axes and the angles.
"""

from __future__ import annotations

import struct

import numpy as np

_BOX_FACES = [(0, -1), (0, 1), (1, -1), (1, 1), (2, -1), (2, 1)]


def box_soup(center=(0.0, 0.0, 0.0), half=(1.0, 1.0, 1.0), subdiv=1):
    """Outward-oriented box with ``subdiv`` quads per edge: (2 * 6 *
    subdiv^2, 3, 3) float32."""
    c = np.asarray(center, np.float64)
    h = np.asarray(half, np.float64)
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
    return np.asarray(tris, np.float32)


def icosphere_soup(center=(0.0, 0.0, 0.0), radius=1.0, subdivisions=2):
    """Subdivided icosahedron on the sphere, outward-oriented (5
    subdivisions: 20,480 triangles)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(int(subdivisions)):
        mids, vl, new = {}, list(verts), []

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in mids:
                m = (vl[i] + vl[j]) / 2.0
                mids[key] = len(vl)
                vl.append(m / np.linalg.norm(m))
            return mids[key]

        for a, b, c in faces.tolist():
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts, faces = np.asarray(vl), np.asarray(new, np.int64)
    verts = np.asarray(center) + radius * verts
    return verts[faces].astype(np.float32)


def two_cubes_soup(spacing=10.0, size=1.0, subdiv=1):
    """Two cubes ``spacing`` apart along x: the twin of twoCube10.stl."""
    h = size / 2.0
    return np.concatenate([
        box_soup((h, h, h), (h, h, h), subdiv),
        box_soup((spacing + size + h, h, h), (h, h, h), subdiv)])


GENERATORS = {"icosphere": icosphere_soup, "two_cubes": two_cubes_soup}


def base_soup(body: dict):
    """The configuration's body: ``{"generator": name, **its arguments}``."""
    kw = {k: v for k, v in body.items() if k != "generator"}
    return GENERATORS[body["generator"]](**kw)


def transform(soup, scale: float, axis, angle: float):
    """``soup`` scaled by ``scale`` and rotated by ``angle`` (radians)
    about ``axis``, both about its bounding-box centre; float32."""
    pts = np.asarray(soup, np.float64).reshape(-1, 3)
    c = (pts.min(0) + pts.max(0)) / 2.0
    k = np.asarray(axis, np.float64)
    k = k / np.linalg.norm(k)
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    rot = np.eye(3) + np.sin(angle) * kx + (1 - np.cos(angle)) * kx @ kx
    out = c + scale * (pts - c) @ rot.T
    return out.astype(np.float32).reshape(np.shape(soup))


def _bit_reversed(n: int) -> np.ndarray:
    bits = max(1, (n - 1).bit_length())
    order = [int(format(i, f"0{bits}b")[::-1], 2) for i in range(1 << bits)]
    return np.asarray([o for o in order if o < n])


def variants(seed: int, n: int, scale_range, rotate_deg: float,
             block: int = 4) -> list:
    """``n`` (scale, axis, angle) for the pool, and one more for the
    warm-up at the top of the range.  The scales are the midpoints of ``n``
    strata of the range, in bit-reversed order, so any run of jobs spreads
    over the range; the seed shuffles them within consecutive blocks of
    ``block`` and draws the axes and the angles, so every seed does the
    same work."""
    rng = np.random.default_rng(np.random.SeedSequence(
        int(seed) & (2 ** 128 - 1)))
    lo, hi = (float(x) for x in scale_range)
    strata = _bit_reversed(n)
    order = np.concatenate([rng.permutation(strata[b:b + block])
                            for b in range(0, n, block)])
    out = []
    for k in range(n + 1):
        axis = rng.normal(size=3)
        angle = np.deg2rad(rotate_deg) * rng.random()
        s = hi if k == n else lo + (hi - lo) * (order[k] + 0.5) / n
        out.append((float(s), axis, float(angle)))
    return out


def write_stl(path: str, soup) -> None:
    """A binary STL of a float32 soup, facet normals from the vertices."""
    tris = np.asarray(soup, np.float32).reshape(-1, 3, 3)
    n = tris.shape[0]
    nrm = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    mag = np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm = np.where(mag > 0, nrm / np.maximum(mag, 1e-30), 0.0)
    rec = np.zeros((n, 50), np.uint8)
    payload = np.concatenate([nrm, tris.reshape(n, 9)], axis=1).astype("<f4")
    rec[:, :48] = payload.view(np.uint8).reshape(n, 48)
    with open(path, "wb") as f:
        f.write(b"h100bench".ljust(80, b" "))
        f.write(struct.pack("<i", n))
        f.write(rec.tobytes())
