"""STL triangle-mesh reading/writing (port of ``levelsetfortran_tpu/io/stl.py``).

Binary STL: an 80-byte header, an int32 triangle count, then per triangle
12 float32s (normal + 3 vertices) and a 2-byte pad (``subs.f90:17-121``).
Shared vertices are deduplicated at the reference's per-coordinate
tolerance of 1e-13, keeping first-occurrence order — the reference's
numbering, and the JAX package's native spatial hash's.
"""

from __future__ import annotations

import dataclasses
import itertools
import struct

import numpy as np

from ..utils.profiling import span


@dataclasses.dataclass(frozen=True)
class SurfaceMesh:
    """Deduplicated triangle surface mesh with 0-based connectivity."""

    vertices: np.ndarray      # (n_nodes, 3) float64
    elements: np.ndarray      # (n_elems, 3) int32, 0-based
    elem_order: np.ndarray    # (n_elems,) int32  (reference: all 1)
    elem_tag: np.ndarray      # (n_elems,) int32  (reference: all 0)
    bnd_normals: np.ndarray   # (n_bnd_comp, 3) float64 (reference: zeros)
    n_bnd_elem: int = 0

    @property
    def n_nodes(self) -> int:
        return self.vertices.shape[0]

    @property
    def n_elems(self) -> int:
        return self.elements.shape[0]

    def centroids(self) -> np.ndarray:
        """Per-triangle centroids (reference set3d.f90:199-215)."""
        return self.vertices[self.elements].mean(axis=1)

    def bbox(self):
        return self.vertices.min(axis=0), self.vertices.max(axis=0)


#: The reference's per-coordinate dedup tolerance (subs.f90:79-81).
DEDUP_TOL = 1e-13


def _dedup_vertices(tri_verts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """First-occurrence-order dedup of (n, 3) float32 rows: rows whose
    coordinates all agree within ``DEDUP_TOL`` (``|a - b| <= 1e-13``, the
    reference's linear scan, ``subs.f90:69-93``) are one vertex, numbered
    by and holding the bits of its first occurrence — the JAX package's
    native spatial hash (``native/stl_dedup.cpp``), so -0.0 merges with
    +0.0.

    A float32 coordinate of magnitude >= 2^-19 lies within the tolerance
    only of itself (the spacing of float32 is wider there), so two rows
    can merge only where they agree exactly on such coordinates and both
    are below 2^-19 on the rest.  Rows are therefore grouped by their
    coordinates with those below 2^-19 set to 0, and the groups do not
    interact.  A group whose small coordinates are all zeros is one vertex,
    made by its first row (one vectorised pass); only a group holding a
    nonzero coordinate below 2^-19 takes the hash's own loop
    (:func:`_dedup_tolerance`), and a row with a NaN (within the tolerance
    of nothing) is a vertex of its own."""
    rows = np.ascontiguousarray(tri_verts, np.float32)
    n = len(rows)
    small = np.abs(rows) < 2.0 ** -19
    nan = np.isnan(rows).any(axis=1)
    key = np.where(small, np.float32(0.0), rows)
    as_void = key.view(np.dtype((np.void, key.dtype.itemsize * 3))).ravel()
    _, first_idx, group = np.unique(as_void, return_index=True,
                                    return_inverse=True)
    group = group.reshape(-1)
    maker = first_idx[group]                 # the row that makes its vertex
    maker[nan] = np.flatnonzero(nan)
    loose = np.unique(group[(small & (rows != 0)).any(axis=1) & ~nan])
    if loose.size:
        members = np.flatnonzero(np.isin(group, loose) & ~nan)
        order = members[np.argsort(group[members], kind="stable")]
        cuts = np.flatnonzero(np.diff(group[order])) + 1
        for idx in np.split(order, cuts):
            first, inverse = _dedup_tolerance(rows[idx])
            maker[idx] = idx[np.asarray(first)[inverse]]
    makers = np.unique(maker)
    rank = np.empty(n, np.int64)
    rank[makers] = np.arange(makers.size)
    return rows[makers], rank[maker].astype(np.int32)


def _dedup_tolerance(rows: np.ndarray) -> tuple[list, np.ndarray]:
    """The native hash's loop (``stl_dedup.cpp:45-95``): each point probes
    the 27 tolerance-sized cells around its own for the first earlier
    vertex within the tolerance, else becomes a new vertex.  Returns the
    rows that made vertices and each row's vertex."""
    pts = rows.astype(np.float64)
    cells = np.floor(pts * (1.0 / DEDUP_TOL))
    buckets, first, inverse = {}, [], np.empty(len(pts), np.int64)
    for i, (p, c) in enumerate(zip(pts, cells)):
        found = -1
        for d in itertools.product((-1, 0, 1), repeat=3):
            for j in buckets.get(tuple(c + d), ()):
                if (np.abs(pts[first[j]] - p) <= DEDUP_TOL).all():
                    found = j
                    break
            if found >= 0:
                break
        if found < 0:
            found = len(first)
            first.append(i)
            buckets.setdefault(tuple(c), []).append(found)
        inverse[i] = found
    return first, inverse


def _finish(tri_verts: np.ndarray) -> SurfaceMesh:
    ntri = tri_verts.shape[0] // 3
    verts, inverse = _dedup_vertices(np.asarray(tri_verts, np.float32))
    return SurfaceMesh(
        vertices=verts.astype(np.float64),
        elements=inverse.reshape(ntri, 3),
        elem_order=np.ones(ntri, dtype=np.int32),        # subs.f90:114
        elem_tag=np.zeros(ntri, dtype=np.int32),         # subs.f90:115
        bnd_normals=np.zeros((1, 3), dtype=np.float64),  # subs.f90:117-118
        n_bnd_elem=0,
    )


def read_stl(path: str) -> SurfaceMesh:
    """Read a binary or ASCII STL file into a deduplicated SurfaceMesh."""
    with span("lsf.read_stl"), open(path, "rb") as f:
        head = f.read(5)
        f.seek(0)
        if head == b"solid":
            probe = f.read(512)
            f.seek(0)
            if b"facet" in probe:
                return _read_ascii(f)
        return _read_binary(f)


def _read_binary(f) -> SurfaceMesh:
    f.read(80)
    (ntri,) = struct.unpack("<i", f.read(4))
    raw = np.frombuffer(f.read(ntri * 50), dtype=np.uint8)
    if raw.size != ntri * 50:
        raise ValueError(f"truncated STL: expected {ntri} triangles")
    floats = raw.reshape(ntri, 50)[:, :48].copy().view("<f4").reshape(ntri, 12)
    return _finish(floats[:, 3:12].reshape(ntri * 3, 3))


def _read_ascii(f) -> SurfaceMesh:
    verts = []
    for line in f.read().decode("ascii", errors="replace").splitlines():
        parts = line.split()
        if len(parts) == 4 and parts[0] == "vertex":
            verts.append([float(p) for p in parts[1:]])
    tri_verts = np.asarray(verts, dtype=np.float32)
    if tri_verts.shape[0] % 3 != 0:
        raise ValueError("ASCII STL vertex count not a multiple of 3")
    return _finish(tri_verts)


def write_stl(path: str, mesh: SurfaceMesh) -> None:
    """Write a binary STL (inverse of :func:`read_stl`)."""
    tris = mesh.vertices[mesh.elements].astype(np.float32)  # (n, 3, 3)
    n = tris.shape[0]
    nrm = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    mag = np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm = np.where(mag > 0, nrm / np.maximum(mag, 1e-30), 0.0).astype(
        np.float32)
    rec = np.zeros((n, 50), dtype=np.uint8)
    payload = np.concatenate([nrm, tris.reshape(n, 9)], axis=1).astype("<f4")
    rec[:, :48] = payload.view(np.uint8).reshape(n, 48)
    with open(path, "wb") as f:
        f.write(b"levelsetfortran_tpu_torch binary stl".ljust(80, b" "))
        f.write(struct.pack("<i", n))
        f.write(rec.tobytes())
