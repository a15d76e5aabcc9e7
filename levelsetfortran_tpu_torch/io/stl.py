"""STL triangle-mesh reading/writing (port of ``levelsetfortran_tpu/io/stl.py``).

Binary STL: an 80-byte header, an int32 triangle count, then per triangle
12 float32s (normal + 3 vertices) and a 2-byte pad (``subs.f90:17-121``).
Shared vertices are deduplicated by exact float32 bit pattern, keeping
first-occurrence order — the reference's numbering at its 1e-13 tolerance.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np


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


def _dedup_vertices(tri_verts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """First-occurrence-order exact-bit dedup of (n, 3) float32 rows."""
    as_void = np.ascontiguousarray(tri_verts).view(
        np.dtype((np.void, tri_verts.dtype.itemsize * 3))).ravel()
    _, first_idx, inverse = np.unique(as_void, return_index=True,
                                      return_inverse=True)
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    return tri_verts[first_idx[order]], rank[inverse].astype(np.int32)


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
    with open(path, "rb") as f:
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
