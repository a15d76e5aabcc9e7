"""Strand3dFC surface-mesh (.s3d) format (port of
``levelsetfortran_tpu/io/s3d.py``; layout of ``set3d.f90:588-612``)."""

from __future__ import annotations

import numpy as np

from ..utils.profiling import span
from .stl import SurfaceMesh


def write_s3d(path: str, mesh: SurfaceMesh,
              coords: np.ndarray | None = None) -> None:
    """Write mesh connectivity plus (optionally advected) node coordinates."""
    coords = mesh.vertices if coords is None else np.asarray(coords)
    with span("lsf.write_s3d"), open(path, "w") as f:
        f.write(f" {mesh.n_elems} {mesh.n_nodes} {mesh.n_bnd_elem}"
                f" {mesh.bnd_normals.shape[0]}\n")
        for k in range(mesh.n_elems):
            e = mesh.elements[k]
            f.write(f" {mesh.elem_order[k]} {e[0]} {e[1]} {e[2]}"
                    f" {mesh.elem_tag[k]}\n")
        for n in range(mesh.n_nodes):
            x, y, z = coords[n]
            f.write(f" {x:23.16E} {y:23.16E} {z:23.16E}\n")
        for n in range(mesh.bnd_normals.shape[0]):
            x, y, z = mesh.bnd_normals[n]
            f.write(f" {x:23.16E} {y:23.16E} {z:23.16E}\n")


def read_s3d(path: str) -> SurfaceMesh:
    """Read a .s3d file."""
    with open(path) as f:
        rows = [line.split() for line in f if line.strip()]
    n_elems, n_nodes, n_bnd_elem, n_bnd_comp = (int(v) for v in rows[0][:4])
    er = rows[1:1 + n_elems]
    nr = rows[1 + n_elems:1 + n_elems + n_nodes]
    br = rows[1 + n_elems + n_nodes:1 + n_elems + n_nodes + n_bnd_comp]
    bnd = np.array([[float(v) for v in r[:3]] for r in br], dtype=np.float64)
    if bnd.size == 0:
        bnd = np.zeros((1, 3), dtype=np.float64)
    return SurfaceMesh(
        vertices=np.array([[float(v) for v in r[:3]] for r in nr],
                          dtype=np.float64),
        elements=np.array([[int(r[1]), int(r[2]), int(r[3])] for r in er],
                          dtype=np.int32),
        elem_order=np.array([int(r[0]) for r in er], dtype=np.int32),
        elem_tag=np.array([int(r[4]) for r in er], dtype=np.int32),
        bnd_normals=bnd, n_bnd_elem=n_bnd_elem)
