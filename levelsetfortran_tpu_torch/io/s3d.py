"""Strand3dFC surface-mesh (.s3d) format (port of
``levelsetfortran_tpu/io/s3d.py``; layout of ``set3d.f90:588-612``)."""

from __future__ import annotations

import numpy as np

from ..utils.profiling import count, span
from .stl import SurfaceMesh

#: Rows formatted by one ``%`` call: bounds the tuple and the string a
#: block builds, whatever the mesh's size.  Any value gives the same bytes.
_ROWS = 1 << 16
_ELEM_LINE = " %d %d %d %d %d\n"
_XYZ_LINE = " %23.16E %23.16E %23.16E\n"


def _write_rows(f, line: str, rows: np.ndarray, dtype) -> int:
    """Write ``line % row`` for every row of ``rows`` (cast to ``dtype``
    unless it is None), a block of ``_ROWS`` rows per format call and per
    file write; return the number of blocks."""
    blocks = 0
    for i in range(0, rows.shape[0], _ROWS):
        block = np.asarray(rows[i:i + _ROWS], dtype=dtype)
        f.write((line * block.shape[0]) % tuple(block.ravel().tolist()))
        blocks += 1
    return blocks


def write_s3d(path: str, mesh: SurfaceMesh,
              coords: np.ndarray | None = None) -> None:
    """Write mesh connectivity plus (optionally advected) node coordinates.

    ``"%23.16E" % x`` is CPython's formatter of ``f"{x:23.16E}"`` (NaN,
    infinities and signed zeros alike), and a float32 widens to float64
    exactly, so the bytes are those of one formatted line per row."""
    coords = mesh.vertices if coords is None else np.asarray(coords)
    n_elems, n_nodes = mesh.n_elems, mesh.n_nodes
    with span("lsf.write_s3d"), open(path, "w") as f:
        f.write(f" {n_elems} {n_nodes} {mesh.n_bnd_elem}"
                f" {mesh.bnd_normals.shape[0]}\n")
        elems = np.column_stack((mesh.elem_order[:n_elems], mesh.elements,
                                 mesh.elem_tag[:n_elems]))
        blocks = (_write_rows(f, _ELEM_LINE, elems, None)
                  + _write_rows(f, _XYZ_LINE, coords[:n_nodes], np.float64)
                  + _write_rows(f, _XYZ_LINE, mesh.bnd_normals, np.float64))
        count("s3d.writes")
        count("s3d.blocks", blocks)


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
