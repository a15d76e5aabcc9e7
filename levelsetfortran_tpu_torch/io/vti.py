"""VTK ImageData (.vti) volume writer/reader (port of
``levelsetfortran_tpu/io/vti.py``).

XML ImageData header, then a raw appended payload of Float64 samples in
x-fastest order (``set3d.f90:323-351``).  The writer emits the correct byte
count (not the reference's ``(nx+1)**3 * 24`` quirk); the reader sizes the
payload from the extent, so it reads either.
"""

from __future__ import annotations

import re
import struct

import numpy as np

from ..grid.grid import Grid3D

_LF = b"\n"


def write_vti(path: str, phi: np.ndarray, grid: Grid3D, *,
              name: str = "phi") -> None:
    """Write a scalar field of shape ``grid.shape`` (axes x, y, z)."""
    nx, ny, nz = (s - 1 for s in grid.shape)
    phi = np.asarray(phi, dtype=np.float64)
    if phi.shape != grid.shape:
        raise ValueError(f"phi shape {phi.shape} != grid shape {grid.shape}")
    extent = f" 0 {nx:6d} 0 {ny:6d} 0 {nz:6d}"
    origin = "".join(f"{v:20.8f} " for v in grid.origin)
    spacing = "".join(f"{grid.dx:20.8f} " for _ in range(3))
    nbyte = phi.size * 8
    payload = np.ascontiguousarray(phi.transpose(2, 1, 0)).tobytes()
    with open(path, "wb") as f:
        f.write(b'<?xml version="1.0"?>' + _LF)
        f.write(b'<VTKFile type="ImageData" version="0.1" '
                b'byte_order="LittleEndian">' + _LF)
        f.write(f'<ImageData WholeExtent="{extent}" Origin="{origin.rstrip()}" '
                f'Spacing="{spacing.rstrip()}">'.encode() + _LF)
        f.write(f'<Piece Extent="{extent}">'.encode() + _LF)
        f.write(f'<PointData Scalars="{name}">'.encode() + _LF)
        f.write(f'<DataArray type="Float64" Name="{name}" format="appended" '
                f'offset="{0:16d}"/>'.encode() + _LF)
        f.write(b"</PointData>" + _LF)
        f.write(b"</Piece>" + _LF)
        f.write(b"</ImageData>" + _LF)
        f.write(b'<AppendedData encoding="raw">' + _LF)
        f.write(b"_")
        f.write(struct.pack("<i", nbyte))
        f.write(payload)
        f.write(_LF + b"</AppendedData>" + _LF)
        f.write(b"</VTKFile>" + _LF)


def read_vti(path: str) -> tuple[np.ndarray, Grid3D]:
    """Read a .vti written by this module, the JAX package or the reference."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.index(b'<AppendedData encoding="raw">')
    header = data[:header_end].decode("ascii", errors="replace")
    m = re.search(r'WholeExtent="\s*(-?\d+)\s+(-?\d+)\s+(-?\d+)\s+(-?\d+)'
                  r'\s+(-?\d+)\s+(-?\d+)"', header)
    if not m:
        raise ValueError("no WholeExtent in vti header")
    x0, x1, y0, y1, z0, z1 = map(int, m.groups())
    shape = (x1 - x0 + 1, y1 - y0 + 1, z1 - z0 + 1)
    mo = re.search(r'Origin="([^"]*)"', header)
    ms = re.search(r'Spacing="([^"]*)"', header)
    origin = tuple(float(v) for v in mo.group(1).split()) if mo else (0.0,) * 3
    spacing = tuple(float(v) for v in ms.group(1).split()) if ms else (1.0,) * 3
    start = data.index(b"_", header_end) + 1 + 4   # skip declared byte count
    n = shape[0] * shape[1] * shape[2]
    payload = np.frombuffer(data, dtype="<f8", count=n, offset=start)
    phi = payload.reshape(shape[2], shape[1], shape[0]).transpose(2, 1, 0)
    return np.ascontiguousarray(phi), Grid3D(shape=shape, origin=origin,
                                             dx=spacing[0])
