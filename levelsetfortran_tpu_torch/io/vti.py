"""VTK ImageData (.vti) volume writer/reader (port of
``levelsetfortran_tpu/io/vti.py``).

XML ImageData header, then a raw appended payload of Float64 samples in
x-fastest order (``set3d.f90:323-351``).  The writer emits the correct byte
count by default; ``ref_compat=True`` declares the reference's
``(nx+1)**3 * 24`` (``set3d.f90:330``, wrong for non-cubic grids and 3x too
large for cubic ones) so that outputs can be diffed byte for byte against
the reference program's.  The reader sizes the payload from the extent, so
it reads either.
"""

from __future__ import annotations

import re
import struct

import numpy as np
import torch

from ..grid.grid import Grid3D
from ..utils.profiling import count, span

_LF = b"\n"


def _write_framed(path: str, grid: Grid3D, name: str, payload,
                  ref_compat: bool = False) -> None:
    """The XML frame around ``payload``, an iterable of byte chunks (any
    C-contiguous buffer, written as its bytes) that together hold
    ``grid``'s samples as Float64, x fastest."""
    nx, ny, nz = (s - 1 for s in grid.shape)
    extent = f" 0 {nx:6d} 0 {ny:6d} 0 {nz:6d}"
    origin = "".join(f"{v:20.8f} " for v in grid.origin)
    spacing = "".join(f"{grid.dx:20.8f} " for _ in range(3))
    nbyte = ((nx + 1) ** 3 * 24 if ref_compat
             else int(np.prod(grid.shape)) * 8)
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
        for chunk in payload:
            f.write(chunk)
        f.write(_LF + b"</AppendedData>" + _LF)
        f.write(b"</VTKFile>" + _LF)


def write_vti(path: str, phi: np.ndarray, grid: Grid3D, *,
              name: str = "phi", ref_compat: bool = False) -> None:
    """Write a scalar field of shape ``grid.shape`` (axes x, y, z);
    ``ref_compat``: declare the reference's payload byte count.

    A field that lies x fastest in memory (Fortran order, as the
    pipeline's results do) is written from its own memory; any other
    layout is first copied into the payload's order on the host (counted
    in ``vti.host_transposes``, of ``vti.writes``)."""
    with span("lsf.write_vti"):
        phi = np.asarray(phi, dtype=np.float64)
        if phi.shape != grid.shape:
            raise ValueError(f"phi shape {phi.shape} != grid shape "
                             f"{grid.shape}")
        pay = phi.transpose(2, 1, 0)
        in_order = pay.flags.c_contiguous
        count("vti.writes")
        count("vti.host_transposes", int(not in_order))
        if not in_order:
            pay = np.ascontiguousarray(pay)
        _write_framed(path, grid, name, [memoryview(pay)], ref_compat)


def write_vti_streaming(path: str, blocks, grid: Grid3D, mesh, *,
                        name: str = "phi", chunk_z: int = 16) -> None:
    """Write a sharded field (``blocks`` of the shard mesh ``mesh``, device
    tensors) in z-slabs: each slab is assembled on the host from the
    blocks' slices, so the host holds ``nx * ny * chunk_z`` samples at a
    time and the whole field is never gathered.  The bytes equal
    :func:`write_vti` of the gathered field.

    Under a process group (a mesh across processes) every rank calls this:
    the primary writes the file, and for each slab the other ranks send it
    their blocks' slices of that slab, in shard order (the JAX package's
    per-slab cross-host gathers)."""
    import torch.distributed as dist
    from ..parallel.distributed import comm_device
    b = mesh.block_shape(grid.shape)
    if any(x is not None and tuple(x.shape) != b for x in blocks):
        raise ValueError(f"blocks are not {b} blocks of grid {grid.shape}")
    owners = mesh.owners or (0,) * mesh.n_shards
    primary = mesh.rank == 0
    mine = next(x for x in blocks if x is not None)

    def slab(k0, k1):
        """z-slab [k0, k1) on the primary, from every block's slice (the
        other ranks' received from their owners, in shard order); None on
        the other ranks, which send their blocks' slices."""
        out = np.empty(grid.shape[:2] + (k1 - k0,), np.float64) \
            if primary else None
        for tag, (c, x, owner) in enumerate(zip(mesh.coords(), blocks,
                                                owners)):
            oz = c[2] * b[2]
            lo, hi = max(k0, oz), min(k1, oz + b[2])
            if lo >= hi or (x is None and not primary):
                continue
            if x is None:
                part = torch.empty(b[:2] + (hi - lo,), dtype=mine.dtype,
                                   device=comm_device(mine))
                dist.recv(part, owner, tag=tag)
            else:
                part = x[:, :, lo - oz:hi - oz].detach()
                if not primary:
                    dist.send(part.to(comm_device(part)).contiguous(), 0,
                              tag=tag)
                    continue
            ox, oy = c[0] * b[0], c[1] * b[1]
            out[ox:ox + b[0], oy:oy + b[1], lo - k0:hi - k0] = (
                part.to("cpu", torch.float64).numpy())
        return out

    def slabs():
        for k0 in range(0, grid.shape[2], chunk_z):
            s = slab(k0, min(k0 + chunk_z, grid.shape[2]))
            if s is not None:
                # payload is x-fastest: (x, y, zc) -> (zc, y, x), C order
                yield np.ascontiguousarray(s.transpose(2, 1, 0)).tobytes()

    if primary:
        _write_framed(path, grid, name, slabs())
    else:
        for _ in slabs():
            pass


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
