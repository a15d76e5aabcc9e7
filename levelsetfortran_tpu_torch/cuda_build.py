"""Build and load the hand-written CUDA kernels of ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``), one process
per source, all started together, and links the objects into one shared
library with a plain C interface, loaded with ``ctypes``.  The build runs at
first use, from the sources in this checkout only, into ``_build/`` next to
this file; the library's name carries a hash of the sources and the flags,
so an edited source rebuilds and an unchanged one loads at once.

Flags: IEEE division and square root (no ``-use_fast_math``), and
``--fmad=false`` so that no multiply-add is contracted into an FMA — the
kernels then round exactly like their plain PyTorch versions, and the fused
min/max kernel exactly like repeated single steps.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xcompiler",
              "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double

#: C entry points and their argument types (pointers and the stream as
#: ``c_void_p``; every entry returns ``cudaGetLastError()``).
SIGNATURES = {
    # phi, sign, out, nx, ny, nz, dx, h, dx2, inv_dx2, eps_scale,
    # eps_floor, p5_zero_y, active, copy_inactive, partials, dsq, stream
    "lsf_reinit_step_f32": [_P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _F, _F,
                            _I, _P, _I, _P, _P, _P],
    # phi, sign, out, padded nx, ny, nz, block geometry (host ints), dx, h,
    # dx2, inv_dx2, eps_scale, eps_floor, p5_zero_y, active, partials, dsq,
    # stream
    "lsf_reinit_step_block_f32": [_P, _P, _P, _I, _I, _I, _P, _F, _F, _F, _F,
                                  _F, _F, _I, _P, _P, _P, _P],
    # phi, out, padded nx, ny, nz, block geometry (host ints), h1, inv_dx2,
    # band_dx, threshold, active, partials, dsq, tickets, stream
    "lsf_minmax_step_block_f32": [_P, _P, _I, _I, _I, _P, _F, _F, _F, _F,
                                  _P, _P, _P, _P, _P],
    # phi, sign, out, batch, nx, ny, nz, dx, h vector, dx2, inv_dx2,
    # eps_scale, eps_floor, p5_zero_y, live, partials, dsq vector, stream
    "lsf_reinit_step_packed_f32": [_P, _P, _P, _I, _I, _I, _I, _F, _P, _F,
                                   _F, _F, _F, _I, _P, _P, _P, _P],
    # phi, out, nx, ny, nz, h1, inv_dx2, band_dx, threshold,
    # active, copy_inactive, partials, dsq, tickets, stream
    "lsf_minmax_step_f32": [_P, _P, _I, _I, _I, _F, _F, _F, _F,
                            _P, _I, _P, _P, _P, _P],
    # phi, out, batch, nx, ny, nz, h1 vector, inv_dx2, band_dx, threshold,
    # live, partials, dsq vector, tickets, stream
    "lsf_minmax_step_packed_f32": [_P, _P, _I, _I, _I, _I, _P, _F, _F, _F,
                                   _P, _P, _P, _P, _P],
    # phi, out, nx, ny, nz, h1, inv_dx2, band_dx, threshold, ksteps,
    # active, copy_inactive, partials, dsq, stream
    "lsf_minmax_fusedk_f32": [_P, _P, _I, _I, _I, _F, _F, _F, _F, _I,
                              _P, _I, _P, _P, _P],
    # phi, out, padded nx, ny, nz, block geometry (host ints), h1, inv_dx2,
    # band_dx, threshold, ksteps, active, partials, dsq, stream
    "lsf_minmax_fusedk_block_f32": [_P, _P, _I, _I, _I, _P, _F, _F, _F, _F,
                                    _I, _P, _P, _P, _P],
    # phi, sign, g, cot_phi, cot_sign, cot_gs scratch, nx, ny, nz, dx, h, dx2,
    # inv_dx2, eps_scale, eps_floor, ef_dx, p5_zero_y, active, partials,
    # sums, stream
    "lsf_reinit_bwd_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F,
                           _F, _F, _F, _F, _I, _P, _P, _P, _P],
    # the same with the block geometry (host ints) after the padded nx, ny,
    # nz
    "lsf_reinit_bwd_block_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _F,
                                 _F, _F, _F, _F, _F, _F, _I, _P, _P, _P, _P],
    # phi, g, cot_phi, nx, ny, nz, h1, inv_dx2, band_dx, threshold, active,
    # partials, sums, ticket, accumulate, scale (-2/dx), stream
    "lsf_minmax_bwd_f32": [_P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _P, _P,
                           _P, _P, _I, _D, _P],
    # phi, g, cot_phi, padded nx, ny, nz, block geometry (host ints), h1,
    # inv_dx2, band_dx, threshold, partials, sums, ticket, accumulate,
    # scale, stream
    "lsf_minmax_bwd_block_f32": [_P, _P, _P, _I, _I, _I, _P, _F, _F, _F, _F,
                                 _P, _P, _P, _I, _D, _P],
    # pts, shift, tri, ang, flat (NULL: dense), offsets, counts, rows, P,
    # tile, tie, tie_floor, best, acc, stream
    "lsf_init_select_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F,
                            _P, _P, _P],
    # cen, c_sq, centers, pcen, pc_sq, pcen_abs, tc, t_sq, r, tri, blocks,
    # parents, E, nb1, nb2, nbc1, nbc2, R_b, R_p, margin, widen, R_b32,
    # R_p32, slack, thresh, counts, stream
    "lsf_cull_count": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                       _I, _I, _I, _I, _D, _D, _D, _F, _F, _F, _F, _P, _P,
                       _P],
    # cen, c_sq, pcen, pc_sq, tc, t_sq, r, blocks, parents, E, nb1, nb2,
    # nbc1, nbc2, thresh, offsets, flat, stream
    "lsf_cull_fill": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                      _P, _P, _P, _P],
    # phi, grad, pos, out_pos, out_phi, n, nx, ny, nz, origin (3), inv_dx,
    # iters, eps, mag_eps, mag_floor, stream
    "lsf_advect_nodes_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F,
                             _F, _I, _F, _F, _F, _P],
    # table (nb rows), nb, pos, out, n, global nx, ny, nz, origin (3),
    # inv_dx, stream
    "lsf_advect_block_f32": [_P, _I, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F,
                             _P],
    # table (nb rows), nb, state, n, global nx, ny, nz, origin (3), inv_dx,
    # iters, eps, mag_eps, mag_floor, zero_sign, stream
    "lsf_advect_blocks_run_f32": [_P, _I, _P, _I, _I, _I, _I, _F, _F, _F, _F,
                                  _I, _F, _F, _F, _I, _P],
}


#: C entry points that return a count, not an error: nx, ny, nz and the
#: block geometry (host ints, None for a solo grid) -> K5's float64 partials.
COUNTS = {"lsf_reinit_bwd_partials": [_I, _I, _I, _P]}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    srcs = sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + sorted(CSRC.glob("*.cuh")):
        digest.update(s.name.encode())
        digest.update(s.read_bytes())
    tag = digest.hexdigest()[:16]
    so = BUILD_DIR / f"liblsf_kernels-{tag}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [Path(tmp) / f"{s.stem}.o" for s in srcs]
            with ThreadPoolExecutor(len(srcs)) as pool:
                list(pool.map(_run, [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o),
                                      str(s)] for s, o in zip(srcs, objs)]))
            lib = Path(tmp) / so.name
            _run([nvcc, *ARCH, "-shared", "-o", str(lib), *map(str, objs)])
            os.replace(lib, so)      # atomic under concurrent builds
    return so


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name, argtypes in COUNTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_longlong
    return lib


def launch(name: str, *args) -> None:
    """Call a C entry point and raise on a CUDA error it reports."""
    err = getattr(library(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
