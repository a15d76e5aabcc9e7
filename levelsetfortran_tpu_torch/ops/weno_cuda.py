"""Kernel K1 — the fused reinitialization step — with its plain PyTorch
version, and the narrow-band brick activity mask.

K1 (``csrc/reinit_step.cu``) replaces the TPU kernel
``levelsetfortran_tpu/ops/weno_pallas.py:_pallas_step_padded``: one Jacobi
step of ``phi_t = sgn(phi_0)(1 - |grad phi|)`` — HJ-WENO5 + Godunov on raw
differences, smeared sign, interior Euler update, ghost BC read after the
update — plus the fused sum of squared cell changes and the banded
``active``/``carry`` modes.  What bounds it on the H100 is arithmetic
(~400 float operations with 13 IEEE divisions per cell against 12 bytes of
unique traffic); the kernel keeps every intermediate in registers, one
thread per cell in 8^3-cell bricks whose stencil re-reads hit L1, and skips
inactive bricks.  The TPU layout (x/y aprons, 128-lane z padding) is not
ported: the tensor is the unpadded ``(nx, ny, nz)`` grid and every mask is
in global coordinates.

:func:`reinit_step` runs the plain version only for a CPU tensor; for a
CUDA tensor it launches the kernel or raises.  Both evaluate the same
expressions in the same order on scalars rounded once in the working
dtype (:func:`step_scalars`), so they agree to the last bits.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import cuda_build
from .stencil import clamped_inner, interior_mask, shift
from .weno import default_eps_floor

#: Brick edge in cells: the narrow-band mask granularity and the CUDA
#: kernels' block shape (``csrc/common.cuh``).
BRICK = 8


def np_dtype(dtype: torch.dtype):
    return np.float32 if dtype == torch.float32 else np.float64


def step_scalars(dtype, dx, h, eps_scale=1e-6, eps_floor=None) -> dict:
    """The step's scalar constants, each rounded once in ``dtype`` exactly
    as the TPU kernel forms them (``_scaled_eps_floor`` :464)."""
    t = np_dtype(dtype)
    if eps_floor is None:
        eps_floor = default_eps_floor(dtype)
    dxv = t(dx)
    dx2 = dxv * dxv
    floor = t(1e-18 if dtype == torch.float32 else 1e-99)
    return dict(dx=float(dxv), h=float(t(h)), dx2=float(dx2),
                inv_dx2=float(t(1) / dx2), eps_scale=float(t(eps_scale)),
                eps_floor=float(max(t(eps_floor) * dx2, floor)))


# ----------------------------- plain version ------------------------------

def _weno5_pair(p0, p1, p2, p3, p4, p5, eps_scale, eps_floor, ratio_floor,
                p5_zero):
    """(d_minus, d_plus) from six one-sided raw differences — the TPU
    kernel's ``_weno5_pair`` :74, operation for operation."""
    ap, am = p5 - p4, p1 - p0
    bp, bm = p4 - p3, p2 - p1
    cp = p3 - p2
    ab_p, ab_m = ap - bp, am - bm
    bc_p, bc_m = bp - cp, bm - cp
    sq_ab_p, sq_ab_m = ab_p * ab_p, ab_m * ab_m
    sq_bc_p, sq_bc_m = bc_p * bc_p, bc_m * bc_m

    def is_term(sq_diff, c):
        return 13.0 * sq_diff + 3.0 * (c * c)

    is0p = is_term(sq_ab_p, ab_p - 2.0 * bp)
    is0m = is_term(sq_ab_m, ab_m - 2.0 * bm)
    is1p = is_term(sq_bc_p, bp + cp)
    is1m = is_term(sq_bc_m, bm + cp)
    is2p = is_term(sq_bc_m, 3.0 * cp - bm)
    is2m = is_term(sq_bc_p, 3.0 * cp - bp)
    common4 = torch.maximum(torch.maximum(p1 * p1, p2 * p2),
                            torch.maximum(p3 * p3, p4 * p4))
    if p5_zero:
        epsp = eps_scale * common4 + eps_floor
    else:
        epsp = eps_scale * torch.maximum(common4, p5 * p5) + eps_floor
    epsm = eps_scale * torch.maximum(common4, p0 * p0) + eps_floor

    def weights(eps, is0, is1, is2):
        d0, d1, d2 = eps + is0, eps + is1, eps + is2
        inv_max = 1.0 / torch.maximum(d0, torch.maximum(d1, d2))
        d0 = torch.clamp_min(d0 * inv_max, ratio_floor)
        d1 = torch.clamp_min(d1 * inv_max, ratio_floor)
        d2 = torch.clamp_min(d2 * inv_max, ratio_floor)
        q0, q1, q2 = d1 * d2, d0 * d2, d0 * d1
        t0 = q0 * q0
        t1 = 6.0 * (q1 * q1)
        t2 = 3.0 * (q2 * q2)
        r = 1.0 / (t0 + t1 + t2)
        return t0 * r, t2 * r

    w0p, w2p = weights(epsp, is0p, is1p, is2p)
    w0m, w2m = weights(epsm, is0m, is1m, is2m)
    pwp = (w0p * (ab_p - bc_p) * (1.0 / 3.0)
           + (w2p - 0.5) * (bc_p + bc_m) * (1.0 / 6.0))
    pwm = (w0m * (ab_m - bc_m) * (1.0 / 3.0)
           + (w2m - 0.5) * (bc_m + bc_p) * (1.0 / 6.0))
    common = (7.0 * (p2 + p3) - (p1 + p4)) * (1.0 / 12.0)
    return common - pwm, common + pwp


def _interior_update(phi, sign_src, sc, quirk_y_p5_zero):
    """Euler-updated values of the interior cells (face cells: garbage)."""
    f64 = phi.dtype == torch.float64
    ratio_floor = 1e-70 if f64 else 1e-7
    deep = interior_mask(phi.shape, 4, phi.device)
    pos = sign_src > 0.0
    total = None
    for axis in range(3):
        vm3, vm2, vm1 = (shift(phi, axis, o) for o in (-3, -2, -1))
        vp1, vp2, vp3 = (shift(phi, axis, o) for o in (1, 2, 3))
        p2, p3 = phi - vm1, vp1 - phi
        w_m, w_p = _weno5_pair(vm2 - vm3, vm1 - vm2, p2, p3, vp2 - vp1,
                               vp3 - vp2, sc["eps_scale"], sc["eps_floor"],
                               ratio_floor, quirk_y_p5_zero and axis == 1)
        d_m = torch.where(deep, w_m, p2)
        d_p = torch.where(deep, w_p, p3)
        g = torch.where(pos,
                        torch.clamp_min(torch.maximum(d_m, -d_p), 0.0),
                        torch.clamp_min(torch.maximum(d_p, -d_m), 0.0))
        total = g * g if total is None else total + g * g
    gm = torch.sqrt(total * sc["inv_dx2"])
    d2 = sign_src * sign_src + sc["dx2"] * gm
    sg = sign_src / torch.sqrt(torch.clamp_min(d2, 1e-30 if f64 else 1e-20))
    return phi + sc["h"] * sg * (1.0 - gm)


def _ghost_bc(upd, dx):
    """Face cell = clamped inner neighbour's UPDATED value + dx."""
    return torch.where(interior_mask(upd.shape, 1, upd.device), upd,
                       clamped_inner(upd) + dx)


# --------------------------- narrow-band bricks ---------------------------

def brick_grid(shape) -> tuple:
    return tuple(-(-n // BRICK) for n in shape)


def tile_activity(phi, dx, radius_cells, margin_cells=0.0,
                  window="band4") -> torch.Tensor:
    """(nbx, nby, nbz) int32 brick activity mask of ``phi``.

    The port of ``weno_pallas.tile_activity`` (:1334) at Hopper's
    granularity: 8^3 bricks instead of the TPU's whole-z columns.  A brick
    is active when the min |phi| over its window is below
    ``(radius_cells + margin_cells) * dx``; cells outside the grid are
    ignored.  ``window="owned"``: the brick's own cells (exact for min/max,
    whose update gate is the cell's own value).  ``"band4"``: the own cells
    dilated by 4 in every axis (reinit: every cell feeding an in-band
    cell's stencil keeps computing)."""
    t = np_dtype(phi.dtype)
    thresh = float(t(radius_cells + margin_cells) * t(dx))
    nb = brick_grid(phi.shape)
    pad = []
    for n, b in zip(reversed(phi.shape), reversed(nb)):
        pad += [0, b * BRICK - n]
    a = F.pad(torch.abs(phi), pad, value=float("inf"))
    half = BRICK // 2
    m1 = a.reshape(2 * nb[0], half, 2 * nb[1], half, 2 * nb[2], half).amin(
        dim=(1, 3, 5))                          # 4^3 sub-block minima
    if window == "owned":
        m = m1.reshape(nb[0], 2, nb[1], 2, nb[2], 2).amin(dim=(1, 3, 5))
    elif window == "band4":
        # brick b covers sub-blocks 2b, 2b+1; +-4 cells = 2b-1 .. 2b+2
        m1p = F.pad(m1, (1, 1, 1, 1, 1, 1), value=float("inf"))
        m = -F.max_pool3d(-m1p[None, None], kernel_size=4, stride=2)[0, 0]
    else:
        raise ValueError(f"unknown window {window!r}")
    return (m < thresh).to(torch.int32).contiguous()


def brick_cells(active, shape) -> torch.Tensor:
    """Boolean per-cell view of a brick mask."""
    m = active.bool()
    for ax in range(3):
        m = m.repeat_interleave(BRICK, dim=ax)
    return m[:shape[0], :shape[1], :shape[2]]


def finish_plain(res, phi, out, with_rms, base=None):
    """Copy a plain version's result into ``out``; with ``with_rms`` also
    return the float64 sum of squared changes against ``base`` (default
    ``phi``), as the kernels' fused reduction does."""
    if out is None:
        out = torch.empty_like(phi)
    out.copy_(res)
    if not with_rms:
        return out
    d = (out - (phi if base is None else base)).double()
    return out, (d * d).sum()


def reinit_step_plain(phi, sign_src, dx, h, *, eps_scale=1e-6,
                      eps_floor=None, quirk_y_p5_zero=False, active=None,
                      out=None, mint=True, with_rms=False):
    """The plain version of :func:`reinit_step` (same arguments, any dtype,
    any device): whole-grid tensor ops, then the banded write."""
    sc = step_scalars(phi.dtype, dx, h, eps_scale, eps_floor)
    upd = _interior_update(phi, sign_src, sc, quirk_y_p5_zero)
    if active is not None:
        upd = torch.where(brick_cells(active, phi.shape), upd,
                          phi if mint else out)
    return finish_plain(_ghost_bc(upd, sc["dx"]), phi, out, with_rms)


# ------------------------------ kernel wrapper -----------------------------

def check_cuda(name, phi, out, active, inputs=()):
    """Raise on what the CUDA kernels do not take."""
    if phi.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32 only, got "
                        f"{phi.dtype} (float64 runs on the CPU)")
    if phi.dim() != 3 or min(phi.shape) < 3 or phi.numel() >= 2 ** 31:
        raise ValueError(f"{name}: unsupported grid shape {tuple(phi.shape)}")
    for t in (phi, *inputs, out):
        if (t.dtype != torch.float32 or t.shape != phi.shape
                or t.device != phi.device or not t.is_contiguous()):
            raise ValueError(f"{name}: every field must be a contiguous "
                             f"float32 tensor of shape {tuple(phi.shape)} "
                             f"on {phi.device}")
    if any(out.data_ptr() == t.data_ptr() for t in (phi, *inputs)):
        raise ValueError(f"{name}: out must not alias an input")
    if active is not None and (
            active.dtype != torch.int32 or active.device != phi.device
            or tuple(active.shape) != brick_grid(phi.shape)
            or not active.is_contiguous()):
        raise ValueError(f"{name}: active must be a contiguous int32 "
                         f"{brick_grid(phi.shape)} tensor on {phi.device}")


def ptr(t):
    return None if t is None else t.data_ptr()


def rms_buffers(phi, with_rms):
    """Per-brick partial sums and the scalar they reduce into."""
    if not with_rms:
        return None, None
    nb = brick_grid(phi.shape)
    return (torch.empty(nb[0] * nb[1] * nb[2], dtype=torch.float64,
                        device=phi.device),
            torch.empty((), dtype=torch.float64, device=phi.device))


def reinit_step(phi, sign_src, dx, h, *, eps_scale=1e-6, eps_floor=None,
                quirk_y_p5_zero=False, active=None, out=None, mint=True,
                with_rms=False):
    """One reinit step of ``phi`` into ``out`` (allocated when None).

    ``active`` (brick mask) runs the narrow band: inactive bricks copy
    their cells when ``mint``, else keep what ``out`` already holds; face
    cells take the ghost BC in every brick.  Returns ``out``, or
    ``(out, dsq)`` with the float64 sum of squared changes when
    ``with_rms``."""
    if phi.device.type == "cpu":
        return reinit_step_plain(
            phi, sign_src, dx, h, eps_scale=eps_scale, eps_floor=eps_floor,
            quirk_y_p5_zero=quirk_y_p5_zero, active=active, out=out,
            mint=mint, with_rms=with_rms)
    if out is None:
        out = torch.empty_like(phi)
    check_cuda("reinit_step", phi, out, active, (sign_src,))
    sc = step_scalars(phi.dtype, dx, h, eps_scale, eps_floor)
    partials, dsq = rms_buffers(phi, with_rms)
    with torch.cuda.device(phi.device):
        cuda_build.launch(
            "lsf_reinit_step_f32", phi.data_ptr(), sign_src.data_ptr(),
            out.data_ptr(), *phi.shape, sc["dx"], sc["h"], sc["dx2"],
            sc["inv_dx2"], sc["eps_scale"], sc["eps_floor"],
            int(quirk_y_p5_zero), ptr(active), int(mint), ptr(partials),
            ptr(dsq), torch.cuda.current_stream().cuda_stream)
    reinit_step.launches += 1
    return (out, dsq) if with_rms else out


reinit_step.launches = 0
