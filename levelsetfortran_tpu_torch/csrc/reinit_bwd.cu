// Kernel K5: the VJP of one dense reinitialization step (kernel K1) with
// respect to (phi, the sign source, dx, h).
//
// Replaces levelsetfortran_tpu/ops/weno_pallas.py:_pallas_bwd_padded (body:
// _make_bwd_kernel, _axis_gsq_bwd, _weno5_pair_hand, the jax.vjp of
// _tile_tail with guard_ad).  It differentiates K1's own per-axis forward
// (weno5.cuh, which both kernels include), recomputed per cell, with the
// same hand-chained adjoint as the TPU kernel, cell for cell:
//   * ghost BC: a face cell is its clamped inner neighbour's updated value
//     plus dx, so an interior cell's update collects the cotangents of the
//     face cells that clamp onto it (up to 7 at a grid corner), and every
//     face cotangent adds to cot_dx;
//   * guarded tail: |grad| = sqrt(sum / dx^2) with the double-where at 0,
//     smeared sign s / sqrt(max(s^2 + dx^2 |grad|, 1e-20));
//   * per axis: Godunov routing (the inner max goes to d_minus when
//     d_minus >= -d_plus on the positive side; nothing flows where the
//     selected value is 0), then the quotient-rule adjoint of the WENO
//     weights with argmax routing (ties to the lower index), the epsilon
//     floor chained to dx;
//   * stencil transpose: the cell at s + k e (k = -3..3) receives q_k(s).
//
// Determinism.  The TPU kernel scatter-adds overlapping windows, which is
// safe only because its grid runs in order.  Here no float atomics are
// used, so two launches give the same bits: design (a), two passes.
// Pass 1 (one thread per cell) writes the cell's direct cotangent and its
// sign cotangent, and the 21 stencil cotangents q_k(s) of its three axes
// to a scratch array (21 floats per cell: 1.4 GB at 256^3, which the card
// has); pass 2 (one thread per cell) gathers cot_phi[t] = direct[t] +
// sum_axis sum_k q_k(t - k e) in a fixed order.  The scalar cotangents are
// per-brick float64 partials (fixed shared-memory tree) added in order by
// reduce_partials.  Design (b), one pass recomputing q on a +-3 halo in
// shared memory, would recompute each axis's adjoint 1.75x and is left to
// later speed work.
//
// Banded mode (`active`, one int32 per 8^3 brick; the TPU kernel's
// `active`): the exact transpose of K1's banded mode.  A frozen brick's
// interior cells were copied, so their update cotangent passes through and
// they write no stencil or sign cotangent; its global-face cells still took
// the ghost BC, so their transpose stays (see reinit_bwd_cells).
//
// Block mode (lsf_reinit_bwd_block_f32; the TPU kernel's `offsets`): one
// shard's block, padded on its sharded axes with 6 neighbour cells of phi,
// the sign source and the upstream cotangent g.  Unlike the TPU route,
// which scatters onto the halo and sends it back with a transpose exchange,
// the gather form is kept: pass 1 evaluates q on every cell within 3 of the
// owned box (its stencil reaches 3 more, hence 6), pass 2 gathers each
// owned cell in the solo order, so an owned cell's cotangent is the solo
// kernel's bitwise and no transpose exchange is needed.  Every mask is in
// global coordinates; the direct and sign cotangents are pointwise, written
// for the owned cells only (outputs in the owned box's shape); the sums
// count the owned cells.  A solo grid runs as the block whose array and
// owned box are the whole grid.
//
// What bounds it on the H100: arithmetic.  A cell's forward costs ~400
// float operations and its adjoint about three times that, against 12
// bytes in, 8 out and 168 bytes of scratch traffic.  Every intermediate
// stays in registers (512-thread bricks allow up to 128 a thread).
#include "common.cuh"
#include "weno5.cuh"

namespace {

using lsf::BRICK;
using lsf::NT;

constexpr float SIGN_FLOOR = 1e-20f;

struct BwdParams {
  int nx, ny, nz;
  float dx, h, dx2, inv_dx2, eps_scale, eps_floor;   // eps_floor: dx^2-scaled
  float ef_dx;     // d(eps_floor)/d(dx), 0 where the floor is clamped
  int p5_zero_y;
};

// Adjoint of weights_fwd: returns cot_eps, writes cot_is0..2.
__device__ __forceinline__ float weights_bwd(const lsf::Weights& s, float cot_w0,
                                             float cot_w2, float& ci0,
                                             float& ci1, float& ci2) {
  const float sigma = s.r * (cot_w0 * s.w0 + cot_w2 * s.w2);
  const float cot_u0 = (2.0f * (s.r * cot_w0 - sigma)) * s.u0;
  const float cot_u1 = (-12.0f * sigma) * s.u1;
  const float cot_u2 = (6.0f * (s.r * cot_w2 - sigma)) * s.u2;
  const float cr0 = s.r0 >= lsf::RATIO_FLOOR ? cot_u1 * s.h2 + cot_u2 * s.h1 : 0.0f;
  const float cr1 = s.r1 >= lsf::RATIO_FLOOR ? cot_u0 * s.h2 + cot_u2 * s.h0 : 0.0f;
  const float cr2 = s.r2 >= lsf::RATIO_FLOOR ? cot_u0 * s.h1 + cot_u1 * s.h0 : 0.0f;
  const float cot_m = -(s.inv * s.inv) * ((cr0 * s.d0 + cr1 * s.d1) + cr2 * s.d2);
  const bool d0_wins = s.d0 >= s.m12;
  const float cot_m12 = d0_wins ? 0.0f : cot_m;
  const bool d1_wins = s.d1 >= s.d2;
  ci0 = cr0 * s.inv + (d0_wins ? cot_m : 0.0f);
  ci1 = cr1 * s.inv + (d1_wins ? cot_m12 : 0.0f);
  ci2 = cr2 * s.inv + (d1_wins ? 0.0f : cot_m12);
  return (ci0 + ci1) + ci2;
}

// Adjoint of lsf::weno5: cot_p[0..5] from (cot_dm, cot_dp); returns the
// cotangent of the scaled epsilon floor.  It recomputes the forward's
// residuals from p: holding them live across the Godunov routing instead
// costs spills and ~5% of the kernel's time on the H100.
__device__ float weno5_bwd(const float* p, float eps_scale, float eps_floor,
                           bool p5_zero, float cot_wm, float cot_wp,
                           float* cps) {
  lsf::Weno5 w;
  lsf::weno5(p, eps_scale, eps_floor, p5_zero, w);
  const float ab_p = w.ab_p, ab_m = w.ab_m, bc_p = w.bc_p, bc_m = w.bc_m;
  const float bp = w.bp, bm = w.bm, cp = w.cp;
  const float e0p = ab_p - 2.0f * bp, e0m = ab_m - 2.0f * bm;
  const float e1p = bp + cp, e1m = bm + cp;
  const float e2p = 3.0f * cp - bm, e2m = 3.0f * cp - bp;
  const lsf::Weights& wp = w.wp;
  const lsf::Weights& wm = w.wm;
  const float a_p = ab_p - bc_p, a_m = ab_m - bc_m, b = bc_p + bc_m;

  const float third = 1.0f / 3.0f, sixth = 1.0f / 6.0f;
  const float cot_common = cot_wm + cot_wp;
  const float tp = cot_wp * third, tm = -cot_wm * third;
  const float sp = cot_wp * sixth, sm = -cot_wm * sixth;
  const float cot_ap_ = tp * wp.w0, cot_am_ = tm * wm.w0;
  const float cot_b = sp * (wp.w2 - 0.5f) + sm * (wm.w2 - 0.5f);
  float ci0p, ci1p, ci2p, ci0m, ci1m, ci2m;
  const float cot_epsp = weights_bwd(wp, tp * a_p, sp * b, ci0p, ci1p, ci2p);
  const float cot_epsm = weights_bwd(wm, tm * a_m, sm * b, ci0m, ci1m, ci2m);
  const float ce0p = (6.0f * ci0p) * e0p, ce0m = (6.0f * ci0m) * e0m;
  const float ce1p = (6.0f * ci1p) * e1p, ce1m = (6.0f * ci1m) * e1m;
  const float ce2p = (6.0f * ci2p) * e2p, ce2m = (6.0f * ci2m) * e2m;

  // epsilon max-chain routing (common4 collects both branches)
  const float cot_mp = eps_scale * cot_epsp;
  const float cot_mm = eps_scale * cot_epsm;
  const float common4 = w.common4, p0s = w.p0s, p5s = w.p5s;
  const bool mm_c4 = common4 >= p0s;
  float cot_c4 = mm_c4 ? cot_mm : 0.0f;
  const float cot_p0s = mm_c4 ? 0.0f : cot_mm;
  float cot_p5s = 0.0f;
  if (p5_zero) {
    cot_c4 = cot_c4 + cot_mp;
  } else {
    const bool mp_c4 = common4 >= p5s;
    cot_c4 = cot_c4 + (mp_c4 ? cot_mp : 0.0f);
    cot_p5s = mp_c4 ? 0.0f : cot_mp;
  }
  const bool c12_wins = w.c12 >= w.c34;
  const float cot_c12 = c12_wins ? cot_c4 : 0.0f;
  const float cot_c34 = c12_wins ? 0.0f : cot_c4;
  const bool p1_wins = w.p1s >= w.p2s, p3_wins = w.p3s >= w.p4s;
  const float cot_p1s = p1_wins ? cot_c12 : 0.0f;
  const float cot_p2s = p1_wins ? 0.0f : cot_c12;
  const float cot_p3s = p3_wins ? cot_c34 : 0.0f;
  const float cot_p4s = p3_wins ? 0.0f : cot_c34;

  const float cot_ab_p = ((2.0f * ab_p) * (13.0f * ci0p) + ce0p) + cot_ap_;
  const float cot_ab_m = ((2.0f * ab_m) * (13.0f * ci0m) + ce0m) + cot_am_;
  const float cot_bc_p = ((2.0f * bc_p) * (13.0f * (ci1p + ci2m)) - cot_ap_) + cot_b;
  const float cot_bc_m = ((2.0f * bc_m) * (13.0f * (ci1m + ci2p)) - cot_am_) + cot_b;
  const float cot_bp = ((((-2.0f * ce0p) + ce1p) - ce2m) - cot_ab_p) + cot_bc_p;
  const float cot_bm = ((((-2.0f * ce0m) + ce1m) - ce2p) - cot_ab_m) + cot_bc_m;
  const float cot_cp = (((ce1p + ce1m) + 3.0f * (ce2p + ce2m)) - cot_bc_p) - cot_bc_m;
  const float c7 = (7.0f / 12.0f) * cot_common;
  const float c1 = (1.0f / 12.0f) * cot_common;
  cps[0] = -cot_ab_m + (2.0f * p[0]) * cot_p0s;
  cps[1] = ((cot_ab_m - cot_bm) - c1) + (2.0f * p[1]) * cot_p1s;
  cps[2] = ((cot_bm - cot_cp) + c7) + (2.0f * p[2]) * cot_p2s;
  cps[3] = ((cot_cp - cot_bp) + c7) + (2.0f * p[3]) * cot_p3s;
  cps[4] = ((cot_bp - cot_ab_p) - c1) + (2.0f * p[4]) * cot_p4s;
  cps[5] = cot_ab_p + (2.0f * p[5]) * cot_p5s;
  return cot_epsp + cot_epsm;
}

// Adjoint of the Godunov selection: the cotangents of (d_m, d_p) for the
// cotangent cot_gsq of the selected derivative's square.
__device__ __forceinline__ void godunov_bwd(float dm, float dp, bool pos,
                                            float cot_gsq, float& cot_dm,
                                            float& cot_dp) {
  const float g = lsf::godunov(dm, dp, pos);
  const float cot_g = g > 0.0f ? (2.0f * g) * cot_gsq : 0.0f;
  const bool m_over_p = dm >= -dp, p_over_m = dp >= -dm;
  if (pos) {
    cot_dm = m_over_p ? cot_g : 0.0f;
    cot_dp = m_over_p ? 0.0f : -cot_g;
  } else {
    cot_dm = p_over_m ? 0.0f : -cot_g;
    cot_dp = p_over_m ? cot_g : 0.0f;
  }
}

// The six raw one-sided differences of one axis at cell s (stride st);
// only p[2], p[3] (first order) outside the deep region.
__device__ __forceinline__ void axis_diffs(const float* __restrict__ phi,
                                           long long s, long long st, float c,
                                           bool deep, float* p) {
  const float vm1 = __ldg(phi + s - st), vp1 = __ldg(phi + s + st);
  p[2] = c - vm1;
  p[3] = vp1 - c;
  if (deep) {
    const float vm3 = __ldg(phi + s - 3 * st), vm2 = __ldg(phi + s - 2 * st);
    const float vp2 = __ldg(phi + s + 2 * st), vp3 = __ldg(phi + s + 3 * st);
    p[0] = vm2 - vm3;
    p[1] = vm1 - vm2;
    p[4] = vp2 - vp1;
    p[5] = vp3 - vp2;
  }
}

// One axis's selected derivative at an interior cell (the forward).
__device__ __forceinline__ float axis_g(const float* __restrict__ phi,
                                        long long s, long long st, float c,
                                        bool deep, bool pos,
                                        const BwdParams& q, bool p5_zero) {
  float p[6];
  axis_diffs(phi, s, st, c, deep, p);
  if (!deep) return lsf::godunov(p[2], p[3], pos);
  lsf::Weno5 w;
  lsf::weno5(p, q.eps_scale, q.eps_floor, p5_zero, w);
  return lsf::godunov(w.dm, w.dp, pos);
}

// One axis's adjoint at an interior cell: the seven stencil cotangents
// q[0..6] (cells s-3e .. s+3e); returns the epsilon-floor cotangent.
__device__ float axis_bwd(const float* __restrict__ phi, long long s,
                          long long st, float c, bool deep, bool pos,
                          float cot_gsq, const BwdParams& q, bool p5_zero,
                          float* qs) {
  float p[6], cot_dm, cot_dp;
  axis_diffs(phi, s, st, c, deep, p);
  float cps[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float cot_ef = 0.0f;
  if (deep) {
    lsf::Weno5 w;
    lsf::weno5(p, q.eps_scale, q.eps_floor, p5_zero, w);
    godunov_bwd(w.dm, w.dp, pos, cot_gsq, cot_dm, cot_dp);
    cot_ef = weno5_bwd(p, q.eps_scale, q.eps_floor, p5_zero, cot_dm,
                       cot_dp, cps);
  } else {
    godunov_bwd(p[2], p[3], pos, cot_gsq, cot_dm, cot_dp);
    cps[2] = cot_dm;
    cps[3] = cot_dp;
  }
  qs[0] = -cps[0];
  for (int m = 1; m < 6; ++m) qs[m] = cps[m - 1] - cps[m];
  qs[6] = cps[5];
  return cot_ef;
}

// The face cotangents that reach interior cell (i, j, k) — GLOBAL indices —
// through the ghost BC, summed in the order of the plain version's
// transpose of the clamped gather: z faces onto the cell's column first,
// then y, then x, each an add of the low face then the high one.  Interior
// cells contribute 0.  g is read at the array cell of each global index.
struct GhostView {
  const float* g;
  int o[3], gn[3];       // the array's global origin, the global grid
  long long sx, sy;      // the array's strides
};

__device__ __forceinline__ float face_g(const GhostView& v, int a, int b,
                                        int c) {
  const bool inner = a >= 1 && a <= v.gn[0] - 2 && b >= 1
                     && b <= v.gn[1] - 2 && c >= 1 && c <= v.gn[2] - 2;
  return inner ? 0.0f
               : v.g[(a - v.o[0]) * v.sx + (b - v.o[1]) * v.sy + (c - v.o[2])];
}

__device__ __forceinline__ float ghost_z(const GhostView& v, int a, int b,
                                         int k) {
  float r = face_g(v, a, b, k);
  if (k == 1) r = r + face_g(v, a, b, 0);
  if (k == v.gn[2] - 2) r = r + face_g(v, a, b, v.gn[2] - 1);
  return r;
}

__device__ __forceinline__ float ghost_yz(const GhostView& v, int a, int j,
                                          int k) {
  float r = ghost_z(v, a, j, k);
  if (j == 1) r = r + ghost_z(v, a, 0, k);
  if (j == v.gn[1] - 2) r = r + ghost_z(v, a, v.gn[1] - 1, k);
  return r;
}

__device__ __forceinline__ float ghost_gather(const GhostView& v, int i, int j,
                                             int k) {
  float r = ghost_yz(v, i, j, k);
  if (i == 1) r = r + ghost_yz(v, 0, j, k);
  if (i == v.gn[0] - 2) r = r + ghost_yz(v, v.gn[0] - 1, j, k);
  return r;
}

// A cell of the launch: its array index (i, j, k), offset s, global index
// (gi, gj, gk), and its offset in the owned box (the outputs' layout).
struct Cell {
  int i, j, k, gi, gj, gk;
  long long s, ow;
  bool in_grid, owned;
};

__device__ __forceinline__ Cell locate(const BwdParams& p,
                                       const lsf::BlockGeom& q) {
  Cell c;
  c.i = q.c[0] + (q.t0[0] + (int)blockIdx.z) * BRICK + threadIdx.z;
  c.j = q.c[1] + (q.t0[1] + (int)blockIdx.y) * BRICK + threadIdx.y;
  c.k = q.c[2] + (q.t0[2] + (int)blockIdx.x) * BRICK + threadIdx.x;
  c.gi = q.o[0] + c.i;
  c.gj = q.o[1] + c.j;
  c.gk = q.o[2] + c.k;
  c.in_grid = c.i >= 0 && c.i < p.nx && c.j >= 0 && c.j < p.ny && c.k >= 0
              && c.k < p.nz && c.gi >= 0 && c.gi < q.g[0] && c.gj >= 0
              && c.gj < q.g[1] && c.gk >= 0 && c.gk < q.g[2];
  c.owned = c.in_grid && lsf::in_rms_box(q, c.gi, c.gj, c.gk);
  c.s = ((long long)c.i * p.ny + c.j) * p.nz + c.k;
  c.ow = ((long long)(c.gi - q.rms[0]) * (q.rms[3] - q.rms[2])
          + (c.gj - q.rms[2])) * (q.rms[5] - q.rms[4]) + (c.gk - q.rms[4]);
  return c;
}

// Pass 1: for every in-grid cell within 3 of the owned box (the cells whose
// stencil cotangents an owned cell gathers), the 21 stencil cotangents (q
// laid out [axis * 7 + k + 3][array cell]); for the owned cells also the
// direct and sign cotangents (owned-box layout) and the scalar partials
// (partials[brick]: cot_dx, partials[nbricks + brick]: cot_h).
//
// Banded (active != nullptr): an interior cell of a frozen brick was copied
// by the forward, so its update's cotangent passes through as `direct`, its
// stencil and sign cotangents are 0 and it adds nothing to the scalars.  A
// global-face cell takes the ghost BC in every brick (K1's banded mode), so
// its transpose — the face cotangent onto the clamped inner neighbour and
// into cot_dx — is kept whatever its brick.
__global__ void __launch_bounds__(NT)
reinit_bwd_cells(const float* __restrict__ phi,
                 const float* __restrict__ sgn_src,
                 const float* __restrict__ g, float* __restrict__ direct,
                 float* __restrict__ cot_sign, float* __restrict__ qbuf,
                 BwdParams p, lsf::BlockGeom q, const int* __restrict__ active,
                 double* __restrict__ partials) {
  __shared__ double red[NT];
  const Cell cl = locate(p, q);
  const long long sx = (long long)p.ny * p.nz, sy = p.nz;
  const long long na = (long long)p.nx * sx;
  const long long s = cl.s;
  const bool near = cl.in_grid && cl.gi >= q.rms[0] - 3
                    && cl.gi < q.rms[1] + 3 && cl.gj >= q.rms[2] - 3
                    && cl.gj < q.rms[3] + 3 && cl.gk >= q.rms[4] - 3
                    && cl.gk < q.rms[5] + 3;
  const bool interior = cl.gi >= 1 && cl.gi <= q.g[0] - 2 && cl.gj >= 1
                        && cl.gj <= q.g[1] - 2 && cl.gk >= 1
                        && cl.gk <= q.g[2] - 2;
  double cdx = 0.0, ch = 0.0;
  if (near && !interior) {
    for (int m = 0; m < 21; ++m) qbuf[m * na + s] = 0.0f;
    if (cl.owned) {
      direct[cl.ow] = 0.0f;
      cot_sign[cl.ow] = 0.0f;
      cdx = (double)g[s];                   // face = inner + dx
    }
  } else if (near) {
    // this update's cotangent: its own cell and every face clamping onto it
    const GhostView gv{g, {q.o[0], q.o[1], q.o[2]}, {q.g[0], q.g[1], q.g[2]},
                       sx, sy};
    const float big_g = g[s] + ghost_gather(gv, cl.gi, cl.gj, cl.gk);
    if (!lsf::block_brick_active(active, q, cl.i, cl.j, cl.k)) {
      for (int m = 0; m < 21; ++m) qbuf[m * na + s] = 0.0f;
      if (cl.owned) {
        direct[cl.ow] = big_g;
        cot_sign[cl.ow] = 0.0f;
      }
    } else {
      // forward: the three selected derivatives (K1's order)
      const float c = __ldg(phi + s);
      const float src = __ldg(sgn_src + s);
      const bool pos = src > 0.0f;
      const bool deep = cl.gi >= 4 && cl.gi <= q.g[0] - 5 && cl.gj >= 4
                        && cl.gj <= q.g[1] - 5 && cl.gk >= 4
                        && cl.gk <= q.g[2] - 5;
      const bool p5y = p.p5_zero_y != 0;
      const float g0 = axis_g(phi, s, sx, c, deep, pos, p, false);
      const float g1 = axis_g(phi, s, sy, c, deep, pos, p, p5y);
      const float g2 = axis_g(phi, s, 1, c, deep, pos, p, false);
      const float gsum = (g0 * g0 + g1 * g1) + g2 * g2;

      // guarded tail: res = c + (h sg)(1 - gm)
      const bool nzm = gsum > 0.0f;
      const float gm_safe = sqrtf((nzm ? gsum : 1.0f) * p.inv_dx2);
      const float gm = nzm ? gm_safe : 0.0f;
      const float d2 = src * src + p.dx2 * gm;
      const float m = fmaxf(d2, SIGN_FLOOR);
      const float sq = sqrtf(m);
      const float sg = src / sq;
      const float cot_hs = big_g * (1.0f - gm);
      ch = (double)(cot_hs * sg);
      const float cot_sg = cot_hs * p.h;
      const float cot_m = cot_sg * ((-0.5f * sg) / m);
      const float cot_d2 = d2 > SIGN_FLOOR ? cot_m
                           : (d2 == SIGN_FLOOR ? 0.5f * cot_m : 0.0f);
      const float cot_gm = -((p.h * sg) * big_g) + p.dx2 * cot_d2;
      const float cot_u = nzm ? cot_gm * (0.5f / gm_safe) : 0.0f;
      const float cot_gs = cot_u * p.inv_dx2;
      cdx = (2.0 * (double)p.dx) * (double)(gm * cot_d2)
            - (2.0 * (double)p.dx * (double)p.inv_dx2 * (double)p.inv_dx2)
              * (double)(cot_u * gsum);
      if (cl.owned) {
        direct[cl.ow] = big_g;
        cot_sign[cl.ow] = cot_sg / sq + (2.0f * src) * cot_d2;
      }

      // per-axis adjoints into the scratch
      const long long strides[3] = {sx, sy, 1};
      for (int a = 0; a < 3; ++a) {
        float qs[7];
        const float cot_ef = axis_bwd(phi, s, strides[a], c, deep, pos,
                                      cot_gs, p, a == 1 && p5y, qs);
        cdx += (double)p.ef_dx * (double)cot_ef;
        for (int m2 = 0; m2 < 7; ++m2) qbuf[(a * 7 + m2) * na + s] = qs[m2];
      }
      if (!cl.owned) cdx = ch = 0.0;          // a neighbour shard's cell
    }
  }
  const long long nbricks = (long long)gridDim.x * gridDim.y * gridDim.z;
  const long long brick = lsf::brick_id();
  const double tdx = lsf::block_sum(cdx, red);
  __syncthreads();
  const double th = lsf::block_sum(ch, red);
  if (lsf::thread_rank() == 0) {
    partials[brick] = tdx;
    partials[nbricks + brick] = th;
  }
}

// Pass 2: for every owned cell, cot_phi[t] = direct[t] + sum over axes and
// shifts of q_k(t - k e), the sources inside the global grid only.
// cot_phi (owned-box layout) holds direct[t] on entry; each thread reads
// and writes only t.
__global__ void __launch_bounds__(NT)
reinit_bwd_gather(const float* __restrict__ qbuf, float* __restrict__ cot_phi,
                  BwdParams p, lsf::BlockGeom q) {
  const Cell cl = locate(p, q);
  if (!cl.owned) return;
  const long long sx = (long long)p.ny * p.nz, sy = p.nz;
  const long long na = (long long)p.nx * sx;
  const int pos[3] = {cl.gi, cl.gj, cl.gk};
  const long long st[3] = {sx, sy, 1};
  float acc = cot_phi[cl.ow];
  for (int a = 0; a < 3; ++a) {
    for (int m = 0; m < 7; ++m) {
      const int src = pos[a] - (m - 3);        // the center s = t - k e
      if (src >= 0 && src < q.g[a])
        acc = acc + __ldg(qbuf + (a * 7 + m) * na + cl.s - (m - 3) * st[a]);
    }
  }
  cot_phi[cl.ow] = acc;
}

int launch_bwd(const void* phi, const void* sgn_src, const void* g,
               void* cot_phi, void* cot_sign, void* qbuf, const BwdParams& p,
               const int* geom, const void* active, void* partials,
               void* sums, void* stream) {
  const lsf::BlockGeom q = lsf::block_geom(geom);
  const dim3 grid = lsf::block_launch_grid(geom);
  const dim3 block(BRICK, BRICK, BRICK);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* direct = static_cast<float*>(cot_phi);   // pass 1 writes it here
  float* qs = static_cast<float*>(qbuf);
  reinit_bwd_cells<<<grid, block, 0, st>>>(
      static_cast<const float*>(phi), static_cast<const float*>(sgn_src),
      static_cast<const float*>(g), direct, static_cast<float*>(cot_sign), qs,
      p, q, static_cast<const int*>(active), static_cast<double*>(partials));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reinit_bwd_gather<<<grid, block, 0, st>>>(qs, direct, p, q);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long nb = (long long)grid.x * grid.y * grid.z;
  double* part = static_cast<double*>(partials);
  double* out = static_cast<double*>(sums);
  lsf::reduce_partials<<<1, 1024, 0, st>>>(part, nb, out);
  lsf::reduce_partials<<<1, 1024, 0, st>>>(part + nb, nb, out + 1);
  return (int)cudaGetLastError();
}

}  // namespace

// Solo grid (dense, or banded with `active`): a block whose array is the
// whole grid and whose owned box is the whole grid.
extern "C" int lsf_reinit_bwd_f32(const void* phi, const void* sgn_src,
                                  const void* g, void* cot_phi,
                                  void* cot_sign, void* qbuf, int nx, int ny,
                                  int nz, float dx, float h, float dx2,
                                  float inv_dx2, float eps_scale,
                                  float eps_floor, float ef_dx, int p5_zero_y,
                                  const void* active, void* partials,
                                  void* sums, void* stream) {
  const BwdParams p{nx, ny, nz, dx, h, dx2, inv_dx2, eps_scale, eps_floor,
                    ef_dx, p5_zero_y};
  int geom[lsf::BLOCK_GEOM_INTS];
  lsf::solo_geom(nx, ny, nz, geom);
  return launch_bwd(phi, sgn_src, g, cot_phi, cot_sign, qbuf, p, geom, active,
                    partials, sums, stream);
}

// Block mode: one shard's padded block.  geom: BLOCK_GEOM_INTS host ints;
// nx, ny, nz: the padded array's dimensions, which must hold the owned box
// and 6 cells around it inside the global grid; cot_phi and cot_sign have
// the owned box's shape.
extern "C" int lsf_reinit_bwd_block_f32(const void* phi, const void* sgn_src,
                                        const void* g, void* cot_phi,
                                        void* cot_sign, void* qbuf, int nx,
                                        int ny, int nz, const int* geom,
                                        float dx, float h, float dx2,
                                        float inv_dx2, float eps_scale,
                                        float eps_floor, float ef_dx,
                                        int p5_zero_y, const void* active,
                                        void* partials, void* sums,
                                        void* stream) {
  const BwdParams p{nx, ny, nz, dx, h, dx2, inv_dx2, eps_scale, eps_floor,
                    ef_dx, p5_zero_y};
  return launch_bwd(phi, sgn_src, g, cot_phi, cot_sign, qbuf, p, geom, active,
                    partials, sums, stream);
}
