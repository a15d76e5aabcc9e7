// Kernel K5: the VJP of one reinitialization step (kernel K1) with respect
// to (phi, the sign source, dx, h).
//
// Replaces levelsetfortran_tpu/ops/weno_pallas.py:_pallas_bwd_padded (body:
// _make_bwd_kernel, _axis_gsq_bwd, _weno5_pair_hand, the jax.vjp of
// _tile_tail with guard_ad).  It differentiates K1's own per-axis forward
// (weno5.cuh, which both kernels include) with the same hand-chained
// adjoint as the TPU kernel, cell for cell:
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
// What bounds it on the H100: arithmetic.  A cell's forward costs ~400
// float operations and its adjoint about twice that, against 12 bytes in
// and 8 out; IEEE division and square root, no FMA (--fmad=false).
//
// The two-pass design of the first port wrote the 21 stencil cotangents
// q_k of every cell to a scratch array (168 bytes a cell of traffic, 1.3
// GiB at 256^3), evaluated each axis's forward three times per cell and, in
// banded mode, still wrote and read the 21 floats of every frozen cell.
// An axis's adjoint at a source cell needs only phi along that axis, the
// sign of the source, the deep flag and ONE scalar, the cotangent of the
// squared-gradient sum (cot_gs).  So:
//   pass 1 (reinit_bwd_cells, one thread per cell of 8^3 bricks) runs the
//     forward once per cell and the tail's adjoint: it writes the direct
//     cotangent (into cot_phi), cot_sign, the tail's scalar partials, and
//     cot_gs, one float per cell, to the scratch;
//   pass 2, one launch per axis in the plain order x, y, z, each adding
//     into the accumulator the previous one stored.  Along x and y
//     (reinit_bwd_axis<A>) a thread walks SEG owned cells of one line from
//     the top down: at source s it evaluates the axis's WENO5 forward once
//     and its adjoint from registers, and adds q_k(s) to the seven targets
//     s + k e, held in a sliding window of accumulators.  Walking down, a
//     target receives q_-3 (from s + 3) first and q_3 (from s - 3) last:
//     the plain order, k = -3..3.  Along z, where a walk would give each
//     thread of a warp its own line (0.98 of 2.1 ms at 222^3 on the H100),
//     a block holds lines of consecutive sources, one thread each
//     (reinit_bwd_ztile), the q's in shared memory, and each target adds
//     its seven in the same order; under a band mask z keeps the walk,
//     which skips frozen segments 38 sources at a time.  The epsilon-floor
//     terms go to the partials of the segment or tile that owns the
//     source.  A segment (or tile) with no stepped source within 3 (frozen
//     bricks, a face line) is skipped: its adds would all be +0.0, and an
//     accumulator is never -0.0 (the direct term is g + a ghost sum that
//     starts at +0.0), so skipping them leaves its bits.
// One launch is bitwise the first port's and two launches are bitwise
// equal: no float atomics; the scalar sums are per-brick and per-block
// float64 partials (fixed trees) added in a fixed order by reduce_partials
// (another order than the first port's).
//
// Banded mode (`active`, one int32 per 8^3 brick; the TPU kernel's
// `active`): the exact transpose of K1's banded mode.  A frozen brick's
// interior cells were copied, so their update cotangent passes through and
// they are no source of a stencil or sign cotangent (pass 2 adds +0.0 for
// them, or skips the segment); its global-face cells still took the ghost
// BC, so their transpose stays (see reinit_bwd_cells).
//
// Block mode (lsf_reinit_bwd_block_f32; the TPU kernel's `offsets`): one
// shard's block, padded on its sharded axes with 6 neighbour cells of phi,
// the sign source and the upstream cotangent g.  Unlike the TPU route,
// which scatters onto the halo and sends it back with a transpose exchange,
// the gather form is kept: pass 1 evaluates cot_gs on every cell within 3
// of the owned box (its stencil reaches 3 more, hence 6), pass 2 walks the
// owned lines with their sources within 3, so an owned cell's cotangent is
// the solo kernel's bitwise and no transpose exchange is needed.  Every
// mask is in global coordinates; the direct and sign cotangents are
// pointwise, written for the owned cells only (outputs in the owned box's
// shape); the sums count the owned cells.  A solo grid runs as the block
// whose array and owned box are the whole grid.
#include <algorithm>

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

// Adjoint of lsf::weno5: cot_p[0..5] from (cot_dm, cot_dp) and the
// forward's residuals w; returns the cotangent of the scaled epsilon floor.
__device__ __forceinline__ float weno5_bwd(const float* p,
                                           const lsf::Weno5& w,
                                           float eps_scale, bool p5_zero,
                                           float cot_wm, float cot_wp,
                                           float* cps) {
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

// Pass 1: for every in-grid cell within 3 of the owned box (the sources
// whose adjoints an owned cell gathers), cot_gs into the scratch (array
// layout; stepped cells only); for the owned cells also the direct and sign
// cotangents (owned-box layout) and the tail's scalar partials (pdx[brick]:
// cot_dx, ph[brick]: cot_h).
//
// Banded (active != nullptr): an interior cell of a frozen brick was copied
// by the forward, so its update's cotangent passes through as `direct`, its
// sign cotangent is 0, it is no source (pass 2 checks the mask) and it adds
// nothing to the scalars.  A global-face cell takes the ghost BC in every
// brick (K1's banded mode), so its transpose — the face cotangent onto the
// clamped inner neighbour and into cot_dx — is kept whatever its brick.
__global__ void __launch_bounds__(NT)
reinit_bwd_cells(const float* __restrict__ phi,
                 const float* __restrict__ sgn_src,
                 const float* __restrict__ g, float* __restrict__ direct,
                 float* __restrict__ cot_sign, float* __restrict__ gsbuf,
                 BwdParams p, lsf::BlockGeom q, const int* __restrict__ active,
                 double* __restrict__ pdx, double* __restrict__ ph) {
  __shared__ double red[2][NT];
  const Cell cl = locate(p, q);
  const long long sx = (long long)p.ny * p.nz, sy = p.nz;
  const long long s = cl.s;
  const long long brick = lsf::brick_id();
  if (active != nullptr && active[brick] == 0) {     // uniform per block
    // a frozen brick with no global-face cell and no face neighbour: its
    // owned cells pass g through (+ 0.0f, the ghost gather's zero) and it
    // adds nothing to the sums
    const int b0[3] = {q.o[0] + q.c[0] + (q.t0[0] + (int)blockIdx.z) * BRICK,
                       q.o[1] + q.c[1] + (q.t0[1] + (int)blockIdx.y) * BRICK,
                       q.o[2] + q.c[2] + (q.t0[2] + (int)blockIdx.x) * BRICK};
    bool face = false;
    for (int a = 0; a < 3; ++a)
      face |= b0[a] <= 1 || b0[a] + BRICK - 1 >= q.g[a] - 2;
    if (!face) {
      if (cl.owned) {
        direct[cl.ow] = g[s] + 0.0f;
        cot_sign[cl.ow] = 0.0f;
      }
      if (lsf::thread_rank() == 0) pdx[brick] = ph[brick] = 0.0;
      return;
    }
  }
  const bool near = cl.in_grid && cl.gi >= q.rms[0] - 3
                    && cl.gi < q.rms[1] + 3 && cl.gj >= q.rms[2] - 3
                    && cl.gj < q.rms[3] + 3 && cl.gk >= q.rms[4] - 3
                    && cl.gk < q.rms[5] + 3;
  const bool interior = cl.gi >= 1 && cl.gi <= q.g[0] - 2 && cl.gj >= 1
                        && cl.gj <= q.g[1] - 2 && cl.gk >= 1
                        && cl.gk <= q.g[2] - 2;
  double cdx = 0.0, ch = 0.0;
  if (near && !interior) {
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
      const float cot_sg = cot_hs * p.h;
      const float cot_m = cot_sg * ((-0.5f * sg) / m);
      const float cot_d2 = d2 > SIGN_FLOOR ? cot_m
                           : (d2 == SIGN_FLOOR ? 0.5f * cot_m : 0.0f);
      const float cot_gm = -((p.h * sg) * big_g) + p.dx2 * cot_d2;
      const float cot_u = nzm ? cot_gm * (0.5f / gm_safe) : 0.0f;
      gsbuf[s] = cot_u * p.inv_dx2;         // cot_gs, pass 2's one input
      if (cl.owned) {
        direct[cl.ow] = big_g;
        cot_sign[cl.ow] = cot_sg / sq + (2.0f * src) * cot_d2;
        ch = (double)(cot_hs * sg);
        cdx = (2.0 * (double)p.dx) * (double)(gm * cot_d2)
              - (2.0 * (double)p.dx * (double)p.inv_dx2 * (double)p.inv_dx2)
                * (double)(cot_u * gsum);
      }
    }
  }
  // both sums in block_sum's tree, side by side
  const int tid = lsf::thread_rank();
  red[0][tid] = cdx;
  red[1][tid] = ch;
  __syncthreads();
  for (int w = NT / 2; w > 0; w >>= 1) {
    if (tid < w) {
      red[0][tid] += red[0][tid + w];
      red[1][tid] += red[1][tid + w];
    }
    __syncthreads();
  }
  if (tid == 0) {
    pdx[brick] = red[0][0];
    ph[brick] = red[1][0];
  }
}

// One source cell's adjoint along one axis: f[0..6] = phi at s-3 .. s+3,
// its cot_gs and sign; writes the seven stencil cotangents q[0..6] (cells
// s-3 .. s+3) and returns the epsilon-floor cotangent (0 off the deep
// region).  The WENO5 forward runs once and its adjoint reads its
// residuals.
__device__ __forceinline__ float source_adjoint(const float* f, float cot_gs,
                                                bool pos, bool deep, bool p5z,
                                                const BwdParams& p,
                                                float* qs) {
  float pd[6];
#pragma unroll
  for (int m = 0; m < 6; ++m) pd[m] = f[m + 1] - f[m];
  float cps[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float cot_dm, cot_dp, cot_ef = 0.0f;
  if (deep) {
    lsf::Weno5 w;
    lsf::weno5(pd, p.eps_scale, p.eps_floor, p5z, w);
    godunov_bwd(w.dm, w.dp, pos, cot_gs, cot_dm, cot_dp);
    cot_ef = weno5_bwd(pd, w, p.eps_scale, p5z, cot_dm, cot_dp, cps);
  } else {
    godunov_bwd(pd[2], pd[3], pos, cot_gs, cot_dm, cot_dp);
    cps[2] = cot_dm;
    cps[3] = cot_dp;
  }
  qs[0] = -cps[0];
#pragma unroll
  for (int m = 1; m < 6; ++m) qs[m] = cps[m - 1] - cps[m];
  qs[6] = cps[5];
  return cot_ef;
}

// A fixed-order sum of one double per thread of an NT-thread block (NT a
// multiple of 32): a shuffle tree in each warp, then the warps' sums in
// thread 0.  Every thread must call it; thread 0 gets the sum.
template <int NT>
__device__ __forceinline__ double warp_tree_sum(double v, double* red) {
  const int tid = threadIdx.x + blockDim.x * threadIdx.y;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((tid & 31) == 0) red[tid >> 5] = v;
  __syncthreads();
  double total = 0.0;
  if (tid == 0)
    for (int w = 0; w < NT / 32; ++w) total += red[w];
  return total;
}

// Pass 2, axis A: SEG owned cells of one line along A per thread, the
// lines' other two coordinates across the threads (the last one fastest).
constexpr int SEG = 32, AX_NT = 128;

template <int A>
__device__ __forceinline__ void axis_lines(const lsf::BlockGeom& q, int& nu,
                                           int& nv, int& nseg) {
  constexpr int U = A == 0 ? 1 : 0, V = A == 2 ? 1 : 2;
  nu = q.rms[2 * U + 1] - q.rms[2 * U];
  nv = q.rms[2 * V + 1] - q.rms[2 * V];
  nseg = (q.rms[2 * A + 1] - q.rms[2 * A] + SEG - 1) / SEG;
}

inline long long axis_blocks(const lsf::BlockGeom& q, int a) {
  const int u = a == 0 ? 1 : 0, v = a == 2 ? 1 : 2;
  const long long n = (long long)(q.rms[2 * u + 1] - q.rms[2 * u])
                      * (q.rms[2 * v + 1] - q.rms[2 * v])
                      * ((q.rms[2 * a + 1] - q.rms[2 * a] + SEG - 1) / SEG);
  return (n + AX_NT - 1) / AX_NT;
}

// cot_phi (owned-box layout) holds each owned cell's accumulator: the
// direct term, plus the earlier axes' terms.  Each thread reads and writes
// only its own segment's cells; partials[blockIdx.x]: the epsilon-floor
// terms of its segments' sources (cot_dx).
template <int A>
__global__ void __launch_bounds__(AX_NT)
reinit_bwd_axis(const float* __restrict__ phi,
                const float* __restrict__ sgn_src,
                const float* __restrict__ gsbuf, float* __restrict__ cot_phi,
                BwdParams p, lsf::BlockGeom q, const int* __restrict__ active,
                double* __restrict__ partials) {
  constexpr int U = A == 0 ? 1 : 0, V = A == 2 ? 1 : 2;
  __shared__ double red[AX_NT / 32];
  int nu, nv, nseg;
  axis_lines<A>(q, nu, nv, nseg);
  const long long id = (long long)blockIdx.x * AX_NT + threadIdx.x;
  double cdx = 0.0;
  if (id < (long long)nu * nv * nseg) {
    const int n[3] = {p.nx, p.ny, p.nz};
    const long long st[3] = {(long long)p.ny * p.nz, p.nz, 1};
    const int ob[3] = {q.rms[0], q.rms[2], q.rms[4]};
    const long long ost[3] = {
        (long long)(q.rms[3] - q.rms[2]) * (q.rms[5] - q.rms[4]),
        q.rms[5] - q.rms[4], 1};
    const int gv = ob[V] + (int)(id % nv);
    const int gu = ob[U] + (int)((id / nv) % nu);
    const int lo = ob[A] + (int)(id / ((long long)nv * nu)) * SEG;
    const int hi = min(lo + SEG, q.rms[2 * A + 1]) - 1;    // targets lo..hi
    const int ga = q.g[A];
    const bool uv_interior = gu >= 1 && gu <= q.g[U] - 2 && gv >= 1
                             && gv <= q.g[V] - 2;
    const bool uv_deep = gu >= 4 && gu <= q.g[U] - 5 && gv >= 4
                         && gv <= q.g[V] - 5;
    int cell[3];
    cell[U] = gu - q.o[U];
    cell[V] = gv - q.o[V];
    // any stepped source within 3 of the segment?
    bool live = uv_interior;
    if (live && active != nullptr) {
      live = false;
      const int s0 = max(lo - 3, 1) - q.o[A];
      const int s1 = min(hi + 3, ga - 2) - q.o[A];
      for (int b = (s0 - q.c[A]) / BRICK; b <= (s1 - q.c[A]) / BRICK; ++b) {
        cell[A] = q.c[A] + b * BRICK;
        live |= lsf::block_brick_active(active, q, cell[0], cell[1], cell[2]);
      }
    }
    if (live) {
      const long long base = (long long)cell[U] * st[U]
                             + (long long)cell[V] * st[V];
      const long long obase = (long long)(gu - ob[U]) * ost[U]
                              + (long long)(gv - ob[V]) * ost[V];
      const bool p5z = A == 1 && p.p5_zero_y != 0;
      auto at = [&](int s) { return base + (long long)(s - q.o[A]) * st[A]; };
      auto ld = [&](int s) {
        const int i = s - q.o[A];
        return i >= 0 && i < n[A] ? __ldg(phi + at(s)) : 0.0f;
      };
      // the next source's inputs are loaded an iteration ahead, so that
      // their latency overlaps this source's adjoint
      auto in_array = [&](int s) {
        return s - q.o[A] >= 0 && s - q.o[A] < n[A];
      };
      auto target = [&](int t) { return t >= lo && t <= hi; };
      auto acc_at = [&](int t) {
        return cot_phi + obase + (long long)(t - ob[A]) * ost[A];
      };
      float f[7], acc[7];
#pragma unroll
      for (int m = 0; m < 7; ++m) acc[m] = 0.0f;
      const int top = hi + 3;
#pragma unroll
      for (int m = 0; m < 7; ++m) f[m] = ld(top - 3 + m);
      float gs = in_array(top) ? gsbuf[at(top)] : 0.0f;
      float sg = in_array(top) ? __ldg(sgn_src + at(top)) : 0.0f;
      float acc_in = target(top - 3) ? *acc_at(top - 3) : 0.0f;
      for (int s = top; s >= lo - 3; --s) {   // f[m] = phi(s - 3 + m)
        const float f_n = ld(s - 4);
        const float gs_n = in_array(s - 1) ? gsbuf[at(s - 1)] : 0.0f;
        const float sg_n = in_array(s - 1) ? __ldg(sgn_src + at(s - 1))
                                           : 0.0f;
        const float acc_n = target(s - 4) ? *acc_at(s - 4) : 0.0f;
        acc[0] = acc_in;                       // target s - 3 enters
        if (s >= 0 && s < ga) {                // a source in the grid
          float qs[7];
#pragma unroll
          for (int m = 0; m < 7; ++m) qs[m] = 0.0f;
          cell[A] = s - q.o[A];
          if (s >= 1 && s <= ga - 2
              && lsf::block_brick_active(active, q, cell[0], cell[1],
                                         cell[2])) {
            const float cot_ef = source_adjoint(
                f, gs, sg > 0.0f, uv_deep && s >= 4 && s <= ga - 5, p5z, p,
                qs);
            if (target(s)) cdx += (double)p.ef_dx * (double)cot_ef;
          }
#pragma unroll
          for (int m = 0; m < 7; ++m) acc[m] = acc[m] + qs[m];
        }
        if (target(s + 3)) *acc_at(s + 3) = acc[6];   // target complete
#pragma unroll
        for (int m = 6; m > 0; --m) {
          acc[m] = acc[m - 1];
          f[m] = f[m - 1];
        }
        f[0] = f_n;
        gs = gs_n;
        sg = sg_n;
        acc_in = acc_n;
      }
    }
  }
  const double total = warp_tree_sum<AX_NT>(cdx, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

// Pass 2 along z, the contiguous axis, where a walk would give each thread
// of a warp its own line: a block holds ZL lines of ZT consecutive sources,
// one thread per source, so a warp reads 32 neighbouring cells.  The
// sources' q's go to shared memory; then each of the ZN = ZT - 6 targets of
// a line adds its seven terms in the plain order (k = -3..3: the source
// t + 3 first).  partials[blockIdx.x]: the epsilon-floor terms of the
// sources that are this block's targets.
constexpr int ZT = 128, ZL = 2, ZN = ZT - 6;

__host__ __device__ inline long long ztile_count(const lsf::BlockGeom& q) {
  return (q.rms[5] - q.rms[4] + ZN - 1) / ZN;
}

inline long long ztile_blocks(const lsf::BlockGeom& q) {
  const long long lines = (long long)(q.rms[1] - q.rms[0])
                          * (q.rms[3] - q.rms[2]);
  return (lines + ZL - 1) / ZL * ztile_count(q);
}

__global__ void __launch_bounds__(ZT * ZL)
reinit_bwd_ztile(const float* __restrict__ phi,
                 const float* __restrict__ sgn_src,
                 const float* __restrict__ gsbuf, float* __restrict__ cot_phi,
                 BwdParams p, lsf::BlockGeom q, const int* __restrict__ active,
                 double* __restrict__ partials) {
  __shared__ float qsh[7][ZL][ZT];
  __shared__ int ing[ZL][ZT];
  __shared__ double red[ZT * ZL / 32];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * ZT + tx;
  const int nyo = q.rms[3] - q.rms[2], nzo = q.rms[5] - q.rms[4];
  const long long lines = (long long)(q.rms[1] - q.rms[0]) * nyo;
  const long long ntiles = ztile_count(q);
  const long long line = (blockIdx.x / ntiles) * ZL + ty;
  const int lo = q.rms[4] + (int)(blockIdx.x % ntiles) * ZN;
  const int hi = min(lo + ZN, q.rms[5]) - 1;            // targets lo..hi
  const int s = lo - 3 + tx;                            // this thread's source
  const bool line_ok = line < lines;
  const int gi = line_ok ? q.rms[0] + (int)(line / nyo) : 0;
  const int gj = line_ok ? q.rms[2] + (int)(line % nyo) : 0;
  const long long sy = p.nz, sx = (long long)p.ny * p.nz;
  const long long base = (long long)(gi - q.o[0]) * sx
                         + (long long)(gj - q.o[1]) * sy;
  const bool stepped = line_ok && gi >= 1 && gi <= q.g[0] - 2 && gj >= 1
                       && gj <= q.g[1] - 2 && s >= 1 && s <= q.g[2] - 2
                       && lsf::block_brick_active(active, q, gi - q.o[0],
                                                  gj - q.o[1], s - q.o[2]);
  if (!__syncthreads_or(stepped)) {           // every add would be +0.0
    if (tid == 0) partials[blockIdx.x] = 0.0;
    return;
  }
  // this thread's target's accumulator, read before the source's adjoint
  // so that its latency overlaps it
  const int t = lo + tx;
  const bool target = line_ok && tx < ZN && t <= hi;
  const long long ow = ((long long)(gi - q.rms[0]) * nyo + (gj - q.rms[2]))
                       * nzo + (t - q.rms[4]);
  float acc = target ? cot_phi[ow] : 0.0f;
  float qs[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  double cdx = 0.0;
  if (stepped) {
    const long long i = base + (s - q.o[2]);
    const bool deep = gi >= 4 && gi <= q.g[0] - 5 && gj >= 4
                      && gj <= q.g[1] - 5 && s >= 4 && s <= q.g[2] - 5;
    float f[7];
#pragma unroll
    for (int m = 0; m < 7; ++m) {
      const int c = s - q.o[2] + m - 3;
      f[m] = c >= 0 && c < p.nz ? __ldg(phi + base + c) : 0.0f;
    }
    const float cot_ef = source_adjoint(f, gsbuf[i], __ldg(sgn_src + i) > 0.0f,
                                        deep, false, p, qs);
    if (s >= lo && s <= hi) cdx = (double)p.ef_dx * (double)cot_ef;
  }
#pragma unroll
  for (int m = 0; m < 7; ++m) qsh[m][ty][tx] = qs[m];
  ing[ty][tx] = line_ok && s >= 0 && s < q.g[2];
  __syncthreads();
  if (target) {
#pragma unroll
    for (int m = 0; m < 7; ++m)               // k = m - 3: source t - k
      if (ing[ty][tx + 6 - m]) acc = acc + qsh[m][ty][tx + 6 - m];
    cot_phi[ow] = acc;
  }
  const double total = warp_tree_sum<ZT * ZL>(cdx, red);
  if (tid == 0) partials[blockIdx.x] = total;
}

// Partials: pass 1's cot_dx per brick, then each axis launch's per block,
// then pass 1's cot_h per brick.
long long partials_count(const lsf::BlockGeom& q, dim3 grid, long long* ncdx) {
  const long long nb = (long long)grid.x * grid.y * grid.z;
  *ncdx = nb + axis_blocks(q, 0) + axis_blocks(q, 1)
          + std::max(ztile_blocks(q), axis_blocks(q, 2));
  return *ncdx + nb;
}

int launch_bwd(const void* phi, const void* sgn_src, const void* g,
               void* cot_phi, void* cot_sign, void* gsbuf, const BwdParams& p,
               const int* geom, const void* active, void* partials,
               void* sums, void* stream) {
  const lsf::BlockGeom q = lsf::block_geom(geom);
  const dim3 grid = lsf::block_launch_grid(geom);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ph = static_cast<const float*>(phi);
  const float* sg = static_cast<const float*>(sgn_src);
  const int* act = static_cast<const int*>(active);
  float* cp = static_cast<float*>(cot_phi);   // pass 1 writes `direct` here
  float* gs = static_cast<float*>(gsbuf);
  double* part = static_cast<double*>(partials);
  long long ncdx;
  partials_count(q, grid, &ncdx);
  const long long nb = (long long)grid.x * grid.y * grid.z;
  reinit_bwd_cells<<<grid, dim3(BRICK, BRICK, BRICK), 0, st>>>(
      ph, sg, static_cast<const float*>(g), cp, static_cast<float*>(cot_sign),
      gs, p, q, act, part, part + ncdx);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  long long off = nb;
  const unsigned b0 = (unsigned)axis_blocks(q, 0);
  const unsigned b1 = (unsigned)axis_blocks(q, 1);
  reinit_bwd_axis<0><<<b0, AX_NT, 0, st>>>(ph, sg, gs, cp, p, q, act,
                                           part + off);
  off += b0;
  reinit_bwd_axis<1><<<b1, AX_NT, 0, st>>>(ph, sg, gs, cp, p, q, act,
                                           part + off);
  off += b1;
  // z: the tile when every source steps (coalesced), the walk under a
  // band mask (it skips frozen segments 38 sources at a time, where a tile
  // holds its block for one live warp); unused partial slots stay zero
  const long long b2t = ztile_blocks(q), b2w = axis_blocks(q, 2);
  if (act == nullptr) {
    reinit_bwd_ztile<<<(unsigned)b2t, dim3(ZT, ZL), 0, st>>>(
        ph, sg, gs, cp, p, q, act, part + off);
  } else {
    reinit_bwd_axis<2><<<(unsigned)b2w, AX_NT, 0, st>>>(ph, sg, gs, cp, p,
                                                         q, act, part + off);
  }
  const long long used = act == nullptr ? b2t : b2w;
  if (used < std::max(b2t, b2w))
    cudaMemsetAsync(part + off + used, 0,
                    sizeof(double) * (std::max(b2t, b2w) - used), st);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  double* out = static_cast<double*>(sums);
  lsf::reduce_partials<<<1, 1024, 0, st>>>(part, ncdx, out);
  lsf::reduce_partials<<<1, 1024, 0, st>>>(part + ncdx, nb, out + 1);
  return (int)cudaGetLastError();
}

}  // namespace

// The float64 partials a launch needs (the wrapper allocates them): solo
// grid with geom == nullptr, else the block geometry's host ints.
extern "C" long long lsf_reinit_bwd_partials(int nx, int ny, int nz,
                                             const int* geom) {
  int solo[lsf::BLOCK_GEOM_INTS];
  if (geom == nullptr) {
    lsf::solo_geom(nx, ny, nz, solo);
    geom = solo;
  }
  long long ncdx;
  return partials_count(lsf::block_geom(geom), lsf::block_launch_grid(geom),
                        &ncdx);
}

// Solo grid (dense, or banded with `active`): a block whose array is the
// whole grid and whose owned box is the whole grid.  gs_scratch: one float
// per cell (cot_gs between the passes).
extern "C" int lsf_reinit_bwd_f32(const void* phi, const void* sgn_src,
                                  const void* g, void* cot_phi,
                                  void* cot_sign, void* gs_scratch, int nx,
                                  int ny, int nz, float dx, float h,
                                  float dx2, float inv_dx2, float eps_scale,
                                  float eps_floor, float ef_dx, int p5_zero_y,
                                  const void* active, void* partials,
                                  void* sums, void* stream) {
  const BwdParams p{nx, ny, nz, dx, h, dx2, inv_dx2, eps_scale, eps_floor,
                    ef_dx, p5_zero_y};
  int geom[lsf::BLOCK_GEOM_INTS];
  lsf::solo_geom(nx, ny, nz, geom);
  return launch_bwd(phi, sgn_src, g, cot_phi, cot_sign, gs_scratch, p, geom,
                    active, partials, sums, stream);
}

// Block mode: one shard's padded block.  geom: BLOCK_GEOM_INTS host ints;
// nx, ny, nz: the padded array's dimensions, which must hold the owned box
// and 6 cells around it inside the global grid; cot_phi and cot_sign have
// the owned box's shape; gs_scratch the padded array's.
extern "C" int lsf_reinit_bwd_block_f32(const void* phi, const void* sgn_src,
                                        const void* g, void* cot_phi,
                                        void* cot_sign, void* gs_scratch,
                                        int nx, int ny, int nz,
                                        const int* geom, float dx, float h,
                                        float dx2, float inv_dx2,
                                        float eps_scale, float eps_floor,
                                        float ef_dx, int p5_zero_y,
                                        const void* active, void* partials,
                                        void* sums, void* stream) {
  const BwdParams p{nx, ny, nz, dx, h, dx2, inv_dx2, eps_scale, eps_floor,
                    ef_dx, p5_zero_y};
  return launch_bwd(phi, sgn_src, g, cot_phi, cot_sign, gs_scratch, p, geom,
                    active, partials, sums, stream);
}
