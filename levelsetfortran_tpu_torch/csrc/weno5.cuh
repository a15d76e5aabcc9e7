// The per-axis forward of one reinitialization step, shared by kernel K1
// (reinit_step.cu) and its adjoint K5 (reinit_bwd.cu), so that K5
// differentiates exactly the arithmetic K1 runs:
//   * HJ-WENO5 one-sided derivatives (d_minus, d_plus) from the six RAW
//     neighbour differences (no 1/dx), the epsilon floor carrying the dx^2
//     scale, the weight ratios floored at 1e-7;
//   * the Godunov selection by the frozen sign source.
// The residual structs keep what the adjoint reads; in K1 the compiler
// drops the fields nothing reads.  Keep the statements in this order: on
// the H100 another order of the same operations cost K1 7 registers and
// ~10% of its time.
#pragma once

#include <cuda_runtime.h>

namespace lsf {

constexpr float RATIO_FLOOR = 1e-7f;

// One normalized-weight evaluation (w0, w2) over the common denominator
// (d0 d1 d2)^2, with its residuals.
struct Weights {
  float d0, d1, d2, m12, inv, r0, r1, r2, h0, h1, h2, u0, u1, u2, r, w0, w2;
};

__device__ __forceinline__ void weights_fwd(float eps, float is0, float is1,
                                            float is2, Weights& s) {
  s.d0 = eps + is0;
  s.d1 = eps + is1;
  s.d2 = eps + is2;
  s.m12 = fmaxf(s.d1, s.d2);
  s.inv = 1.0f / fmaxf(s.d0, s.m12);
  s.r0 = s.d0 * s.inv;
  s.r1 = s.d1 * s.inv;
  s.r2 = s.d2 * s.inv;
  s.h0 = fmaxf(s.r0, RATIO_FLOOR);
  s.h1 = fmaxf(s.r1, RATIO_FLOOR);
  s.h2 = fmaxf(s.r2, RATIO_FLOOR);
  s.u0 = s.h1 * s.h2;
  s.u1 = s.h0 * s.h2;
  s.u2 = s.h0 * s.h1;
  const float t0 = s.u0 * s.u0;
  const float t1 = 6.0f * (s.u1 * s.u1);
  const float t2 = 3.0f * (s.u2 * s.u2);
  s.r = 1.0f / ((t0 + t1) + t2);
  s.w0 = t0 * s.r;
  s.w2 = t2 * s.r;
}

__device__ __forceinline__ float is_term(float sq_diff, float c) {
  return 13.0f * sq_diff + 3.0f * (c * c);
}

// WENO5 of one axis and its residuals.
struct Weno5 {
  float bp, bm, cp, ab_p, ab_m, bc_p, bc_m;        // differences of p
  float p0s, p1s, p2s, p3s, p4s, p5s, c12, c34, common4;   // epsilon's max
  Weights wp, wm;
  float dm, dp;
};

// (d_minus, d_plus) from the six one-sided raw differences p[0..5].
__device__ __forceinline__ void weno5(const float* p, float eps_scale,
                                      float eps_floor, bool p5_zero,
                                      Weno5& r) {
  const float ap = p[5] - p[4];
  const float am = p[1] - p[0];
  r.bp = p[4] - p[3];
  r.bm = p[2] - p[1];
  r.cp = p[3] - p[2];
  r.ab_p = ap - r.bp;
  r.ab_m = am - r.bm;
  r.bc_p = r.bp - r.cp;
  r.bc_m = r.bm - r.cp;
  const float sq_ab_p = r.ab_p * r.ab_p;
  const float sq_ab_m = r.ab_m * r.ab_m;
  const float sq_bc_p = r.bc_p * r.bc_p;
  const float sq_bc_m = r.bc_m * r.bc_m;
  const float is0p = is_term(sq_ab_p, r.ab_p - 2.0f * r.bp);
  const float is0m = is_term(sq_ab_m, r.ab_m - 2.0f * r.bm);
  const float is1p = is_term(sq_bc_p, r.bp + r.cp);
  const float is1m = is_term(sq_bc_m, r.bm + r.cp);
  const float is2p = is_term(sq_bc_m, 3.0f * r.cp - r.bm);
  const float is2m = is_term(sq_bc_p, 3.0f * r.cp - r.bp);
  r.p0s = p[0] * p[0];
  r.p1s = p[1] * p[1];
  r.p2s = p[2] * p[2];
  r.p3s = p[3] * p[3];
  r.p4s = p[4] * p[4];
  r.p5s = p[5] * p[5];
  r.c12 = fmaxf(r.p1s, r.p2s);
  r.c34 = fmaxf(r.p3s, r.p4s);
  r.common4 = fmaxf(r.c12, r.c34);
  const float epsp = p5_zero ? eps_scale * r.common4 + eps_floor
                             : eps_scale * fmaxf(r.common4, r.p5s) + eps_floor;
  const float epsm = eps_scale * fmaxf(r.common4, r.p0s) + eps_floor;
  weights_fwd(epsp, is0p, is1p, is2p, r.wp);
  weights_fwd(epsm, is0m, is1m, is2m, r.wm);
  const float third = 1.0f / 3.0f;
  const float sixth = 1.0f / 6.0f;
  const float pwp = (r.wp.w0 * (r.ab_p - r.bc_p)) * third
                    + ((r.wp.w2 - 0.5f) * (r.bc_p + r.bc_m)) * sixth;
  const float pwm = (r.wm.w0 * (r.ab_m - r.bc_m)) * third
                    + ((r.wm.w2 - 0.5f) * (r.bc_m + r.bc_p)) * sixth;
  const float common = (7.0f * (p[2] + p[3]) - (p[1] + p[4])) * (1.0f / 12.0f);
  r.dm = common - pwm;
  r.dp = common + pwp;
}

// Godunov-selected derivative (>= 0): max(d_m, -d_p, 0) where the sign
// source is positive, max(d_p, -d_m, 0) elsewhere.
__device__ __forceinline__ float godunov(float dm, float dp, bool pos) {
  return pos ? fmaxf(fmaxf(dm, -dp), 0.0f) : fmaxf(fmaxf(dp, -dm), 0.0f);
}

}  // namespace lsf
