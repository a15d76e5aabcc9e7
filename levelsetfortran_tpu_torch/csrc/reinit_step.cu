// Kernel K1: one Jacobi reinitialization step, phi_t = sgn(phi_0)(1 - |grad phi|).
//
// Replaces levelsetfortran_tpu/ops/weno_pallas.py:_pallas_step_padded (body:
// _make_kernel, _tile_step_values, _tile_axis_gsq, _weno5_pair,
// _godunov_axis, _tile_tail).  Same math, cell for cell:
//   * HJ-WENO5 one-sided derivatives per axis from RAW neighbour
//     differences (no 1/dx), the epsilon floor carrying the dx^2 scale and
//     the weight-ratio floor 1e-7; first-order one-sided differences
//     outside the depth-4 deep region;
//   * Godunov selection by the frozen sign source, |grad| = sqrt(sum/dx^2);
//   * smeared sign s / sqrt(max(s^2 + dx^2 |grad|, 1e-20));
//   * Euler update on the interior;
//   * ghost BC: a face cell is its clamped inner neighbour (x, then y, then
//     z clamp: the diagonal neighbour at edges and corners) plus dx, read
//     AFTER that neighbour's update.
// The TPU kernel gets the updated neighbour by computing a +1 ring around
// each tile.  Here a face cell's thread computes its inner neighbour's
// update itself, so every thread evaluates exactly one stencil and no
// block depends on another — in banded mode too, where the neighbour's
// brick may be frozen.
//
// What bounds it on the H100: arithmetic.  A cell costs ~400 float
// operations, 13 of them IEEE divisions, and 2 square roots, against 12
// bytes of unique device-memory traffic (phi and the sign source in, phi
// out); the 19-point stencil re-reads neighbours through L1.  The design
// keeps every intermediate in registers, one thread per cell, 8^3-cell
// bricks per block so that the re-reads hit L1, and skips inactive bricks
// of the narrow band outright.
//
// Narrow band: `active` holds one int32 per brick.  An inactive brick either
// copies its cells (copy_inactive: the first "mint" step of a chunk) or
// writes nothing, because the ping-pong buffer already holds its values
// (the TPU kernel's `carry`).  One departure from the TPU kernel: the face
// cells of a frozen brick still take the ghost BC every step, from their
// inner neighbour's value after the step, so the banded field satisfies
// the BC everywhere, as the dense one does (frozen TPU tiles keep stale
// faces).  `partials` (optional) receives each brick's sum of squared
// changes for the deterministic second pass.
#include "common.cuh"

namespace {

using lsf::BRICK;
using lsf::NT;

struct StepParams {
  int nx, ny, nz;
  float dx, h, dx2, inv_dx2, eps_scale, eps_floor;   // eps_floor: dx^2-scaled
  int p5_zero_y;
};

__device__ __forceinline__ float is_term(float sq_diff, float c) {
  return 13.0f * sq_diff + 3.0f * (c * c);
}

// (w0, w2) over the common denominator (d0 d1 d2)^2, ratios floored at 1e-7.
__device__ __forceinline__ void weights(float eps, float is0, float is1,
                                        float is2, float& w0, float& w2) {
  float d0 = eps + is0;
  float d1 = eps + is1;
  float d2 = eps + is2;
  const float inv_max = 1.0f / fmaxf(d0, fmaxf(d1, d2));
  d0 = fmaxf(d0 * inv_max, 1e-7f);
  d1 = fmaxf(d1 * inv_max, 1e-7f);
  d2 = fmaxf(d2 * inv_max, 1e-7f);
  const float q0 = d1 * d2;
  const float q1 = d0 * d2;
  const float q2 = d0 * d1;
  const float t0 = q0 * q0;
  const float t1 = 6.0f * (q1 * q1);
  const float t2 = 3.0f * (q2 * q2);
  const float r = 1.0f / ((t0 + t1) + t2);
  w0 = t0 * r;
  w2 = t2 * r;
}

// WENO5 (d_minus, d_plus) from the six one-sided raw differences.
__device__ __forceinline__ void weno5_pair(float p0, float p1, float p2,
                                           float p3, float p4, float p5,
                                           float eps_scale, float eps_floor,
                                           bool p5_zero, float& dm,
                                           float& dp) {
  const float ap = p5 - p4;
  const float am = p1 - p0;
  const float bp = p4 - p3;
  const float bm = p2 - p1;
  const float cp = p3 - p2;
  const float ab_p = ap - bp;
  const float ab_m = am - bm;
  const float bc_p = bp - cp;
  const float bc_m = bm - cp;
  const float sq_ab_p = ab_p * ab_p;
  const float sq_ab_m = ab_m * ab_m;
  const float sq_bc_p = bc_p * bc_p;
  const float sq_bc_m = bc_m * bc_m;
  const float is0p = is_term(sq_ab_p, ab_p - 2.0f * bp);
  const float is0m = is_term(sq_ab_m, ab_m - 2.0f * bm);
  const float is1p = is_term(sq_bc_p, bp + cp);
  const float is1m = is_term(sq_bc_m, bm + cp);
  const float is2p = is_term(sq_bc_m, 3.0f * cp - bm);
  const float is2m = is_term(sq_bc_p, 3.0f * cp - bp);
  const float common4 = fmaxf(fmaxf(p1 * p1, p2 * p2), fmaxf(p3 * p3, p4 * p4));
  const float epsp = p5_zero ? eps_scale * common4 + eps_floor
                             : eps_scale * fmaxf(common4, p5 * p5) + eps_floor;
  const float epsm = eps_scale * fmaxf(common4, p0 * p0) + eps_floor;
  float w0p, w2p, w0m, w2m;
  weights(epsp, is0p, is1p, is2p, w0p, w2p);
  weights(epsm, is0m, is1m, is2m, w0m, w2m);
  const float third = 1.0f / 3.0f;
  const float sixth = 1.0f / 6.0f;
  const float pwp = (w0p * (ab_p - bc_p)) * third
                    + ((w2p - 0.5f) * (bc_p + bc_m)) * sixth;
  const float pwm = (w0m * (ab_m - bc_m)) * third
                    + ((w2m - 0.5f) * (bc_m + bc_p)) * sixth;
  const float common = (7.0f * (p2 + p3) - (p1 + p4)) * (1.0f / 12.0f);
  dm = common - pwm;
  dp = common + pwp;
}

// Squared Godunov-selected derivative: max(m, -p, 0)^2 or max(p, -m, 0)^2.
__device__ __forceinline__ float godunov_sq(float dm, float dp, bool pos) {
  const float g = pos ? fmaxf(fmaxf(dm, -dp), 0.0f)
                      : fmaxf(fmaxf(dp, -dm), 0.0f);
  return g * g;
}

// One axis's squared derivative at interior cell s (stride st along it).
__device__ __forceinline__ float axis_gsq(const float* __restrict__ phi,
                                          long long s, long long st, float c,
                                          bool deep, bool pos,
                                          const StepParams& p, bool p5_zero) {
  float dm, dp;
  if (deep) {
    const float vm3 = __ldg(phi + s - 3 * st);
    const float vm2 = __ldg(phi + s - 2 * st);
    const float vm1 = __ldg(phi + s - st);
    const float vp1 = __ldg(phi + s + st);
    const float vp2 = __ldg(phi + s + 2 * st);
    const float vp3 = __ldg(phi + s + 3 * st);
    weno5_pair(vm2 - vm3, vm1 - vm2, c - vm1, vp1 - c, vp2 - vp1, vp3 - vp2,
               p.eps_scale, p.eps_floor, p5_zero, dm, dp);
  } else {
    dm = c - __ldg(phi + s - st);
    dp = __ldg(phi + s + st) - c;
  }
  return godunov_sq(dm, dp, pos);
}

// The Euler-updated value of interior cell (i, j, k).
__device__ float cell_update(const float* __restrict__ phi,
                             const float* __restrict__ sgn_src, int i, int j,
                             int k, const StepParams& p) {
  const long long sx = (long long)p.ny * p.nz;
  const long long sy = p.nz;
  const long long s = i * sx + j * sy + k;
  const float c = __ldg(phi + s);
  const float src = __ldg(sgn_src + s);
  const bool pos = src > 0.0f;
  const bool deep = i >= 4 && i <= p.nx - 5 && j >= 4 && j <= p.ny - 5
                    && k >= 4 && k <= p.nz - 5;
  float sum = axis_gsq(phi, s, sx, c, deep, pos, p, false);
  sum = sum + axis_gsq(phi, s, sy, c, deep, pos, p, p.p5_zero_y != 0);
  sum = sum + axis_gsq(phi, s, 1, c, deep, pos, p, false);
  const float gm = sqrtf(sum * p.inv_dx2);
  const float d2 = src * src + p.dx2 * gm;
  const float sg = src / sqrtf(fmaxf(d2, 1e-20f));
  return c + (p.h * sg) * (1.0f - gm);
}

__device__ __forceinline__ int clamp_inner(int i, int n) {
  return i == 0 ? 1 : (i == n - 1 ? n - 2 : i);
}

__device__ __forceinline__ bool brick_active(const int* __restrict__ active,
                                             int i, int j, int k) {
  if (active == nullptr) return true;
  return active[((long long)(i / BRICK) * gridDim.y + j / BRICK) * gridDim.x
                + k / BRICK] != 0;
}

__global__ void __launch_bounds__(NT)
reinit_step_kernel(const float* __restrict__ phi,
                   const float* __restrict__ sgn_src, float* __restrict__ out,
                   StepParams p, const int* __restrict__ active,
                   int copy_inactive, double* __restrict__ partials) {
  __shared__ double red[NT];
  const int x0 = blockIdx.z * BRICK, y0 = blockIdx.y * BRICK;
  const int z0 = blockIdx.x * BRICK;
  const int i = x0 + threadIdx.z, j = y0 + threadIdx.y, k = z0 + threadIdx.x;
  const long long brick = lsf::brick_id();
  const bool in_grid = i < p.nx && j < p.ny && k < p.nz;
  const long long idx = ((long long)i * p.ny + j) * p.nz + k;
  const bool live = brick_active(active, x0, y0, z0);
  const bool on_face = x0 == 0 || y0 == 0 || z0 == 0 || x0 + BRICK >= p.nx
                       || y0 + BRICK >= p.ny || z0 + BRICK >= p.nz;
  if (!live && !copy_inactive && !on_face) {          // uniform per block
    if (partials != nullptr && lsf::thread_rank() == 0) partials[brick] = 0.0;
    return;
  }
  double dd = 0.0;
  if (in_grid) {
    const int si = clamp_inner(i, p.nx);
    const int sj = clamp_inner(j, p.ny);
    const int sk = clamp_inner(k, p.nz);
    const bool face = si != i || sj != j || sk != k;
    if (live || face) {
      // a face cell of a frozen brick still takes the ghost BC, from its
      // inner neighbour's value after this step (updated iff that
      // neighbour's brick is active)
      const float v = brick_active(active, si, sj, sk)
          ? cell_update(phi, sgn_src, si, sj, sk, p)
          : phi[((long long)si * p.ny + sj) * p.nz + sk];
      const float res = face ? v + p.dx : v;
      out[idx] = res;
      const float d = res - phi[idx];
      dd = (double)d * (double)d;
    } else if (copy_inactive) {
      out[idx] = phi[idx];
    }
  }
  if (partials != nullptr) {
    const double total = lsf::block_sum(dd, red);
    if (lsf::thread_rank() == 0) partials[brick] = total;
  }
}

}  // namespace

extern "C" int lsf_reinit_step_f32(const void* phi, const void* sgn_src,
                                   void* out, int nx, int ny, int nz,
                                   float dx, float h, float dx2,
                                   float inv_dx2, float eps_scale,
                                   float eps_floor, int p5_zero_y,
                                   const void* active, int copy_inactive,
                                   void* partials, void* dsq, void* stream) {
  const StepParams p{nx, ny, nz, dx, h, dx2, inv_dx2, eps_scale, eps_floor,
                     p5_zero_y};
  const dim3 grid = lsf::brick_grid(nx, ny, nz);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  reinit_step_kernel<<<grid, dim3(BRICK, BRICK, BRICK), 0, st>>>(
      static_cast<const float*>(phi), static_cast<const float*>(sgn_src),
      static_cast<float*>(out), p, static_cast<const int*>(active),
      copy_inactive, static_cast<double*>(partials));
  return lsf::finish(grid, partials, dsq, st);
}
