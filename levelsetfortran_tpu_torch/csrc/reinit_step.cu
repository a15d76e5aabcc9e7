// Kernel K1: one Jacobi reinitialization step, phi_t = sgn(phi_0)(1 - |grad phi|).
//
// Replaces levelsetfortran_tpu/ops/weno_pallas.py:_pallas_step_padded (body:
// _make_kernel, _tile_step_values, _tile_axis_gsq, _weno5_pair,
// _godunov_axis, _tile_tail).  Same math, cell for cell (the per-axis WENO5
// and Godunov selection live in weno5.cuh, shared with the adjoint K5):
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
//
// Pack mode (reinit_step_packed_kernel, the TPU kernel's `pack` argument):
// B geometries per launch, each with its own h and sum; not the TPU's
// x-concatenated layout but a leading batch dimension on the launch grid.
//
// Block mode (reinit_step_block_kernel, the TPU kernel's `offsets`,
// `rms_bounds` and `tile_range` + `out_init` arguments): the tensor is one
// shard's block of a domain-decomposed grid, padded with a halo of
// neighbour cells on its sharded axes.  Every mask (deep, interior, face
// clamp) is taken at origin + local index in GLOBAL coordinates on all
// three axes; every in-grid cell of the padded extent whose stencil stays
// inside the array is updated (so k steps on a halo of 3k cells leave the
// owned cells exact), the others are left as they are; the fused sum counts
// only the cells inside the global box `rms` (the owned range); the brick
// grid and the `active` mask are anchored where the caller says (on the
// owned block, whose origin lies a halo width into the array); and a launch
// may cover a sub-box of the brick grid, writing into an output that other
// launches fill (the exchange/compute overlap).  A cell's arithmetic is
// cell_update_at(), the solo kernel's, so a block's cells equal the solo
// kernel's on the whole grid bit for bit.
#include "common.cuh"
#include "weno5.cuh"

namespace {

using lsf::BRICK;
using lsf::NT;

struct StepParams {
  int nx, ny, nz;
  float dx, h, dx2, inv_dx2, eps_scale, eps_floor;   // eps_floor: dx^2-scaled
  int p5_zero_y;
};

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
    const float d[6] = {vm2 - vm3, vm1 - vm2, c - vm1,
                        vp1 - c, vp2 - vp1, vp3 - vp2};
    lsf::Weno5 w;
    lsf::weno5(d, p.eps_scale, p.eps_floor, p5_zero, w);
    dm = w.dm;
    dp = w.dp;
  } else {
    dm = c - __ldg(phi + s - st);
    dp = __ldg(phi + s + st) - c;
  }
  const float g = lsf::godunov(dm, dp, pos);
  return g * g;
}

// The Euler-updated value of the interior cell at linear offset s of an
// array with strides (sx, sy, 1); `deep`: the cell is 4 or more cells from
// every face of the GLOBAL grid (WENO5), else first-order differences.
__device__ float cell_update_at(const float* __restrict__ phi,
                                const float* __restrict__ sgn_src,
                                long long s, long long sx, long long sy,
                                bool deep, const StepParams& p) {
  const float c = __ldg(phi + s);
  const float src = __ldg(sgn_src + s);
  const bool pos = src > 0.0f;
  float sum = axis_gsq(phi, s, sx, c, deep, pos, p, false);
  sum = sum + axis_gsq(phi, s, sy, c, deep, pos, p, p.p5_zero_y != 0);
  sum = sum + axis_gsq(phi, s, 1, c, deep, pos, p, false);
  const float gm = sqrtf(sum * p.inv_dx2);
  const float d2 = src * src + p.dx2 * gm;
  const float sg = src / sqrtf(fmaxf(d2, 1e-20f));
  return c + (p.h * sg) * (1.0f - gm);
}

// The Euler-updated value of interior cell (i, j, k) of a whole grid.
__device__ __forceinline__ float cell_update(
    const float* __restrict__ phi, const float* __restrict__ sgn_src, int i,
    int j, int k, const StepParams& p) {
  const long long sx = (long long)p.ny * p.nz;
  const long long sy = p.nz;
  const bool deep = i >= 4 && i <= p.nx - 5 && j >= 4 && j <= p.ny - 5
                    && k >= 4 && k <= p.nz - 5;
  return cell_update_at(phi, sgn_src, i * sx + j * sy + k, sx, sy, deep, p);
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

// Pack mode: B same-shape geometries stacked (B, nx, ny, nz), one launch.
// The launch grid is (nbz, nby, B * nbx); geometry b = blockIdx.z / nbx
// owns the blocks of its solo grid, in the solo order, so brick_id() is
// b * bricks + its solo id and the partials come out geometry-major.
// Every index, face test and clamp is in the geometry's own coordinates
// (64-bit offset b * nx * ny * nz), and each live geometry steps with its
// own h, read from the device vector hs: a live geometry's cells are a solo
// launch's cells bit for bit.  A frozen geometry (live[b] == 0) is a pure
// passthrough, faces included, with a zero partial: the solver's ping-pong
// buffer then holds its field in both halves.  (This is not the banded
// mode above, which still takes the ghost BC on frozen bricks' faces.)
// Three blocks per SM: left to itself ptxas gives this kernel 51 registers
// (two blocks of 512 threads per SM), the solo kernel 40; bounded, it takes
// 40 and a 24-byte stack, and its outputs are unchanged.
__global__ void __launch_bounds__(NT, 3)
reinit_step_packed_kernel(const float* __restrict__ phi,
                          const float* __restrict__ sgn_src,
                          float* __restrict__ out, StepParams p,
                          const float* __restrict__ hs,
                          const int* __restrict__ live,
                          double* __restrict__ partials) {
  __shared__ double red[NT];
  const int nbx = (p.nx + BRICK - 1) / BRICK;
  const int b = blockIdx.z / nbx;
  const int x0 = (blockIdx.z - b * nbx) * BRICK, y0 = blockIdx.y * BRICK;
  const int z0 = blockIdx.x * BRICK;
  const int i = x0 + threadIdx.z, j = y0 + threadIdx.y, k = z0 + threadIdx.x;
  const long long off = (long long)b * p.nx * p.ny * p.nz;
  phi += off;
  sgn_src += off;
  out += off;
  const bool in_grid = i < p.nx && j < p.ny && k < p.nz;
  const long long idx = ((long long)i * p.ny + j) * p.nz + k;
  if (live[b] == 0) {                                 // uniform per block
    if (in_grid) out[idx] = phi[idx];
    if (partials != nullptr && lsf::thread_rank() == 0)
      partials[lsf::brick_id()] = 0.0;
    return;
  }
  double dd = 0.0;
  if (in_grid) {
    StepParams q = p;
    q.h = hs[b];
    const int si = clamp_inner(i, p.nx);
    const int sj = clamp_inner(j, p.ny);
    const int sk = clamp_inner(k, p.nz);
    const bool face = si != i || sj != j || sk != k;
    const float v = cell_update(phi, sgn_src, si, sj, sk, q);
    const float res = face ? v + p.dx : v;
    out[idx] = res;
    const float d = res - phi[idx];
    dd = (double)d * (double)d;
  }
  if (partials != nullptr) {
    const double total = lsf::block_sum(dd, red);
    if (lsf::thread_rank() == 0) partials[lsf::brick_id()] = total;
  }
}

// Block mode: one shard's padded block (see the header).  p.nx/ny/nz are the
// PADDED array's dimensions; q places it in the global grid.
__global__ void __launch_bounds__(NT)
reinit_step_block_kernel(const float* __restrict__ phi,
                         const float* __restrict__ sgn_src,
                         float* __restrict__ out, StepParams p,
                         lsf::BlockGeom q, const int* __restrict__ active,
                         double* __restrict__ partials) {
  __shared__ double red[NT];
  const int i = q.c[0] + (q.t0[0] + (int)blockIdx.z) * BRICK + threadIdx.z;
  const int j = q.c[1] + (q.t0[1] + (int)blockIdx.y) * BRICK + threadIdx.y;
  const int k = q.c[2] + (q.t0[2] + (int)blockIdx.x) * BRICK + threadIdx.x;
  const int gi = q.o[0] + i, gj = q.o[1] + j, gk = q.o[2] + k;
  const bool in_grid = i >= 0 && i < p.nx && j >= 0 && j < p.ny && k >= 0
                       && k < p.nz && gi >= 0 && gi < q.g[0] && gj >= 0
                       && gj < q.g[1] && gk >= 0 && gk < q.g[2];
  double dd = 0.0;
  if (in_grid) {
    const long long sx = (long long)p.ny * p.nz;
    const long long sy = p.nz;
    const long long idx = i * sx + j * sy + k;
    const int gsi = clamp_inner(gi, q.g[0]);
    const int gsj = clamp_inner(gj, q.g[1]);
    const int gsk = clamp_inner(gk, q.g[2]);
    const int si = gsi - q.o[0], sj = gsj - q.o[1], sk = gsk - q.o[2];
    const bool face = gsi != gi || gsj != gj || gsk != gk;
    if (face || lsf::block_brick_active(active, q, i, j, k)) {
      // the cell whose update this thread evaluates is (si, sj, sk): itself,
      // or a global-face cell's clamped inner neighbour (in the same shard)
      const bool deep = gsi >= 4 && gsi <= q.g[0] - 5 && gsj >= 4
                        && gsj <= q.g[1] - 5 && gsk >= 4
                        && gsk <= q.g[2] - 5;
      const int r = deep ? 3 : 1;
      const bool valid = si >= r && si + r < p.nx && sj >= r
                         && sj + r < p.ny && sk >= r && sk + r < p.nz;
      if (valid) {
        const long long s = si * sx + sj * sy + sk;
        const float v = lsf::block_brick_active(active, q, si, sj, sk)
            ? cell_update_at(phi, sgn_src, s, sx, sy, deep, p) : phi[s];
        const float res = face ? v + p.dx : v;
        out[idx] = res;
        if (lsf::in_rms_box(q, gi, gj, gk)) {
          const float d = res - phi[idx];
          dd = (double)d * (double)d;
        }
      }
    } else {
      out[idx] = phi[idx];       // a frozen brick copies: the buffer written
    }                            // holds stale halos, not the last iterate
  }
  if (partials != nullptr) {
    const double total = lsf::block_sum(dd, red);
    if (lsf::thread_rank() == 0) partials[lsf::brick_id()] = total;
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

extern "C" int lsf_reinit_step_packed_f32(const void* phi,
                                          const void* sgn_src, void* out,
                                          int batch, int nx, int ny, int nz,
                                          float dx, const void* hs, float dx2,
                                          float inv_dx2, float eps_scale,
                                          float eps_floor, int p5_zero_y,
                                          const void* live, void* partials,
                                          void* dsq, void* stream) {
  const StepParams p{nx, ny, nz, dx, 0.0f, dx2, inv_dx2, eps_scale,
                     eps_floor, p5_zero_y};
  dim3 grid = lsf::brick_grid(nx, ny, nz);
  grid.z *= batch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  reinit_step_packed_kernel<<<grid, dim3(BRICK, BRICK, BRICK), 0, st>>>(
      static_cast<const float*>(phi), static_cast<const float*>(sgn_src),
      static_cast<float*>(out), p, static_cast<const float*>(hs),
      static_cast<const int*>(live), static_cast<double*>(partials));
  return lsf::finish(grid, partials, dsq, st, batch);
}

// geom: BLOCK_GEOM_INTS host ints (common.cuh: BlockGeom and the launch's
// brick counts); nx, ny, nz: the padded array's dimensions.
extern "C" int lsf_reinit_step_block_f32(const void* phi, const void* sgn_src,
                                         void* out, int nx, int ny, int nz,
                                         const int* geom, float dx, float h,
                                         float dx2, float inv_dx2,
                                         float eps_scale, float eps_floor,
                                         int p5_zero_y, const void* active,
                                         void* partials, void* dsq,
                                         void* stream) {
  const StepParams p{nx, ny, nz, dx, h, dx2, inv_dx2, eps_scale, eps_floor,
                     p5_zero_y};
  const lsf::BlockGeom q = lsf::block_geom(geom);
  const dim3 grid = lsf::block_launch_grid(geom);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  reinit_step_block_kernel<<<grid, dim3(BRICK, BRICK, BRICK), 0, st>>>(
      static_cast<const float*>(phi), static_cast<const float*>(sgn_src),
      static_cast<float*>(out), p, q, static_cast<const int*>(active),
      static_cast<double*>(partials));
  return lsf::finish(grid, partials, dsq, st);
}
