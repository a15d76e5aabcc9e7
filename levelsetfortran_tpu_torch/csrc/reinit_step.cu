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
// each tile.  Here a face cell's thread evaluates its inner neighbour's
// update itself, so every thread evaluates exactly one stencil and no
// block depends on another — in banded mode too, where the neighbour's
// brick may be frozen.
//
// What bounds it on the H100: the schedulers' issue rate.  A cell costs
// ~450 float operations, 13 of them IEEE divisions, and 2 square roots,
// against 12 bytes of unique device-memory traffic (phi and the sign
// source in, phi out); under --fmad=false each division is a sequence of
// instructions with a slow path, and the kernel issues ~1000 instructions
// per cell, so it runs at its issue rate, far above the float bound.  One
// 8^3 brick per block, one thread per cell (40 registers, three blocks of
// 512 threads per SM), its 19 neighbour reads through L1.  A march along
// x (a register queue of x-neighbours, the y/z neighbours from a shared
// plane fed by asynchronous copies, one barrier per plane) was built and
// measured slower in every variant: it holds 64-90 registers, halving the
// warps that hide the division chains.  What the brick schedule sheds is
// host and tail work: one kernel for every mode (the BlockGeom frame, a
// whole-grid record folding its masks away at compile time), the brick's
// partial in block_sum's pairing with one barrier (the rest in one warp's
// shuffles), and a second pass that issues its loads eight at a time.
// The arithmetic (cell_update_from, axis_gsq, weno5.cuh: the statements
// K5 differentiates) is the first port's, statement for statement.
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
// Pack mode (the TPU kernel's `pack` argument): B geometries per launch,
// each with its own h and sum; not the TPU's x-concatenated layout but a
// leading batch dimension, geometry b on the launch grid's x-bricks b *
// nbx .., its partials in the solo brick order, geometry-major.
//
// Block mode (the TPU kernel's `offsets`,
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
// cell_update_from(), the solo kernel's, so a block's cells equal the solo
// kernel's on the whole grid bit for bit.
#include "common.cuh"
#include "weno5.cuh"

namespace {

using lsf::BRICK;

struct StepParams {
  int nx, ny, nz;
  float dx, h, dx2, inv_dx2, eps_scale, eps_floor;   // eps_floor: dx^2-scaled
  int p5_zero_y;
};

// One axis's squared derivative at an interior cell: c is the cell's value,
// at(o) its neighbour o = -3..3 cells along the axis (from device memory or
// from registers and shared memory: the statements are the same).
template <class At>
__device__ __forceinline__ float axis_gsq(At at, float c, bool deep,
                                          bool pos, const StepParams& p,
                                          bool p5_zero) {
  float dm, dp;
  if (deep) {
    const float vm3 = at(-3);
    const float vm2 = at(-2);
    const float vm1 = at(-1);
    const float vp1 = at(1);
    const float vp2 = at(2);
    const float vp3 = at(3);
    const float d[6] = {vm2 - vm3, vm1 - vm2, c - vm1,
                        vp1 - c, vp2 - vp1, vp3 - vp2};
    lsf::Weno5 w;
    lsf::weno5(d, p.eps_scale, p.eps_floor, p5_zero, w);
    dm = w.dm;
    dp = w.dp;
  } else {
    dm = c - at(-1);
    dp = at(1) - c;
  }
  const float g = lsf::godunov(dm, dp, pos);
  return g * g;
}

// The Euler-updated value of an interior cell of value c and sign source
// src, with neighbours ax, ay, az along x, y, z (see axis_gsq); `deep`: the
// cell is 4 or more cells from every face of the GLOBAL grid (WENO5), else
// first-order differences.
template <class AX, class AY, class AZ>
__device__ __forceinline__ float cell_update_from(float c, float src, AX ax,
                                                  AY ay, AZ az, bool deep,
                                                  const StepParams& p) {
  const bool pos = src > 0.0f;
  float sum = axis_gsq(ax, c, deep, pos, p, false);
  sum = sum + axis_gsq(ay, c, deep, pos, p, p.p5_zero_y != 0);
  sum = sum + axis_gsq(az, c, deep, pos, p, false);
  const float gm = sqrtf(sum * p.inv_dx2);
  const float d2 = src * src + p.dx2 * gm;
  const float sg = src / sqrtf(fmaxf(d2, 1e-20f));
  return c + (p.h * sg) * (1.0f - gm);
}

// The same at linear offset s of an array with strides (sx, sy, 1), read
// from device memory.
__device__ float cell_update_at(const float* __restrict__ phi,
                                const float* __restrict__ sgn_src, int s,
                                int sx, int sy, bool deep,
                                const StepParams& p) {
  const float c = __ldg(phi + s);
  const float src = __ldg(sgn_src + s);
  return cell_update_from(
      c, src, [&](int o) { return __ldg(phi + s + o * sx); },
      [&](int o) { return __ldg(phi + s + o * sy); },
      [&](int o) { return __ldg(phi + s + o); }, deep, p);
}

__device__ __forceinline__ int clamp_inner(int i, int n) {
  return i == 0 ? 1 : (i == n - 1 ? n - 2 : i);
}

// K1's kernel (every mode: dense, banded, pack, block): one 8^3 brick of
// one geometry per block, one thread per cell, in the BlockGeom frame
// (common.cuh).  Per cell, in the frame of q (global coordinates):
//   * a face cell evaluates its clamped inner neighbour (x, then y, then z
//     clamp), any other cell itself where its brick is active; the
//     evaluation is the update where that cell's brick is active, else its
//     value, and is written (plus dx on a face) where the stencil (radius
//     3 where deep, else 1) stays in the array;
//   * a frozen brick's other cells are copied (copy_inactive; block mode
//     always) or left alone, and a frozen brick with no face cell and no
//     copy reads nothing;
//   * the fused sum counts the written cells in q's rms box, in block_sum's
//     tree with one barrier (the x-tree and the first y step through
//     shared memory, the rest in one warp's shuffles); reduce_partials
//     adds the partials (a second launch: a ticket taken by each of the
//     launch's many blocks would fence every block's end).
// A frozen geometry of a pack copies its cells, faces included.  SOLO: q
// is a whole-grid record (dense, banded and pack modes), whose masks fold
// away at compile time.
template <bool SOLO>
__global__ void __launch_bounds__(lsf::NT, 3)
reinit_brick_kernel(const float* __restrict__ phi,
                    const float* __restrict__ sgn_src,
                    float* __restrict__ out, StepParams p, lsf::BlockGeom q,
                    int tnx, const float* __restrict__ hs,
                    const int* __restrict__ live,
                    const int* __restrict__ active, int copy_inactive,
                    double* __restrict__ partials) {
  __shared__ double red[lsf::NT];
  const int tid = threadIdx.x;
  const int xi = tid / (BRICK * BRICK), yi = (tid / BRICK) % BRICK;
  const int zi = tid % BRICK;
  const int grp = blockIdx.z / tnx;
  const int bxl = blockIdx.z - grp * tnx;
  const int sx = p.ny * p.nz, sy = p.nz;      // a geometry has < 2^31 cells
  phi += (long long)grp * sx * p.nx;
  sgn_src += (long long)grp * sx * p.nx;
  out += (long long)grp * sx * p.nx;
  const long long nbr = (long long)tnx * gridDim.y * gridDim.x;
  double* part = partials == nullptr ? nullptr : partials + grp * nbr;
  const bool glive = live == nullptr || live[grp] != 0;
  StepParams pp = p;
  if (hs != nullptr) pp.h = hs[grp];
  // the frame: a whole-grid record's offsets are 0 and its grid the array
  const int o0 = SOLO ? 0 : q.o[0], o1 = SOLO ? 0 : q.o[1];
  const int o2 = SOLO ? 0 : q.o[2];
  const int g0 = SOLO ? p.nx : q.g[0], g1 = SOLO ? p.ny : q.g[1];
  const int g2 = SOLO ? p.nz : q.g[2];
  // the brick's first cell (array coordinates) and this thread's cell
  const int x0 = SOLO ? bxl * BRICK : q.c[0] + (q.t0[0] + bxl) * BRICK;
  const int y0 = SOLO ? (int)blockIdx.y * BRICK
                      : q.c[1] + (q.t0[1] + (int)blockIdx.y) * BRICK;
  const int z0 = SOLO ? (int)blockIdx.x * BRICK
                      : q.c[2] + (q.t0[2] + (int)blockIdx.x) * BRICK;
  const int i = x0 + xi, j = y0 + yi, k = z0 + zi;
  const int gi = o0 + i, gj = o1 + j, gk = o2 + k;
  const bool in_grid = SOLO ? i < p.nx && j < p.ny && k < p.nz
      : i >= 0 && i < p.nx && j >= 0 && j < p.ny && k >= 0 && k < p.nz
        && gi >= 0 && gi < g0 && gj >= 0 && gj < g1 && gk >= 0 && gk < g2;
  const int idx = i * sx + j * sy + k;
  const bool brick_live = lsf::block_brick_active(active, q, x0, y0, z0);
  const int gsi = clamp_inner(gi, g0), gsj = clamp_inner(gj, g1);
  const int gsk = clamp_inner(gk, g2);
  const bool face = gsi != gi || gsj != gj || gsk != gk;
  // uniform per block: a frozen brick with no face cell and no copy
  const bool idle = !brick_live && !copy_inactive && glive
                    && !__syncthreads_or(in_grid && face);
  double dd = 0.0;
  if (!glive) {
    if (in_grid) out[idx] = phi[idx];
  } else if (!idle && in_grid) {
    if (face || brick_live) {
      // the cell evaluated: itself, or a face cell's clamped inner
      // neighbour
      const int si = gsi - o0, sj = gsj - o1, sk = gsk - o2;
      const bool deep = gsi >= 4 && gsi <= g0 - 5 && gsj >= 4
                        && gsj <= g1 - 5 && gsk >= 4 && gsk <= g2 - 5;
      const int r = deep ? 3 : 1;
      const bool valid = SOLO || (si >= r && si + r < p.nx && sj >= r
                                  && sj + r < p.ny && sk >= r
                                  && sk + r < p.nz);
      if (valid) {
        const int s = si * sx + sj * sy + sk;
        const float v = lsf::block_brick_active(active, q, si, sj, sk)
            ? cell_update_at(phi, sgn_src, s, sx, sy, deep, pp) : phi[s];
        const float res = face ? v + pp.dx : v;
        out[idx] = res;
        if (SOLO || lsf::in_rms_box(q, gi, gj, gk)) {
          const float d = res - phi[idx];
          dd = (double)d * (double)d;
        }
      }
    } else if (copy_inactive) {
      out[idx] = phi[idx];
    }
  }
  if (part != nullptr) {
    // block_sum's tree: x-planes (rank + 256, + 128, + 64), y-rows (+ 32:
    // across warps, then + 16, + 8) and z (+ 4, + 2, + 1)
    red[tid] = dd;
    __syncthreads();
    if (tid < 32) {
      double a[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const double* v = red + tid + 32 * h;
        a[h] = ((v[0] + v[256]) + (v[128] + v[384]))
               + ((v[64] + v[320]) + (v[192] + v[448]));
      }
      double sum = a[0] + a[1];
      sum += __shfl_down_sync(0xffffffffu, sum, 16);
      sum += __shfl_down_sync(0xffffffffu, sum, 8);
      sum += __shfl_down_sync(0xffffffffu, sum, 4);
      sum += __shfl_down_sync(0xffffffffu, sum, 2);
      sum += __shfl_down_sync(0xffffffffu, sum, 1);
      if (tid == 0)
        part[((long long)bxl * gridDim.y + blockIdx.y) * gridDim.x
             + blockIdx.x] = sum;
    }
  }
}

}  // namespace

namespace {

// One K1 launch over `batch` geometries laid out by the host record geom,
// then the sums' second pass.
int launch_reinit(const void* phi, const void* sgn_src, void* out, int batch,
                  const StepParams& p, const int* geom, const void* hs,
                  const void* live, const void* active, int copy_inactive,
                  void* partials, void* dsq, void* stream) {
  const lsf::BlockGeom q = lsf::block_geom(geom);
  const int* tn = geom + 21;
  const dim3 grid(tn[2], tn[1], batch * tn[0]);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool solo = q.o[0] == 0 && q.o[1] == 0 && q.o[2] == 0
                    && q.c[0] == 0 && q.c[1] == 0 && q.c[2] == 0
                    && q.t0[0] == 0 && q.t0[1] == 0 && q.t0[2] == 0
                    && q.g[0] == p.nx && q.g[1] == p.ny && q.g[2] == p.nz
                    && q.rms[0] == 0 && q.rms[1] == p.nx && q.rms[2] == 0
                    && q.rms[3] == p.ny && q.rms[4] == 0 && q.rms[5] == p.nz;
  auto* kernel = solo ? reinit_brick_kernel<true> : reinit_brick_kernel<false>;
  kernel<<<grid, lsf::NT, 0, st>>>(
      static_cast<const float*>(phi), static_cast<const float*>(sgn_src),
      static_cast<float*>(out), p, q, tn[0], static_cast<const float*>(hs),
      static_cast<const int*>(live), static_cast<const int*>(active),
      copy_inactive, static_cast<double*>(partials));
  return lsf::finish(grid, partials, dsq, st, batch);
}

}  // namespace

extern "C" int lsf_reinit_step_f32(const void* phi, const void* sgn_src,
                                   void* out, int nx, int ny, int nz,
                                   float dx, float h, float dx2,
                                   float inv_dx2, float eps_scale,
                                   float eps_floor, int p5_zero_y,
                                   const void* active, int copy_inactive,
                                   void* partials, void* dsq, void* stream) {
  int geom[lsf::BLOCK_GEOM_INTS];
  lsf::solo_geom(nx, ny, nz, geom);
  return launch_reinit(
      phi, sgn_src, out, 1,
      StepParams{nx, ny, nz, dx, h, dx2, inv_dx2, eps_scale, eps_floor,
                 p5_zero_y},
      geom, nullptr, nullptr, active, copy_inactive, partials, dsq, stream);
}

extern "C" int lsf_reinit_step_packed_f32(const void* phi,
                                          const void* sgn_src, void* out,
                                          int batch, int nx, int ny, int nz,
                                          float dx, const void* hs, float dx2,
                                          float inv_dx2, float eps_scale,
                                          float eps_floor, int p5_zero_y,
                                          const void* live, void* partials,
                                          void* dsq, void* stream) {
  int geom[lsf::BLOCK_GEOM_INTS];
  lsf::solo_geom(nx, ny, nz, geom);
  return launch_reinit(
      phi, sgn_src, out, batch,
      StepParams{nx, ny, nz, dx, 0.0f, dx2, inv_dx2, eps_scale, eps_floor,
                 p5_zero_y},
      geom, hs, live, nullptr, 0, partials, dsq, stream);
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
  return launch_reinit(
      phi, sgn_src, out, 1,
      StepParams{nx, ny, nz, dx, h, dx2, inv_dx2, eps_scale, eps_floor,
                 p5_zero_y},
      geom, nullptr, nullptr, active, 1, partials, dsq, stream);
}
