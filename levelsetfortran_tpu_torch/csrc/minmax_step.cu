// Kernels K3 and K4: min/max curvature-flow Euler steps.
//
// K3 replaces levelsetfortran_tpu/ops/minmax_pallas.py:minmax_step_padded
// (body _make_kernel), its pack mode that function's `pack=B` (B
// geometries per launch, each with its own h1 and sum); K4 replaces
// minmax_fusedk_padded (body _make_fusedk_kernel).  One step, per cell:
//   sum6 = x- + x+ + y- + y+ + z+ + z-     (this order)
//   lap  = (sum6 - 6 c) / dx^2,  pave = (sum6 + c) / 7
//   F    = min(lap, 0) if pave < threshold else max(lap, 0)
//   c   += h1 F   where |c| < band_radius dx, on the interior only.
// Face rule: face cells never update and the +-1 reads of an interior cell
// never leave the grid, so neither the TPU kernel's edge clamp nor the jnp
// path's wrap is needed here: nothing outside the grid is ever read.
//
// K4 runs K <= 4 steps in one pass: a block loads its brick widened by K
// cells into shared memory and steps the window K times, the computed
// region shrinking by one cell per step, so every owned cell sees exactly
// the neighbours K single steps would give it.  Both kernels call the same
// minmax_update(), and the library is built with --fmad=false, so K4 is
// bitwise equal to K launches of K3.
//
// What bounds it on the H100: bytes.  K3 does ~15 float operations per
// cell against 8 bytes of device-memory traffic; K4 moves the same bytes
// for K steps (plus the (1 + 2K/8)^3 window re-read, through L2).  The
// narrow band skips whole inactive bricks: `active` holds one int32 per
// brick; an inactive brick copies its cells (copy_inactive, the mint step)
// or writes nothing (the ping-pong buffer already holds its values).  The
// update gate is the cell's own value, so a brick with no in-band cell can
// never change: the banded solve equals the dense one bitwise.
//
// Block mode of K3 (minmax_step_block_kernel, the TPU kernel's `offsets`
// argument): the tensor is one shard's block of a domain-decomposed grid
// with a halo of one neighbour cell on its sharded axes (the TPU's wider
// aprons are layout, not math).  The face rule and the fused sum's box are
// in global coordinates (origin + local index, all three axes); a cell
// updates only where its +-1 reads stay inside the array, which every owned
// cell's do; a frozen brick copies its cells.  Same minmax_update(), so a
// block's cells equal the solo kernel's on the whole grid bit for bit.
#include "common.cuh"

namespace {

using lsf::BRICK;
using lsf::NT;

struct MinmaxParams {
  int nx, ny, nz;
  float h1, inv_dx2, band_dx, threshold;
};

__device__ __forceinline__ bool updates(int i, int j, int k, float c,
                                        const MinmaxParams& p) {
  return i >= 1 && i <= p.nx - 2 && j >= 1 && j <= p.ny - 2 && k >= 1
         && k <= p.nz - 2 && fabsf(c) < p.band_dx;
}

__device__ __forceinline__ float minmax_update(float c, float xm, float xp,
                                               float ym, float yp, float zp,
                                               float zm,
                                               const MinmaxParams& p) {
  const float sum6 = ((((xm + xp) + ym) + yp) + zp) + zm;
  const float lap = (sum6 - 6.0f * c) * p.inv_dx2;
  const float pave = (sum6 + c) * (1.0f / 7.0f);
  const float f = pave < p.threshold ? fminf(lap, 0.0f) : fmaxf(lap, 0.0f);
  return c + p.h1 * f;
}

__global__ void __launch_bounds__(NT)
minmax_step_kernel(const float* __restrict__ phi, float* __restrict__ out,
                   MinmaxParams p, const int* __restrict__ active,
                   int copy_inactive, double* __restrict__ partials) {
  __shared__ double red[NT];
  const int k = blockIdx.x * BRICK + threadIdx.x;
  const int j = blockIdx.y * BRICK + threadIdx.y;
  const int i = blockIdx.z * BRICK + threadIdx.z;
  const long long brick = lsf::brick_id();
  const bool in_grid = i < p.nx && j < p.ny && k < p.nz;
  const long long sy = p.nz;
  const long long sx = (long long)p.ny * p.nz;
  const long long idx = i * sx + j * sy + k;
  if (active != nullptr && active[brick] == 0) {      // uniform per block
    if (copy_inactive && in_grid) out[idx] = phi[idx];
    if (partials != nullptr && lsf::thread_rank() == 0) partials[brick] = 0.0;
    return;
  }
  double dd = 0.0;
  if (in_grid) {
    const float c = phi[idx];
    float r = c;
    if (updates(i, j, k, c, p))
      r = minmax_update(c, phi[idx - sx], phi[idx + sx], phi[idx - sy],
                        phi[idx + sy], phi[idx + 1], phi[idx - 1], p);
    out[idx] = r;
    const float d = r - c;
    dd = (double)d * (double)d;
  }
  if (partials != nullptr) {
    const double total = lsf::block_sum(dd, red);
    if (lsf::thread_rank() == 0) partials[brick] = total;
  }
}

// Pack mode of K3 (replaces minmax_step_padded(pack=B)): B same-shape
// geometries stacked (B, nx, ny, nz) in one launch of grid (nbz, nby,
// B * nbx), geometry b = blockIdx.z / nbx in its own coordinates (64-bit
// offset b * nx * ny * nz) with its own h1 from the device vector h1s, its
// partials in the solo brick order, geometry-major.  A frozen geometry
// (live[b] == 0) copies its cells and writes zero partials.
__global__ void __launch_bounds__(NT)
minmax_step_packed_kernel(const float* __restrict__ phi,
                          float* __restrict__ out, MinmaxParams p,
                          const float* __restrict__ h1s,
                          const int* __restrict__ live,
                          double* __restrict__ partials) {
  __shared__ double red[NT];
  const int nbx = (p.nx + BRICK - 1) / BRICK;
  const int b = blockIdx.z / nbx;
  const int k = blockIdx.x * BRICK + threadIdx.x;
  const int j = blockIdx.y * BRICK + threadIdx.y;
  const int i = (blockIdx.z - b * nbx) * BRICK + threadIdx.z;
  const long long off = (long long)b * p.nx * p.ny * p.nz;
  phi += off;
  out += off;
  const bool in_grid = i < p.nx && j < p.ny && k < p.nz;
  const long long sy = p.nz;
  const long long sx = (long long)p.ny * p.nz;
  const long long idx = i * sx + j * sy + k;
  if (live[b] == 0) {                                 // uniform per block
    if (in_grid) out[idx] = phi[idx];
    if (partials != nullptr && lsf::thread_rank() == 0)
      partials[lsf::brick_id()] = 0.0;
    return;
  }
  double dd = 0.0;
  if (in_grid) {
    MinmaxParams q = p;
    q.h1 = h1s[b];
    const float c = phi[idx];
    float r = c;
    if (updates(i, j, k, c, q))
      r = minmax_update(c, phi[idx - sx], phi[idx + sx], phi[idx - sy],
                        phi[idx + sy], phi[idx + 1], phi[idx - 1], q);
    out[idx] = r;
    const float d = r - c;
    dd = (double)d * (double)d;
  }
  if (partials != nullptr) {
    const double total = lsf::block_sum(dd, red);
    if (lsf::thread_rank() == 0) partials[lsf::brick_id()] = total;
  }
}

// Block mode: p.nx/ny/nz are the PADDED array's dimensions; q places it in
// the global grid (common.cuh).
__global__ void __launch_bounds__(NT)
minmax_step_block_kernel(const float* __restrict__ phi,
                         float* __restrict__ out, MinmaxParams p,
                         lsf::BlockGeom q, const int* __restrict__ active,
                         double* __restrict__ partials) {
  __shared__ double red[NT];
  const int i = q.c[0] + (q.t0[0] + (int)blockIdx.z) * BRICK + threadIdx.z;
  const int j = q.c[1] + (q.t0[1] + (int)blockIdx.y) * BRICK + threadIdx.y;
  const int k = q.c[2] + (q.t0[2] + (int)blockIdx.x) * BRICK + threadIdx.x;
  const bool in_pad = i >= 0 && i < p.nx && j >= 0 && j < p.ny && k >= 0
                      && k < p.nz;
  double dd = 0.0;
  if (in_pad) {
    const long long sy = p.nz;
    const long long sx = (long long)p.ny * p.nz;
    const long long idx = i * sx + j * sy + k;
    const int gi = q.o[0] + i, gj = q.o[1] + j, gk = q.o[2] + k;
    const float c = phi[idx];
    float r = c;
    const bool steps = gi >= 1 && gi <= q.g[0] - 2 && gj >= 1
                       && gj <= q.g[1] - 2 && gk >= 1 && gk <= q.g[2] - 2
                       && i >= 1 && i <= p.nx - 2 && j >= 1 && j <= p.ny - 2
                       && k >= 1 && k <= p.nz - 2 && fabsf(c) < p.band_dx;
    if (steps && lsf::block_brick_active(active, q, i, j, k))
      r = minmax_update(c, phi[idx - sx], phi[idx + sx], phi[idx - sy],
                        phi[idx + sy], phi[idx + 1], phi[idx - 1], p);
    out[idx] = r;
    if (lsf::in_rms_box(q, gi, gj, gk)) {
      const float d = r - c;
      dd = (double)d * (double)d;
    }
  }
  if (partials != nullptr) {
    const double total = lsf::block_sum(dd, red);
    if (lsf::thread_rank() == 0) partials[lsf::brick_id()] = total;
  }
}

template <int K>
__global__ void __launch_bounds__(NT)
minmax_fusedk_kernel(const float* __restrict__ phi, float* __restrict__ out,
                     MinmaxParams p, const int* __restrict__ active,
                     int copy_inactive, double* __restrict__ partials) {
  constexpr int W = BRICK + 2 * K;        // window edge: brick +- K
  constexpr int W3 = W * W * W;
  __shared__ float buf[2][W3];
  __shared__ double red[NT];
  const int tid = lsf::thread_rank();
  const int x0 = blockIdx.z * BRICK;
  const int y0 = blockIdx.y * BRICK;
  const int z0 = blockIdx.x * BRICK;
  const long long brick = lsf::brick_id();
  if (active != nullptr && active[brick] == 0) {      // uniform per block
    const int i = x0 + threadIdx.z, j = y0 + threadIdx.y, k = z0 + threadIdx.x;
    if (copy_inactive && i < p.nx && j < p.ny && k < p.nz) {
      const long long idx = ((long long)i * p.ny + j) * p.nz + k;
      out[idx] = phi[idx];
    }
    if (partials != nullptr && tid == 0) partials[brick] = 0.0;
    return;
  }
  for (int q = tid; q < W3; q += NT) {
    const int gi = x0 - K + q / (W * W);
    const int gj = y0 - K + (q / W) % W;
    const int gk = z0 - K + q % W;
    const bool ing = gi >= 0 && gi < p.nx && gj >= 0 && gj < p.ny && gk >= 0
                     && gk < p.nz;
    buf[0][q] = ing ? phi[((long long)gi * p.ny + gj) * p.nz + gk] : 0.0f;
  }
  __syncthreads();
  int cur = 0;
  double dd = 0.0;
  for (int s = 0; s < K; ++s) {
    const int e = K - 1 - s;              // extension left after this step
    const int n = BRICK + 2 * e;
    const int lo = K - e;
    for (int q = tid; q < n * n * n; q += NT) {
      const int wx = lo + q / (n * n);
      const int wy = lo + (q / n) % n;
      const int wz = lo + q % n;
      const int w = (wx * W + wy) * W + wz;
      const int gi = x0 - K + wx, gj = y0 - K + wy, gk = z0 - K + wz;
      const float* b = buf[cur];
      const float c = b[w];
      float r = c;
      if (updates(gi, gj, gk, c, p))
        r = minmax_update(c, b[w - W * W], b[w + W * W], b[w - W], b[w + W],
                          b[w + 1], b[w - 1], p);
      buf[cur ^ 1][w] = r;
      if (s == K - 1 && gi < p.nx && gj < p.ny && gk < p.nz) {
        out[((long long)gi * p.ny + gj) * p.nz + gk] = r;   // owned cell
        const float d = r - c;
        dd = (double)d * (double)d;
      }
    }
    __syncthreads();
    cur ^= 1;
  }
  if (partials != nullptr) {
    const double total = lsf::block_sum(dd, red);
    if (tid == 0) partials[brick] = total;
  }
}

}  // namespace

extern "C" int lsf_minmax_step_f32(const void* phi, void* out, int nx,
                                   int ny, int nz, float h1, float inv_dx2,
                                   float band_dx, float threshold,
                                   const void* active, int copy_inactive,
                                   void* partials, void* dsq, void* stream) {
  const MinmaxParams p{nx, ny, nz, h1, inv_dx2, band_dx, threshold};
  const dim3 grid = lsf::brick_grid(nx, ny, nz);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  minmax_step_kernel<<<grid, dim3(BRICK, BRICK, BRICK), 0, st>>>(
      static_cast<const float*>(phi), static_cast<float*>(out), p,
      static_cast<const int*>(active), copy_inactive,
      static_cast<double*>(partials));
  return lsf::finish(grid, partials, dsq, st);
}

extern "C" int lsf_minmax_step_packed_f32(const void* phi, void* out,
                                          int batch, int nx, int ny, int nz,
                                          const void* h1s, float inv_dx2,
                                          float band_dx, float threshold,
                                          const void* live, void* partials,
                                          void* dsq, void* stream) {
  const MinmaxParams p{nx, ny, nz, 0.0f, inv_dx2, band_dx, threshold};
  dim3 grid = lsf::brick_grid(nx, ny, nz);
  grid.z *= batch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  minmax_step_packed_kernel<<<grid, dim3(BRICK, BRICK, BRICK), 0, st>>>(
      static_cast<const float*>(phi), static_cast<float*>(out), p,
      static_cast<const float*>(h1s), static_cast<const int*>(live),
      static_cast<double*>(partials));
  return lsf::finish(grid, partials, dsq, st, batch);
}

extern "C" int lsf_minmax_fusedk_f32(const void* phi, void* out, int nx,
                                     int ny, int nz, float h1, float inv_dx2,
                                     float band_dx, float threshold,
                                     int ksteps, const void* active,
                                     int copy_inactive, void* partials,
                                     void* dsq, void* stream) {
  const MinmaxParams p{nx, ny, nz, h1, inv_dx2, band_dx, threshold};
  const dim3 grid = lsf::brick_grid(nx, ny, nz);
  const dim3 block(BRICK, BRICK, BRICK);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* in = static_cast<const float*>(phi);
  float* o = static_cast<float*>(out);
  const int* act = static_cast<const int*>(active);
  double* part = static_cast<double*>(partials);
  switch (ksteps) {
    case 1: minmax_fusedk_kernel<1><<<grid, block, 0, st>>>(in, o, p, act, copy_inactive, part); break;
    case 2: minmax_fusedk_kernel<2><<<grid, block, 0, st>>>(in, o, p, act, copy_inactive, part); break;
    case 3: minmax_fusedk_kernel<3><<<grid, block, 0, st>>>(in, o, p, act, copy_inactive, part); break;
    case 4: minmax_fusedk_kernel<4><<<grid, block, 0, st>>>(in, o, p, act, copy_inactive, part); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return lsf::finish(grid, partials, dsq, st);
}

// geom: BLOCK_GEOM_INTS host ints (common.cuh); nx, ny, nz: the padded
// array's dimensions.
extern "C" int lsf_minmax_step_block_f32(const void* phi, void* out, int nx,
                                         int ny, int nz, const int* geom,
                                         float h1, float inv_dx2,
                                         float band_dx, float threshold,
                                         const void* active, void* partials,
                                         void* dsq, void* stream) {
  const MinmaxParams p{nx, ny, nz, h1, inv_dx2, band_dx, threshold};
  const lsf::BlockGeom q = lsf::block_geom(geom);
  const dim3 grid = lsf::block_launch_grid(geom);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  minmax_step_block_kernel<<<grid, dim3(BRICK, BRICK, BRICK), 0, st>>>(
      static_cast<const float*>(phi), static_cast<float*>(out), p, q,
      static_cast<const int*>(active), static_cast<double*>(partials));
  return lsf::finish(grid, partials, dsq, st);
}
