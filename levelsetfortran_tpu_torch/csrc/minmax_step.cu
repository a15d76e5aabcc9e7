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
// K4 runs K <= 4 steps in one pass.  Both kernels call the same
// minmax_update(), and the library is built with --fmad=false, so K4 is
// bitwise equal to K launches of K3, its fused sum (the last step's) too.
//
// What bounds it on the H100: bytes.  K3 does ~15 float operations per
// cell against 8 bytes of device-memory traffic; K4 moves the same 8 bytes
// for K steps.  The first port gave K4 one 8^3 brick per block widened by
// K on every side: 4,096 loads for 512 cells at K = 4, 5,984 updates (2.9x
// four K3 steps), a runtime divide per update and 36 KB of shared memory,
// so four fused steps took as long as four K3 launches.  The wavefront
// below widens a 16 x 32 column by K in y and z only and walks x once: at
// K = 4 it reads 1.9x the owned cells (through L2) and makes 1.4x the
// updates of four K3 steps, from per-thread cell indices fixed for the
// walk, with one barrier per plane.
//
// The narrow band skips whole inactive bricks: `active` holds one int32
// per brick; an inactive brick copies its cells (copy_inactive, the mint
// step) or writes nothing (the ping-pong buffer already holds its values),
// and writes a zero partial.  The update gate is the cell's own value, so a
// brick with no in-band cell can never change: the banded solve equals the
// dense one bitwise, and K4 skips the runs of slabs whose bricks are all
// frozen.
//
// Block mode of K3 (minmax_step_block_kernel, the TPU kernel's `offsets`
// argument): the tensor is one shard's block of a domain-decomposed grid
// with a halo of one neighbour cell on its sharded axes (the TPU's wider
// aprons are layout, not math).  The face rule and the fused sum's box are
// in global coordinates (origin + local index, all three axes); a cell
// updates only where its +-1 reads stay inside the array, which every owned
// cell's do; a frozen brick copies its cells.  Same minmax_update(), so a
// block's cells equal the solo kernel's on the whole grid bit for bit.
#include <algorithm>

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

// K4's wavefront.  A block owns a (FK_TY x FK_TZ) column of cells and a
// run of x-slabs (whole bricks); it walks x one plane per step.  Level 0 is
// phi; level s is level s-1 after one more step.  At step t the block loads
// level-0 plane t and computes level s at plane t - 2s (s = 1..K), whose
// three input planes t-2s-1 .. t-2s+1 of level s-1 were done by step t-1:
// one barrier per step, and a ring of 4 planes per level (the planes read
// and the one being written are 4 consecutive ones).  Each plane is the
// column widened by K cells in y and z; level s is computed on the column
// widened by K - s, so level K is the owned column, and in x a run reads K
// planes beyond each end (none past a face: a face plane never changes).
// The x-tree of lsf::block_sum (x-planes i with i+4, i+2, i+1) runs in each
// thread's registers over the 8 planes of a brick, the y- and z-trees in
// shared memory and shuffles once the brick's last plane is done, so the
// partial is the K3 launch's bitwise.
constexpr int FK_TY = 16, FK_TZ = 32, FK_NT = FK_TY * FK_TZ;

template <int K>
constexpr int fk_plane() { return (FK_TY + 2 * K) * (FK_TZ + 2 * K); }

template <int K>
constexpr size_t fk_smem() {
  return sizeof(float) * K * 4 * fk_plane<K>() + sizeof(double) * FK_NT;
}

// Whether x-slab bx of the block's column holds an active brick.
__device__ __forceinline__ bool slab_live(const int* __restrict__ active,
                                          int bx, int by0, int bz0, int nby,
                                          int nbz) {
  if (active == nullptr) return true;
  bool live = false;
  for (int b = 0; b < (FK_TY / BRICK) * (FK_TZ / BRICK); ++b) {
    const int by = by0 + b / (FK_TZ / BRICK), bz = bz0 + b % (FK_TZ / BRICK);
    if (by < nby && bz < nbz)
      live |= active[((long long)bx * nby + by) * nbz + bz] != 0;
  }
  return live;
}

template <int K>
__global__ void __launch_bounds__(FK_NT, 2)
minmax_fusedk_kernel(const float* __restrict__ phi, float* __restrict__ out,
                     MinmaxParams p, const int* __restrict__ active,
                     int copy_inactive, double* __restrict__ partials,
                     int chunk) {
  constexpr int EY = FK_TY + 2 * K, EZ = FK_TZ + 2 * K, P = EY * EZ;
  constexpr int NB = (FK_TY / BRICK) * (FK_TZ / BRICK);   // bricks per slab
  constexpr int NL = (P + FK_NT - 1) / FK_NT;     // level-0 cells a thread
  constexpr int NC = ((EY - 2) * (EZ - 2) + FK_NT - 1) / FK_NT;  // level >= 1
  constexpr int NS = K > 1 ? K - 1 : 1;
  extern __shared__ double fk_shared[];
  double* red = fk_shared;                                // FK_NT
  float* ring = reinterpret_cast<float*>(fk_shared + FK_NT);  // [K][4][P]
  const int tid = threadIdx.x;
  const int ty = tid / FK_TZ, tz = tid % FK_TZ;
  const int y0 = blockIdx.y * FK_TY, z0 = blockIdx.x * FK_TZ;
  const int nbx = (p.nx + BRICK - 1) / BRICK, nby = (p.ny + BRICK - 1) / BRICK;
  const int nbz = (p.nz + BRICK - 1) / BRICK;
  const int by0 = y0 / BRICK, bz0 = z0 / BRICK;
  const int bx0 = blockIdx.z * chunk, bx1 = min(bx0 + chunk, nbx);
  const long long sy = p.nz, sx = (long long)p.ny * p.nz;
  const int j = y0 + ty, k = z0 + tz;                     // owned column
  const bool col_in = j < p.ny && k < p.nz;

  // this thread's cells of each level, fixed for the whole walk: level 0
  // (the loads), levels 1 .. K-1 (the widened columns), level K (owned)
  long long goff[NL];
  bool gin[NL];
#pragma unroll
  for (int r = 0; r < NL; ++r) {
    const int q = tid + r * FK_NT;
    const int gj = y0 - K + q / EZ, gk = z0 - K + q % EZ;
    gin[r] = q < P && gj >= 0 && gj < p.ny && gk >= 0 && gk < p.nz;
    goff[r] = gj * sy + gk;
  }
  int lw[NS][NC];
  bool lin[NS][NC], lok[NS][NC];
#pragma unroll
  for (int s = 1; s < K; ++s) {
    const int rz = EZ - 2 * s, n = (EY - 2 * s) * rz;
#pragma unroll
    for (int r = 0; r < NC; ++r) {
      const int q = tid + r * FK_NT;
      const int wy = s + q / rz, wz = s + q % rz;
      const int gj = y0 - K + wy, gk = z0 - K + wz;
      lw[s - 1][r] = wy * EZ + wz;
      lin[s - 1][r] = q < n;
      lok[s - 1][r] = gj >= 1 && gj <= p.ny - 2 && gk >= 1 && gk <= p.nz - 2;
    }
  }
  const int ow = (K + ty) * EZ + K + tz;
  const bool own_ok = j >= 1 && j <= p.ny - 2 && k >= 1 && k <= p.nz - 2;
  const long long own_off = j * sy + k;

  // the chunk in runs of live slabs (a single dead slab between two live
  // ones joins the run: sweeping it costs 8 steps, a restart 3K); a dead
  // slab outside every run has only frozen bricks: copied under mint, zero
  // sums
  auto live = [&](int bx) {
    return slab_live(active, bx, by0, bz0, nby, nbz);
  };
  for (int first = bx0; first < bx1;) {
    if (!live(first)) {
      if (copy_inactive && col_in)
        for (int i = first * BRICK; i < min(first * BRICK + BRICK, p.nx); ++i)
          out[i * sx + own_off] = phi[i * sx + own_off];
      if (partials != nullptr && tid < NB) {
        const int by = by0 + tid / (FK_TZ / BRICK);
        const int bz = bz0 + tid % (FK_TZ / BRICK);
        if (by < nby && bz < nbz)
          partials[((long long)first * nby + by) * nbz + bz] = 0.0;
      }
      ++first;
      continue;
    }
    int last = first;
    while (last + 1 < bx1
           && (live(last + 1) || (last + 2 < bx1 && live(last + 2))))
      ++last;
    const int xs = first * BRICK, xe = min((last + 1) * BRICK, p.nx);
    const int xr = max(xs - K, 0);             // first plane loaded
    const int xl = min(xe + K, p.nx);          // end of the planes loaded
    float dq[BRICK];                           // last-step changes, this brick
#pragma unroll
    for (int m = 0; m < BRICK; ++m) dq[m] = 0.0f;

    for (int t = xr; t <= xe - 1 + 2 * K; ++t) {
      // level 0, plane t: loaded now, stored after this step's compute
      float v[NL];
      const bool load = t < xl;
#pragma unroll
      for (int r = 0; r < NL; ++r)
        v[r] = load && gin[r] ? __ldg(phi + t * sx + goff[r]) : 0.0f;
      // levels 1 .. K-1 into their rings
#pragma unroll
      for (int s = 1; s < K; ++s) {
        const int pl = t - 2 * s;
        const int lo = xr == 0 ? 0 : xr + s;
        const int hi = xl == p.nx ? p.nx - 1 : xl - 1 - s;
        if (pl < lo || pl > hi) continue;      // uniform over the block
        const bool iok = pl >= 1 && pl <= p.nx - 2;
        const float* src = ring + (s - 1) * 4 * P;
        const float* bm = src + ((pl + 3) & 3) * P;
        const float* b0 = src + (pl & 3) * P;
        const float* bp = src + ((pl + 1) & 3) * P;
        float* dst = ring + s * 4 * P + (pl & 3) * P;
#pragma unroll
        for (int r = 0; r < NC; ++r) {
          if (!lin[s - 1][r]) continue;
          const int w = lw[s - 1][r];
          const float c = b0[w];
          float u = c;
          if (iok && lok[s - 1][r] && fabsf(c) < p.band_dx)
            u = minmax_update(c, bm[w], bp[w], b0[w - EZ], b0[w + EZ],
                              b0[w + 1], b0[w - 1], p);
          dst[w] = u;
        }
      }
      // level K at plane t - 2K: the owned column's cells
      const int pl = t - 2 * K;
      if (pl >= xs && pl < xe) {
        const float* src = ring + (K - 1) * 4 * P;
        const float* b0 = src + (pl & 3) * P;
        const float c = b0[ow];
        float r = c;
        if (pl >= 1 && pl <= p.nx - 2 && own_ok && fabsf(c) < p.band_dx)
          r = minmax_update(c, src[((pl + 3) & 3) * P + ow],
                            src[((pl + 1) & 3) * P + ow], b0[ow - EZ],
                            b0[ow + EZ], b0[ow + 1], b0[ow - 1], p);
        const int bx = pl / BRICK;
        const bool act = active == nullptr
            || (col_in && active[((long long)bx * nby + j / BRICK) * nbz
                                 + k / BRICK] != 0);
        if (col_in) {
          const long long idx = pl * sx + own_off;
          if (act) out[idx] = r;
          else if (copy_inactive) out[idx] = phi[idx];
        }
        const float d = col_in ? r - c : 0.0f;
#pragma unroll
        for (int m = 0; m < BRICK; ++m)
          if ((pl & (BRICK - 1)) == m) dq[m] = d;
        if (partials != nullptr
            && ((pl & (BRICK - 1)) == BRICK - 1 || pl == xe - 1)) {
          // the brick's last plane: its 512 changes in block_sum's tree
          double dd[BRICK];
#pragma unroll
          for (int m = 0; m < BRICK; ++m)
            dd[m] = (double)dq[m] * (double)dq[m];
          red[tid] = ((dd[0] + dd[4]) + (dd[2] + dd[6]))
                     + ((dd[1] + dd[5]) + (dd[3] + dd[7]));
          __syncthreads();
          if (tid < NB * BRICK) {
            const int b = tid / BRICK, zi = tid % BRICK;
            const int ly = (b / (FK_TZ / BRICK)) * BRICK;
            const int lz = (b % (FK_TZ / BRICK)) * BRICK + zi;
            double u[BRICK];
#pragma unroll
            for (int yi = 0; yi < BRICK; ++yi)
              u[yi] = red[(ly + yi) * FK_TZ + lz];
            double a = ((u[0] + u[4]) + (u[2] + u[6]))
                       + ((u[1] + u[5]) + (u[3] + u[7]));
            a += __shfl_down_sync(0xffffffffu, a, 4);
            a += __shfl_down_sync(0xffffffffu, a, 2);
            a += __shfl_down_sync(0xffffffffu, a, 1);
            const int by = by0 + b / (FK_TZ / BRICK);
            const int bz = bz0 + b % (FK_TZ / BRICK);
            if (zi == 0 && by < nby && bz < nbz) {
              const long long brick = ((long long)bx * nby + by) * nbz + bz;
              partials[brick] =
                  active == nullptr || active[brick] != 0 ? a : 0.0;
            }
          }
        }
        if ((pl & (BRICK - 1)) == BRICK - 1) {
#pragma unroll
          for (int m = 0; m < BRICK; ++m) dq[m] = 0.0f;
        }
      }
      if (load) {
        float* dst = ring + (t & 3) * P;
#pragma unroll
        for (int r = 0; r < NL; ++r)
          if (tid + r * FK_NT < P) dst[tid + r * FK_NT] = v[r];
      }
      __syncthreads();
    }
    first = last + 1;
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

namespace {

template <int K>
int launch_fusedk(const float* in, float* o, const MinmaxParams& p,
                  const int* act, int copy_inactive, double* part,
                  cudaStream_t st) {
  constexpr size_t smem = fk_smem<K>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      minmax_fusedk_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  // x-slabs per block: the count that minimises waves x steps a block
  // walks (8 per slab and 3K more for a run's ends), the waves counted over
  // the card's resident blocks
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, minmax_fusedk_kernel<K>, FK_NT, smem);
  const long long slots = std::max(1LL, (long long)sms * per_sm);
  const int nbx = (p.nx + BRICK - 1) / BRICK;
  const long long cols = (long long)((p.nz + FK_TZ - 1) / FK_TZ)
                         * ((p.ny + FK_TY - 1) / FK_TY);
  int chunk = nbx;
  long long best = -1;
  for (int c = 1; c <= nbx; ++c) {
    const long long waves = ((nbx + c - 1) / c * cols + slots - 1) / slots;
    const long long cost = waves * (BRICK * c + 3 * K);
    if (best < 0 || cost < best) {
      best = cost;
      chunk = c;
    }
  }
  const dim3 grid((p.nz + FK_TZ - 1) / FK_TZ, (p.ny + FK_TY - 1) / FK_TY,
                  (nbx + chunk - 1) / chunk);
  minmax_fusedk_kernel<K><<<grid, FK_NT, smem, st>>>(in, o, p, act,
                                                     copy_inactive, part,
                                                     chunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lsf_minmax_fusedk_f32(const void* phi, void* out, int nx,
                                     int ny, int nz, float h1, float inv_dx2,
                                     float band_dx, float threshold,
                                     int ksteps, const void* active,
                                     int copy_inactive, void* partials,
                                     void* dsq, void* stream) {
  const MinmaxParams p{nx, ny, nz, h1, inv_dx2, band_dx, threshold};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* in = static_cast<const float*>(phi);
  float* o = static_cast<float*>(out);
  const int* act = static_cast<const int*>(active);
  double* part = static_cast<double*>(partials);
  int e;
  switch (ksteps) {
    case 1: e = launch_fusedk<1>(in, o, p, act, copy_inactive, part, st); break;
    case 2: e = launch_fusedk<2>(in, o, p, act, copy_inactive, part, st); break;
    case 3: e = launch_fusedk<3>(in, o, p, act, copy_inactive, part, st); break;
    case 4: e = launch_fusedk<4>(in, o, p, act, copy_inactive, part, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != 0) return e;
  return lsf::finish(lsf::brick_grid(nx, ny, nz), partials, dsq, st);
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
