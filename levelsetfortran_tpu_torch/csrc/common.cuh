// Shared pieces of the stencil kernels: the brick geometry and the
// deterministic two-pass reduction of the fused convergence sum.
//
// Every kernel runs one thread block per BRICK^3 brick of the unpadded
// (nx, ny, nz) grid (z fastest), one thread per cell.  The narrow-band
// activity mask is one int32 per brick, laid out (nbx, nby, nbz).  A packed
// batch of B geometries multiplies the launch grid's x-brick axis by B.
//
// The sum of squared cell changes decides when a solve stops, so it must
// not change from run to run: each block writes its partial sum (a fixed
// shared-memory tree) to its own slot, and one more block adds the slots
// in a fixed order.  No floating-point atomics.
#pragma once

#include <cuda_runtime.h>

namespace lsf {

constexpr int BRICK = 8;
constexpr int NT = BRICK * BRICK * BRICK;   // threads per block

__device__ __forceinline__ int thread_rank() {
  return (threadIdx.z * BRICK + threadIdx.y) * BRICK + threadIdx.x;
}

// Linear brick id in the (nbx, nby, nbz) mask layout; the launch grid is
// (nbz, nby, nbx) so that blockIdx.x walks z.
__device__ __forceinline__ long long brick_id() {
  return ((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x
         + blockIdx.x;
}

// Sum of one value per thread of the block (every thread must call it);
// the fixed tree makes the result independent of scheduling.
__device__ __forceinline__ double block_sum(double v, double* s) {
  const int tid = thread_rank();
  s[tid] = v;
  __syncthreads();
  for (int w = NT / 2; w > 0; w >>= 1) {
    if (tid < w) s[tid] += s[tid + w];
    __syncthreads();
  }
  return s[0];
}

// Where one shard's padded block lies in a domain-decomposed grid, and how
// its brick grid is laid (the block modes of K1 and K3).  All per axis
// (x, y, z):
//   g   the global grid's dimensions;
//   o   the global index of the array's cell 0 (negative where the halo
//       reaches past a global face: such cells are never read or written);
//   c   the array index of brick (0, 0, 0)'s first cell (<= 0 where the
//       grid is anchored on the owned block, a halo width into the array);
//   nb  the brick grid's dimensions (the layout of `active`);
//   t0  the first brick of this launch (the launch grid holds its counts);
//   rms the global half-open box [x0, x1) x [y0, y1) x [z0, z1) whose cells
//       the fused sum counts.
struct BlockGeom {
  int g[3], o[3], c[3], nb[3], t0[3], rms[6];
};

// The host-side record behind it: BlockGeom's ints in this order, then the
// launch's brick counts (x, y, z).
constexpr int BLOCK_GEOM_INTS = 24;

inline BlockGeom block_geom(const int* v) {
  BlockGeom q;
  for (int a = 0; a < 3; ++a) {
    q.g[a] = v[a];
    q.o[a] = v[3 + a];
    q.c[a] = v[6 + a];
    q.nb[a] = v[9 + a];
    q.t0[a] = v[12 + a];
  }
  for (int a = 0; a < 6; ++a) q.rms[a] = v[15 + a];
  return q;
}

inline dim3 block_launch_grid(const int* v) {
  return dim3(v[23], v[22], v[21]);          // blockIdx.x walks z
}

// The record of a solo grid as a block: the array is the whole grid, the
// brick grid starts at its cell 0 and the owned box is the whole grid.
inline void solo_geom(int nx, int ny, int nz, int* v) {
  const int n[3] = {nx, ny, nz};
  for (int a = 0; a < 3; ++a) {
    const int nb = (n[a] + BRICK - 1) / BRICK;
    v[a] = n[a];
    v[3 + a] = v[6 + a] = v[12 + a] = 0;
    v[9 + a] = v[21 + a] = nb;
    v[15 + 2 * a] = 0;
    v[16 + 2 * a] = n[a];
  }
}

// Whether the brick holding array cell (i, j, k) steps (no mask: all do).
__device__ __forceinline__ bool block_brick_active(
    const int* __restrict__ active, const BlockGeom& q, int i, int j, int k) {
  if (active == nullptr) return true;
  return active[((long long)((i - q.c[0]) / BRICK) * q.nb[1]
                 + (j - q.c[1]) / BRICK) * q.nb[2] + (k - q.c[2]) / BRICK]
         != 0;
}

__device__ __forceinline__ bool in_rms_box(const BlockGeom& q, int gi, int gj,
                                           int gk) {
  return gi >= q.rms[0] && gi < q.rms[1] && gj >= q.rms[2] && gj < q.rms[3]
         && gk >= q.rms[4] && gk < q.rms[5];
}

inline dim3 brick_grid(int nx, int ny, int nz) {
  return dim3((nz + BRICK - 1) / BRICK, (ny + BRICK - 1) / BRICK,
              (nx + BRICK - 1) / BRICK);
}

namespace {

// Second pass: block g adds the g-th run of n per-brick partials in a fixed
// order into out[g].  One block for a solo grid; one per geometry for a
// packed batch, whose partials are laid out geometry-major, each run in
// the solo brick order, so each geometry's sum has a solo launch's bits.
__global__ void reduce_partials(const double* __restrict__ partials,
                                long long n, double* __restrict__ out) {
  __shared__ double s[1024];
  partials += blockIdx.x * n;
  double acc = 0.0;
  for (long long q = threadIdx.x; q < n; q += blockDim.x) acc += partials[q];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int w = blockDim.x / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = s[0];
}

// Launch the second pass when the caller asked for the sum; `groups`
// geometries share the launch grid equally.
inline int finish(dim3 grid, void* partials, void* dsq, cudaStream_t st,
                  int groups = 1) {
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (partials != nullptr) {
    const long long nb = (long long)grid.x * grid.y * grid.z / groups;
    reduce_partials<<<groups, 1024, 0, st>>>(
        static_cast<const double*>(partials), nb, static_cast<double*>(dsq));
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace lsf
