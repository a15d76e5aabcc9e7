// Shared pieces of the stencil kernels: the brick geometry and the
// deterministic two-pass reduction of the fused convergence sum.
//
// Every kernel runs one thread block per BRICK^3 brick of the unpadded
// (nx, ny, nz) grid (z fastest), one thread per cell.  The narrow-band
// activity mask is one int32 per brick, laid out (nbx, nby, nbz).
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

inline dim3 brick_grid(int nx, int ny, int nz) {
  return dim3((nz + BRICK - 1) / BRICK, (ny + BRICK - 1) / BRICK,
              (nx + BRICK - 1) / BRICK);
}

namespace {

// Second pass: one block adds the per-brick partials in a fixed order.
__global__ void reduce_partials(const double* __restrict__ partials,
                                long long n, double* __restrict__ out) {
  __shared__ double s[1024];
  double acc = 0.0;
  for (long long q = threadIdx.x; q < n; q += blockDim.x) acc += partials[q];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int w = blockDim.x / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = s[0];
}

// Launch the second pass when the caller asked for the sum.
inline int finish(dim3 grid, void* partials, void* dsq, cudaStream_t st) {
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (partials != nullptr) {
    const long long nb = (long long)grid.x * grid.y * grid.z;
    reduce_partials<<<1, 1024, 0, st>>>(
        static_cast<const double*>(partials), nb, static_cast<double*>(dsq));
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace lsf
