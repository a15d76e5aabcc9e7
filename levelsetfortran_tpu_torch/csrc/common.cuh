// Shared pieces of the stencil kernels: the brick geometry, the march
// layout of K3 and K6 and the deterministic two-pass reduction of the
// fused sums.
//
// The kernels work on BRICK^3 bricks of the unpadded (nx, ny, nz) grid (z
// fastest): one thread block per brick, one thread per cell (K1, K5), or a
// column of bricks walked along x (K3, K4, K6).  The narrow-band activity
// mask is one int32 per brick, laid out (nbx, nby, nbz).  A packed batch of
// B geometries multiplies the launch grid's x-brick axis by B.
//
// The sum of squared cell changes decides when a solve stops, so it must
// not change from run to run, nor may the adjoints' scalar sums: each
// brick's partial sum (a fixed tree in block_sum's pairing) goes to its own
// slot, and the slots are added in a fixed order — by one more launch
// (reduce_partials), or by the launch's last block to finish (march_last,
// ordered_sums).  No floating-point atomics.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

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

// ---------------------------------------------------------------------
// The streaming schedule of K3 and K6 (the march).  A block owns a column
// of TY x MARCH_TZ cells (TY / BRICK x MARCH_TZ / BRICK bricks, one warp
// per 32-cell z row: 128-byte rows) and a chunk of x-slabs of the launch's
// brick box, and walks x one plane at a time, reading its planes from a
// shared ring with a y/z rim.  All in the BlockGeom frame: a solo grid is
// the whole-grid record (solo_geom), a packed batch B solo records.
constexpr int MARCH_TZ = 32;

// How a launch is cut (host-built): the launch's brick counts (x, y, z),
// x-slabs per block, and blocks along x per group (a packed geometry).
struct MarchLaunch {
  int tn[3];
  int chunk, nchunk;
};

// Lets `kernel` take `smem` bytes of dynamic shared memory (above the 48 KB
// default) on the current device.  The attribute is held per device, so
// `done` (one per kernel) keeps a bit for each device already set; a
// device past the 64th is set at every launch.
inline cudaError_t allow_dynamic_smem(const void* kernel, size_t smem,
                                      std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit != 0ull && (done.load(std::memory_order_acquire) & bit) != 0ull)
    return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

// Blocks of the card that can be resident at once for `kernel` (the
// occupancy query cached per kernel and device: a launch pays for it once).
inline long long march_slots(const void* kernel, int threads, size_t smem) {
  static const void* keys[16];
  static int devs[16];
  static long long vals[16];
  static int used = 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  for (int n = 0; n < used; ++n)
    if (keys[n] == kernel && devs[n] == dev) return vals[n];
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  const long long slots = per_sm * (long long)sms > 0
                              ? per_sm * (long long)sms : 1;
  if (used < 16) {
    keys[used] = kernel;
    devs[used] = dev;
    vals[used++] = slots;
  }
  return slots;
}

// The launch's cut: x-slabs per block minimising waves x steps a block
// walks (BRICK per slab and `warm` more per block), the waves counted over
// `slots` resident blocks, `groups` geometries side by side.
inline MarchLaunch march_launch(const int* tn, int ty, int groups,
                                long long slots, int warm) {
  MarchLaunch L{{tn[0], tn[1], tn[2]}, 1, 1};
  const int by = ty / BRICK, bz = MARCH_TZ / BRICK;
  const long long cols = (long long)((tn[2] + bz - 1) / bz)
                         * ((tn[1] + by - 1) / by) * groups;
  long long best = -1;
  for (int c = 1; c <= tn[0]; ++c) {
    const long long waves = ((tn[0] + c - 1) / c * cols + slots - 1) / slots;
    const long long cost = waves * (BRICK * c + warm);
    if (best < 0 || cost < best) {
      best = cost;
      L.chunk = c;
    }
  }
  L.nchunk = (tn[0] + L.chunk - 1) / L.chunk;
  return L;
}

inline dim3 march_grid(const MarchLaunch& L, int ty, int groups) {
  const int by = ty / BRICK, bz = MARCH_TZ / BRICK;
  return dim3((L.tn[2] + bz - 1) / bz, (L.tn[1] + by - 1) / by,
              groups * L.nchunk);
}

// block_sum's x-tree over one thread's BRICK values of a brick column
// (x-planes i with i+4, i+2, i+1).
__device__ __forceinline__ double x_tree(const double (&d)[BRICK]) {
  return ((d[0] + d[4]) + (d[2] + d[6])) + ((d[1] + d[5]) + (d[3] + d[7]));
}

// One slab's per-brick partials of NS sums, in block_sum's tree: each
// thread's x-tree sums xt[s] (x_tree of the value of each x-plane of the
// brick, 0 for a cell the sum does not count), then per brick the y-tree
// through shared memory and the z-tree through shuffles (one group of
// warps per sum), so each partial is a brick-per-block launch's bitwise.
// part[s]: sum s's partials; bxl: the slab in the launch box; (byl0, bzl0):
// the block's first brick.  Every thread of the block calls it; red (NS x
// TY x MARCH_TZ doubles) must be free: the caller has passed a
// __syncthreads since its last readers.
template <int TY, int NS>
__device__ __forceinline__ void march_brick_partials(
    const double (&xt)[NS], double* red, double* const (&part)[NS],
    int bxl, const MarchLaunch& L, int byl0, int bzl0) {
  constexpr int BZ = MARCH_TZ / BRICK, NB = (TY / BRICK) * BZ;
  constexpr int NT = TY * MARCH_TZ;
  const int tid = threadIdx.x;
#pragma unroll
  for (int s = 0; s < NS; ++s) red[s * NT + tid] = xt[s];
  __syncthreads();
  if (tid < NS * NB * BRICK) {        // whole warps
    const int s = tid / (NB * BRICK), r = tid % (NB * BRICK);
    const int b = r / BRICK, zi = r % BRICK;
    const int ly = (b / BZ) * BRICK, lz = (b % BZ) * BRICK + zi;
    double u[BRICK];
#pragma unroll
    for (int yi = 0; yi < BRICK; ++yi)
      u[yi] = red[s * NT + (ly + yi) * MARCH_TZ + lz];
    double a = ((u[0] + u[4]) + (u[2] + u[6])) + ((u[1] + u[5]) + (u[3] + u[7]));
    a += __shfl_down_sync(0xffffffffu, a, 4);
    a += __shfl_down_sync(0xffffffffu, a, 2);
    a += __shfl_down_sync(0xffffffffu, a, 1);
    const int byl = byl0 + b / BZ, bzl = bzl0 + b % BZ;
    if (zi == 0 && byl < L.tn[1] && bzl < L.tn[2])
      part[s][((long long)bxl * L.tn[1] + byl) * L.tn[2] + bzl] = a;
  }
}

// The fused sum's partials of one slab: dq, the squared change of each
// x-plane of the brick (0 for a cell the sum does not count).
template <int TY>
__device__ __forceinline__ void march_partials(const float (&dq)[BRICK],
                                               double* red, double* part,
                                               int bxl, const MarchLaunch& L,
                                               int byl0, int bzl0) {
  double dd[BRICK];
#pragma unroll
  for (int m = 0; m < BRICK; ++m) dd[m] = (double)dq[m] * (double)dq[m];
  const double xt[1] = {x_tree(dd)};
  double* const parts[1] = {part};
  __syncthreads();                    // red's last readers are done
  march_brick_partials<TY, 1>(xt, red, parts, bxl, L, byl0, bzl0);
}

// A slab whose bricks all write a zero partial (frozen, or outside the
// array); every thread may call it.
template <int TY>
__device__ __forceinline__ void march_zero_partials(double* part, int bxl,
                                                    const MarchLaunch& L,
                                                    int byl0, int bzl0) {
  constexpr int BZ = MARCH_TZ / BRICK, NB = (TY / BRICK) * BZ;
  const int tid = threadIdx.x;
  if (tid < NB) {
    const int byl = byl0 + tid / BZ, bzl = bzl0 + tid % BZ;
    if (byl < L.tn[1] && bzl < L.tn[2])
      part[((long long)bxl * L.tn[1] + byl) * L.tn[2] + bzl] = 0.0;
  }
}

// 0.0 + part[t] + part[t + 1024] + ... (below n), added in that order, the
// loads issued eight at a time (the last fewer than eight too); L2: through
// the L2 cache (partials that other blocks of the same launch wrote).
template <bool L2>
__device__ __forceinline__ double strided_sum(const double* part, long long t,
                                              long long n) {
  double acc = 0.0;
  long long q = t;
  for (; q + 7 * 1024 < n; q += 8 * 1024) {
    double v[8];
#pragma unroll
    for (int m = 0; m < 8; ++m)
      v[m] = L2 ? __ldcg(part + q + m * 1024) : part[q + m * 1024];
#pragma unroll
    for (int m = 0; m < 8; ++m) acc += v[m];
  }
  double v[8];
#pragma unroll
  for (int m = 0; m < 8; ++m)
    v[m] = q + m * 1024 >= n ? 0.0
           : L2 ? __ldcg(part + q + m * 1024) : part[q + m * 1024];
#pragma unroll
  for (int m = 0; m < 8; ++m)
    if (q + m * 1024 < n) acc += v[m];
  return acc;
}

// The second pass of a sum folded into the launch: each block of a group
// takes an integer ticket after its partials are fenced (march_last), and
// the group's last block adds each run of n partials in reduce_partials's
// order (ordered_sums: 1024 running sums, the q-th from q in steps of 1024,
// then the same tree), then returns the ticket counter to 0 for the next
// launch.  No float atomics: each sum has the bits of a reduce_partials
// launch.  Every thread of the block calls them; red: 1024 doubles of
// shared memory.
__device__ __forceinline__ bool march_last(unsigned* ticket,
                                           unsigned blocks) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == blocks - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// NS sums side by side, the s-th of the n partials at part + s n, in every
// thread (the last block only); red: NS x 1024 doubles.
template <int NS>
__device__ __forceinline__ void ordered_sums(const double* part, long long n,
                                             double* red, double (&out)[NS]) {
  __syncthreads();                    // red's last readers are done
  for (int t = threadIdx.x; t < 1024; t += blockDim.x)
#pragma unroll
    for (int s = 0; s < NS; ++s)
      red[s * 1024 + t] = strided_sum<true>(part + s * n, t, n);
  __syncthreads();
  for (int w = 512; w > 0; w >>= 1) {
    for (int t = threadIdx.x; t < w; t += blockDim.x)
#pragma unroll
      for (int s = 0; s < NS; ++s) red[s * 1024 + t] += red[s * 1024 + t + w];
    __syncthreads();
  }
#pragma unroll
  for (int s = 0; s < NS; ++s) out[s] = red[s * 1024];
}

// K3's fused sum into *out.
__device__ __forceinline__ void march_finish(const double* part, long long n,
                                             double* out, unsigned* ticket,
                                             unsigned blocks, double* red) {
  if (!march_last(ticket, blocks)) return;
  double s[1];
  ordered_sums<1>(part, n, red, s);
  if (threadIdx.x == 0) {
    *out = s[0];
    *ticket = 0u;
  }
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
  s[threadIdx.x] = strided_sum<false>(partials, threadIdx.x, n);
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
