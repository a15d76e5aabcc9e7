// K8: the surface-node advection.  No Pallas counterpart: it replaces the
// loop that the JAX package compiles into one device program,
// levelsetfortran_tpu/solvers/advect.py:advect_nodes (:46, jax.jit around
// a lax.fori_loop; reference set3d.f90:470-501).
//
// phi and its banded gradient are frozen during the advection, so each
// node's path depends on its own position only: one thread per node runs
// every iteration (trilinear sample of phi and of the three gradient
// channels, the unit inward direction, the move where phi > eps) and the
// final sample.
//
// Bound: neither bytes nor operations (~125 float operations per node and
// iteration, 8 + 24 gathered floats that stay in L1/L2): a node's
// iterations form one dependent chain of gathers, so the kernel is bound
// by latency; one launch for all iterations takes the host out of it.
//
// Arithmetic: every expression of the plain loop (solvers/advect.py, with
// ops/interp.py:trilinear and sample_surface) in its order, built with
// --fmad=false; world_to_index divides by dx as PyTorch divides a CUDA
// tensor by a Python number, multiplying by the reciprocal of dx taken in
// double and rounded to float32 (the wrapper passes it).  So the positions
// and phi_surf are bitwise the plain loop's on the card.
//
// Block mode (the sharded advection, parallel/sharded.py): phi stays cut
// into the blocks of a shard mesh, each block's phi and masked gradient
// interleaved in one 4-channel field with a halo of one cell on the
// sharded axes.  A node's sample is computed by the block that owns its
// base cell i0 (the blocks partition the grid, so there is one owner);
// the plain loop adds the owner's sample to the other shards' zeros, which
// is the owner's sample with a -0.0 turned into +0.0.  A table of blocks
// (one row per block, ROW int64 each) tells the kernels where each block's
// field lies and which base cells it owns:
//  * advect_sample_kernel: every node's sample from the table's block that
//    owns it, zeros where none does (with one row: one shard's sample);
//  * advect_run_kernel: every iteration of every node while a block of the
//    table holds its base cell, on node states (position, iteration, final
//    phi) that the caller hands from card to card when no block of this
//    card does.  A block holds the cells whose 2x2x2 corners lie in its
//    padded field: the cells it owns and, below its low faces, the cells
//    whose corners its halo holds, copies of the owner's values, so the
//    sample is bitwise the owner's and a node that wanders across a seam
//    and back stays on one card.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ADV_THREADS = 128;

struct GridArgs {
  float o[3];          // the origin, rounded to float32
  float inv_dx;        // float32(1 / dx), the quotient taken in double
  float hi[3];         // shape - 1
  int max_idx[3];      // shape - 2
  long long sy, sx;    // strides of y and x in cells (nz, ny * nz)
};

// torch.clamp_min and torch.minimum: NaN stays NaN
__device__ __forceinline__ float clamp_lo(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

struct Cell {
  long long base;      // flat index of the cell's (i0, j0, k0) corner
  float tx, ty, tz;
};

__device__ __forceinline__ Cell locate(const GridArgs& g, float x0, float x1,
                                       float x2) {
  const float x[3] = {x0, x1, x2};
  long long i[3];
  float t[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float f = minimum(clamp_lo((x[a] - g.o[a]) * g.inv_dx, 0.0f),
                            g.hi[a]);
    long long fi = (long long)floorf(f);
    fi = fi < 0 ? 0 : fi;
    fi = fi < g.max_idx[a] ? fi : g.max_idx[a];
    i[a] = fi;
    t[a] = f - (float)fi;
  }
  return Cell{i[0] * g.sx + i[1] * g.sy + i[2], t[0], t[1], t[2]};
}

// trilinear's blend of the 8 corners of `c` in `field` (channel `ch` of
// `nch` interleaved channels)
__device__ __forceinline__ float blend(const float* __restrict__ field,
                                      const GridArgs& g, const Cell& c,
                                      int nch, int ch) {
  auto at = [&](int di, int dj, int dk) {
    return __ldg(field + (c.base + di * g.sx + dj * g.sy + dk) * nch + ch);
  };
  const float ux = 1.0f - c.tx, uy = 1.0f - c.ty, uz = 1.0f - c.tz;
  const float c00 = at(0, 0, 0) * ux + at(1, 0, 0) * c.tx;
  const float c10 = at(0, 1, 0) * ux + at(1, 1, 0) * c.tx;
  const float c01 = at(0, 0, 1) * ux + at(1, 0, 1) * c.tx;
  const float c11 = at(0, 1, 1) * ux + at(1, 1, 1) * c.tx;
  const float c0 = c00 * uy + c10 * c.ty;
  const float c1 = c01 * uy + c11 * c.ty;
  return c0 * uz + c1 * c.tz;
}

__global__ void __launch_bounds__(ADV_THREADS)
advect_kernel(const float* __restrict__ phi, const float* __restrict__ grad,
              const float* __restrict__ pos, float* __restrict__ out_pos,
              float* __restrict__ out_phi, int n, int iters, GridArgs g,
              float eps, float mag_eps, float mag_floor) {
  const long long node = (long long)blockIdx.x * ADV_THREADS + threadIdx.x;
  if (node >= n) return;
  float x0 = pos[node * 3], x1 = pos[node * 3 + 1], x2 = pos[node * 3 + 2];
  for (int it = 0; it < iters; ++it) {
    const Cell c = locate(g, x0, x1, x2);
    const float p = blend(phi, g, c, 1, 0);
    const float g0 = -blend(grad, g, c, 3, 0);
    const float g1 = -blend(grad, g, c, 3, 1);
    const float g2 = -blend(grad, g, c, 3, 2);
    const float mag2 = (g0 * g0 + g1 * g1) + g2 * g2;
    float e0 = 0.0f, e1 = 0.0f, e2 = 0.0f;
    if (!(mag2 < mag_eps)) {
      const float s = sqrtf(clamp_lo(mag2, mag_floor));
      e0 = g0 / s;
      e1 = g1 / s;
      e2 = g2 / s;
    }
    const float m = (p > eps ? 1.0f : 0.0f) * p;
    x0 = x0 + m * e0;
    x1 = x1 + m * e1;
    x2 = x2 + m * e2;
  }
  out_pos[node * 3] = x0;
  out_pos[node * 3 + 1] = x1;
  out_pos[node * 3 + 2] = x2;
  out_phi[node] = blend(phi, g, locate(g, x0, x1, x2), 1, 0);
}

// ------------------------------ block mode ------------------------------

// A table row: the field's address, its strides in cells (x, y), the owned
// base cells [lo, end) in global indices, the shift from a global index to
// the padded field's (halo width - block offset) and the padded shape - 2.
constexpr int ROW = 15;
constexpr int NODE_STATE = 5;   // x, y, z, iterations done, final phi

// locate's clamps and floor, the base cell kept as three indices
__device__ __forceinline__ void locate_cell(const GridArgs& g, float x0,
                                            float x1, float x2, int i[3],
                                            float t[3]) {
  const float x[3] = {x0, x1, x2};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float f = minimum(clamp_lo((x[a] - g.o[a]) * g.inv_dx, 0.0f),
                            g.hi[a]);
    long long fi = (long long)floorf(f);
    fi = fi < 0 ? 0 : fi;
    fi = fi < g.max_idx[a] ? fi : g.max_idx[a];
    i[a] = (int)fi;
    t[a] = f - (float)fi;
  }
}

// the first row of the table whose block owns base cell i (reach: whose
// padded field holds the cell and its +1 corners, the owner's values
// copied into the halo), or -1
__device__ __forceinline__ int find_row(const long long* __restrict__ table,
                                        int nb, const int i[3], bool reach) {
  for (int b = 0; b < nb; ++b) {
    const long long* r = table + (long long)b * ROW;
    bool in = true;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      if (reach) {
        const long long li = (long long)i[a] + __ldg(r + 9 + a);
        in = in && li >= 0 && li <= __ldg(r + 12 + a);
      } else {
        in = in && i[a] >= __ldg(r + 3 + a) && i[a] < __ldg(r + 6 + a);
      }
    }
    if (in) return b;
  }
  return -1;
}

// trilinear's blend of channel `ch` of a 4-channel block at padded base
// cell `base` (blend's arithmetic, the block's strides)
__device__ __forceinline__ float blend4(const float* __restrict__ f,
                                       long long sx, long long sy,
                                       long long base, const float t[3],
                                       int ch) {
  auto at = [&](int di, int dj, int dk) {
    return __ldg(f + (base + di * sx + dj * sy + dk) * 4 + ch);
  };
  const float ux = 1.0f - t[0], uy = 1.0f - t[1], uz = 1.0f - t[2];
  const float c00 = at(0, 0, 0) * ux + at(1, 0, 0) * t[0];
  const float c10 = at(0, 1, 0) * ux + at(1, 1, 0) * t[0];
  const float c01 = at(0, 0, 1) * ux + at(1, 0, 1) * t[0];
  const float c11 = at(0, 1, 1) * ux + at(1, 1, 1) * t[0];
  const float c0 = c00 * uy + c10 * t[1];
  const float c1 = c01 * uy + c11 * t[1];
  return c0 * uz + c1 * t[2];
}

// the sample (phi, grad) of row r's block at global base cell i: the index
// shifted into the padded block and clamped as the plain loop clamps it
__device__ __forceinline__ void sample_row(const long long* __restrict__ r,
                                           const int i[3], const float t[3],
                                           float s[4]) {
  const float* f = reinterpret_cast<const float*>(__ldg(r));
  const long long sx = __ldg(r + 1), sy = __ldg(r + 2);
  long long li[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    long long v = (long long)i[a] + __ldg(r + 9 + a);
    v = v < 0 ? 0 : v;
    const long long top = __ldg(r + 12 + a);
    li[a] = v < top ? v : top;
  }
  const long long base = li[0] * sx + li[1] * sy + li[2];
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) s[ch] = blend4(f, sx, sy, base, t, ch);
}

__global__ void __launch_bounds__(ADV_THREADS)
advect_sample_kernel(const long long* __restrict__ table, int nb,
                     const float* __restrict__ pos, float* __restrict__ out,
                     int n, GridArgs g) {
  const long long node = (long long)blockIdx.x * ADV_THREADS + threadIdx.x;
  if (node >= n) return;
  int i[3];
  float t[3];
  locate_cell(g, pos[node * 3], pos[node * 3 + 1], pos[node * 3 + 2], i, t);
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const int b = find_row(table, nb, i, false);
  if (b >= 0) sample_row(table + (long long)b * ROW, i, t, s);
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) out[node * 4 + ch] = s[ch];
}

__global__ void __launch_bounds__(ADV_THREADS)
advect_run_kernel(const long long* __restrict__ table, int nb,
                  float* __restrict__ state, int n, int iters, GridArgs g,
                  float eps, float mag_eps, float mag_floor, int zero_sign) {
  const long long node = (long long)blockIdx.x * ADV_THREADS + threadIdx.x;
  if (node >= n) return;
  float* st = state + node * NODE_STATE;
  int k = (int)st[3];
  if (k > iters) return;
  float x0 = st[0], x1 = st[1], x2 = st[2], ps = st[4];
  bool touched = false;
  for (;;) {
    int i[3];
    float t[3];
    locate_cell(g, x0, x1, x2, i, t);
    const int b = find_row(table, nb, i, true);
    if (b < 0) break;                  // no block of this card holds it
    float s[4];
    sample_row(table + (long long)b * ROW, i, t, s);
    if (zero_sign) {                   // + the other shards' zeros
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) s[ch] = __fadd_rn(s[ch], 0.0f);
    }
    touched = true;
    if (k == iters) {                  // the final sample
      ps = s[0];
      k = iters + 1;
      break;
    }
    const float p = s[0];
    const float g0 = -s[1], g1 = -s[2], g2 = -s[3];
    const float mag2 = (g0 * g0 + g1 * g1) + g2 * g2;
    float e0 = 0.0f, e1 = 0.0f, e2 = 0.0f;
    if (!(mag2 < mag_eps)) {
      const float q = sqrtf(clamp_lo(mag2, mag_floor));
      e0 = g0 / q;
      e1 = g1 / q;
      e2 = g2 / q;
    }
    const float m = (p > eps ? 1.0f : 0.0f) * p;
    x0 = x0 + m * e0;
    x1 = x1 + m * e1;
    x2 = x2 + m * e2;
    ++k;
  }
  if (!touched) return;
  st[0] = x0;
  st[1] = x1;
  st[2] = x2;
  st[3] = (float)k;
  st[4] = ps;
}

GridArgs global_grid(int nx, int ny, int nz, float o0, float o1, float o2,
                     float inv_dx) {
  GridArgs g;
  g.o[0] = o0;
  g.o[1] = o1;
  g.o[2] = o2;
  g.inv_dx = inv_dx;
  const int shape[3] = {nx, ny, nz};
  for (int a = 0; a < 3; ++a) {
    g.hi[a] = (float)(shape[a] - 1);
    g.max_idx[a] = shape[a] - 2;
  }
  g.sy = nz;
  g.sx = (long long)ny * nz;
  return g;
}

}  // namespace

// phi (nx, ny, nz) and grad (nx, ny, nz, 3) float32 contiguous, pos
// (n, 3): out_pos (n, 3) and out_phi (n).
extern "C" int lsf_advect_nodes_f32(const void* phi, const void* grad,
                                    const void* pos, void* out_pos,
                                    void* out_phi, int n, int nx, int ny,
                                    int nz, float o0, float o1, float o2,
                                    float inv_dx, int iters, float eps,
                                    float mag_eps, float mag_floor,
                                    void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  GridArgs g;
  g.o[0] = o0;
  g.o[1] = o1;
  g.o[2] = o2;
  g.inv_dx = inv_dx;
  const int shape[3] = {nx, ny, nz};
  for (int a = 0; a < 3; ++a) {
    g.hi[a] = (float)(shape[a] - 1);
    g.max_idx[a] = shape[a] - 2;
  }
  g.sy = nz;
  g.sx = (long long)ny * nz;
  const int blocks = (n + ADV_THREADS - 1) / ADV_THREADS;
  advect_kernel<<<blocks, ADV_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)phi, (const float*)grad, (const float*)pos,
      (float*)out_pos, (float*)out_phi, n, iters, g, eps, mag_eps,
      mag_floor);
  return (int)cudaGetLastError();
}

// The block mode's sample: table (nb, ROW) int64 on the card, pos (n, 3):
// out (n, 4), each node's (phi, grad) from the row whose block owns its
// base cell on the global grid (nx, ny, nz), zeros where no row does.
extern "C" int lsf_advect_block_f32(const void* table, int nb,
                                    const void* pos, void* out, int n,
                                    int nx, int ny, int nz, float o0,
                                    float o1, float o2, float inv_dx,
                                    void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int blocks = (n + ADV_THREADS - 1) / ADV_THREADS;
  advect_sample_kernel<<<blocks, ADV_THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)table, nb, (const float*)pos, (float*)out, n,
      global_grid(nx, ny, nz, o0, o1, o2, inv_dx));
  return (int)cudaGetLastError();
}

// The block mode's run: state (n, 5) in place, each node's iterations
// while the table's blocks own its base cell (zero_sign: a mesh of more
// than one shard, whose sum turns -0.0 into +0.0).
extern "C" int lsf_advect_blocks_run_f32(const void* table, int nb,
                                         void* state, int n, int nx, int ny,
                                         int nz, float o0, float o1,
                                         float o2, float inv_dx, int iters,
                                         float eps, float mag_eps,
                                         float mag_floor, int zero_sign,
                                         void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int blocks = (n + ADV_THREADS - 1) / ADV_THREADS;
  advect_run_kernel<<<blocks, ADV_THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)table, nb, (float*)state, n, iters,
      global_grid(nx, ny, nz, o0, o1, o2, inv_dx), eps, mag_eps, mag_floor,
      zero_sign);
  return (int)cudaGetLastError();
}
