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
