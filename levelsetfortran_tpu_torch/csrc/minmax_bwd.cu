// Kernel K6: the VJP of one dense min/max step (kernel K3) with respect to
// (phi, dx, h1).
//
// Replaces levelsetfortran_tpu/ops/minmax_pallas.py:minmax_bwd_padded (body
// _make_bwd_kernel, math in its docstring).  With res = c + gate h1 F,
// F = sel ? min(lap, 0) : max(lap, 0), lap = (sum6 - 6c) / dx^2:
//   * the band/interior gate and the 7-point-average switch are booleans:
//     no cotangent flows through them (band_radius and threshold get
//     exactly zero);
//   * d min(lap, 0)/d lap is 1 below 0, 0.5 at lap == 0 exactly (JAX's
//     convention for lax.min), 0 above; the same for max;
//   * cot_lap = gate h1 g dlap, cot_c = g - 6/dx^2 cot_lap,
//     cot_phi[t] = cot_c[t] + sum over the 6 neighbours n of cot_lap[n]/dx^2;
//   * cot_h1 = sum gate F g, cot_dx = -2/dx sum cot_lap lap (the wrapper
//     applies -2/dx to the float64 sum).
// Gather form, as on the TPU: one thread per cell recomputes its six
// neighbours' cot_lap (a radius-1 stencil of a radius-1 stencil), writes
// its own cotangent once and no float atomics run, so two launches give
// the same bits.  The two scalars are per-brick float64 partials (fixed
// shared-memory tree) added in order by reduce_partials.
//
// Face rule, as in K3: face cells never update (their cot is g) and an
// interior cell's +-1 reads never leave the grid.
//
// Banded mode (`active`, one int32 per 8^3 brick): an inactive brick is a
// pure cotangent passthrough, cot_phi = g (+ 0.0f, the dense kernel's
// rounding of its zero terms) with zero partials.  The caller's mask is the
// band4 dilation of the chunk-start iterate: a cell out of band never
// updates (the gate is its own value), so no cell within 4 of an inactive
// brick updates in the chunk, and the banded adjoint is the dense one.
//
// Block mode (lsf_minmax_bwd_block_f32, the TPU kernel's `offsets`): the
// arrays are one shard's block padded with 2 neighbour cells on its
// sharded axes (phi and the exchanged upstream cotangent g), every mask is
// in global coordinates, the brick grid covers the owned box and cot_phi
// has the owned box's shape.  An owned cell gathers the neighbour cells'
// cot_lap from the halo, in the solo order, so it equals the solo kernel's
// cell bitwise; the sums count the owned cells.  A solo grid is the block
// whose array and owned box are the whole grid.
//
// What bounds it on the H100: bytes at heart (~80 float operations per cell
// against 12 bytes of unique traffic); the seven recomputed stencils re-read
// phi and g through L1 within the 8^3 brick.
#include "common.cuh"

namespace {

using lsf::BRICK;
using lsf::NT;

struct MinmaxBwdParams {
  int nx, ny, nz;        // the array's dimensions (padded for a block)
  float h1, inv_dx2, band_dx, threshold;
};

// cot_lap of the cell at array offset s, global index (gi, gj, gk), for the
// output cotangent g; also its lap and the update's cotangent of h1 (F g
// where the cell updates, else 0).
__device__ __forceinline__ float cell_cot_lap(
    const float* __restrict__ phi, const float* __restrict__ g, long long s,
    int gi, int gj, int gk, const MinmaxBwdParams& p, const lsf::BlockGeom& q,
    float& lap, float& cot_h1) {
  lap = 0.0f;
  cot_h1 = 0.0f;
  if (!(gi >= 1 && gi <= q.g[0] - 2 && gj >= 1 && gj <= q.g[1] - 2
        && gk >= 1 && gk <= q.g[2] - 2))
    return 0.0f;
  const long long sx = (long long)p.ny * p.nz, sy = p.nz;
  const float c = __ldg(phi + s);
  if (!(fabsf(c) < p.band_dx)) return 0.0f;
  const float sum6 = ((((__ldg(phi + s - sx) + __ldg(phi + s + sx))
                        + __ldg(phi + s - sy)) + __ldg(phi + s + sy))
                      + __ldg(phi + s + 1)) + __ldg(phi + s - 1);
  lap = (sum6 - 6.0f * c) * p.inv_dx2;
  const bool sel_min = (sum6 + c) * (1.0f / 7.0f) < p.threshold;
  const float f = sel_min ? fminf(lap, 0.0f) : fmaxf(lap, 0.0f);
  const float tie = lap == 0.0f ? 0.5f : 0.0f;
  const float dlap = sel_min ? (lap < 0.0f ? 1.0f : tie)
                             : (lap > 0.0f ? 1.0f : tie);
  const float gv = __ldg(g + s);
  cot_h1 = f * gv;
  return (p.h1 * gv) * dlap;
}

__global__ void __launch_bounds__(NT)
minmax_bwd_kernel(const float* __restrict__ phi, const float* __restrict__ g,
                  float* __restrict__ cot_phi, MinmaxBwdParams p,
                  lsf::BlockGeom q, const int* __restrict__ active,
                  double* __restrict__ partials) {
  __shared__ double red[NT];
  const int i = q.c[0] + (q.t0[0] + (int)blockIdx.z) * BRICK + threadIdx.z;
  const int j = q.c[1] + (q.t0[1] + (int)blockIdx.y) * BRICK + threadIdx.y;
  const int k = q.c[2] + (q.t0[2] + (int)blockIdx.x) * BRICK + threadIdx.x;
  const int gi = q.o[0] + i, gj = q.o[1] + j, gk = q.o[2] + k;
  double cdx = 0.0, ch = 0.0;
  if (i >= 0 && i < p.nx && j >= 0 && j < p.ny && k >= 0 && k < p.nz
      && gi >= 0 && gi < q.g[0] && gj >= 0 && gj < q.g[1] && gk >= 0
      && gk < q.g[2] && lsf::in_rms_box(q, gi, gj, gk)) {
    const long long sx = (long long)p.ny * p.nz, sy = p.nz;
    const long long s = i * sx + j * sy + k;
    const long long ow =
        ((long long)(gi - q.rms[0]) * (q.rms[3] - q.rms[2]) + (gj - q.rms[2]))
            * (q.rms[5] - q.rms[4]) + (gk - q.rms[4]);
    if (!lsf::block_brick_active(active, q, i, j, k)) {
      cot_phi[ow] = g[s] + 0.0f;               // frozen: passthrough
    } else {
      float lap, cot_h1, unused_lap, unused_h1;
      const float cot_lap = cell_cot_lap(phi, g, s, gi, gj, gk, p, q, lap,
                                         cot_h1);
      // neighbours in the order x+, x-, y+, y-, z-, z+ (the TPU kernel's)
      const int di[6] = {1, -1, 0, 0, 0, 0};
      const int dj[6] = {0, 0, 1, -1, 0, 0};
      const int dk[6] = {0, 0, 0, 0, -1, 1};
      float acc = g[s] - (6.0f * p.inv_dx2) * cot_lap;
      for (int n = 0; n < 6; ++n)
        acc = acc + cell_cot_lap(phi, g, s + di[n] * sx + dj[n] * sy + dk[n],
                                 gi + di[n], gj + dj[n], gk + dk[n], p, q,
                                 unused_lap, unused_h1) * p.inv_dx2;
      cot_phi[ow] = acc;
      cdx = (double)(cot_lap * lap);
      ch = (double)cot_h1;
    }
  }
  const long long nbricks = (long long)gridDim.x * gridDim.y * gridDim.z;
  const long long brick = lsf::brick_id();
  const double tdx = lsf::block_sum(cdx, red);
  __syncthreads();
  const double th = lsf::block_sum(ch, red);
  if (lsf::thread_rank() == 0) {
    partials[brick] = tdx;
    partials[nbricks + brick] = th;
  }
}

int launch_minmax_bwd(const void* phi, const void* g, void* cot_phi,
                      const MinmaxBwdParams& p, const int* geom,
                      const void* active, void* partials, void* sums,
                      void* stream) {
  const lsf::BlockGeom q = lsf::block_geom(geom);
  const dim3 grid = lsf::block_launch_grid(geom);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  double* part = static_cast<double*>(partials);
  double* out = static_cast<double*>(sums);
  minmax_bwd_kernel<<<grid, dim3(BRICK, BRICK, BRICK), 0, st>>>(
      static_cast<const float*>(phi), static_cast<const float*>(g),
      static_cast<float*>(cot_phi), p, q, static_cast<const int*>(active),
      part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long nb = (long long)grid.x * grid.y * grid.z;
  lsf::reduce_partials<<<1, 1024, 0, st>>>(part, nb, out);
  lsf::reduce_partials<<<1, 1024, 0, st>>>(part + nb, nb, out + 1);
  return (int)cudaGetLastError();
}

}  // namespace

// Solo grid, dense (active == nullptr) or banded.
extern "C" int lsf_minmax_bwd_f32(const void* phi, const void* g,
                                  void* cot_phi, int nx, int ny, int nz,
                                  float h1, float inv_dx2, float band_dx,
                                  float threshold, const void* active,
                                  void* partials, void* sums, void* stream) {
  const MinmaxBwdParams p{nx, ny, nz, h1, inv_dx2, band_dx, threshold};
  int geom[lsf::BLOCK_GEOM_INTS];
  lsf::solo_geom(nx, ny, nz, geom);
  return launch_minmax_bwd(phi, g, cot_phi, p, geom, active, partials, sums,
                           stream);
}

// Block mode: geom: BLOCK_GEOM_INTS host ints; nx, ny, nz: the padded
// array's dimensions (the owned box and 2 cells around it inside the
// global grid); cot_phi has the owned box's shape.
extern "C" int lsf_minmax_bwd_block_f32(const void* phi, const void* g,
                                        void* cot_phi, int nx, int ny, int nz,
                                        const int* geom, float h1,
                                        float inv_dx2, float band_dx,
                                        float threshold, void* partials,
                                        void* sums, void* stream) {
  const MinmaxBwdParams p{nx, ny, nz, h1, inv_dx2, band_dx, threshold};
  return launch_minmax_bwd(phi, g, cot_phi, p, geom, nullptr, partials, sums,
                           stream);
}
