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
// What bounds it on the H100: bytes at heart (~80 float operations per cell
// against 12 bytes of unique traffic); the seven recomputed stencils re-read
// phi and g through L1 within the 8^3 brick.
#include "common.cuh"

namespace {

using lsf::BRICK;
using lsf::NT;

struct MinmaxBwdParams {
  int nx, ny, nz;
  float h1, inv_dx2, band_dx, threshold;
};

__device__ __forceinline__ bool interior(int i, int j, int k,
                                         const MinmaxBwdParams& p) {
  return i >= 1 && i <= p.nx - 2 && j >= 1 && j <= p.ny - 2 && k >= 1
         && k <= p.nz - 2;
}

// cot_lap of cell (i, j, k) for the output cotangent g; also its lap and
// the update's cotangent of h1 (F g where the cell updates, else 0).
__device__ __forceinline__ float cell_cot_lap(
    const float* __restrict__ phi, const float* __restrict__ g, int i, int j,
    int k, const MinmaxBwdParams& p, float& lap, float& cot_h1) {
  lap = 0.0f;
  cot_h1 = 0.0f;
  if (!interior(i, j, k, p)) return 0.0f;
  const long long sx = (long long)p.ny * p.nz, sy = p.nz;
  const long long s = i * sx + j * sy + k;
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
                  double* __restrict__ partials) {
  __shared__ double red[NT];
  const int k = blockIdx.x * BRICK + threadIdx.x;
  const int j = blockIdx.y * BRICK + threadIdx.y;
  const int i = blockIdx.z * BRICK + threadIdx.z;
  double cdx = 0.0, ch = 0.0;
  if (i < p.nx && j < p.ny && k < p.nz) {
    const long long s = ((long long)i * p.ny + j) * p.nz + k;
    float lap, cot_h1, unused_lap, unused_h1;
    const float cot_lap = cell_cot_lap(phi, g, i, j, k, p, lap, cot_h1);
    // neighbours in the order x+, x-, y+, y-, z-, z+ (the TPU kernel's)
    const int di[6] = {1, -1, 0, 0, 0, 0};
    const int dj[6] = {0, 0, 1, -1, 0, 0};
    const int dk[6] = {0, 0, 0, 0, -1, 1};
    float acc = g[s] - (6.0f * p.inv_dx2) * cot_lap;
    for (int n = 0; n < 6; ++n)
      acc = acc + cell_cot_lap(phi, g, i + di[n], j + dj[n], k + dk[n], p,
                               unused_lap, unused_h1) * p.inv_dx2;
    cot_phi[s] = acc;
    cdx = (double)(cot_lap * lap);
    ch = (double)cot_h1;
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

}  // namespace

extern "C" int lsf_minmax_bwd_f32(const void* phi, const void* g,
                                  void* cot_phi, int nx, int ny, int nz,
                                  float h1, float inv_dx2, float band_dx,
                                  float threshold, void* partials, void* sums,
                                  void* stream) {
  const MinmaxBwdParams p{nx, ny, nz, h1, inv_dx2, band_dx, threshold};
  const dim3 grid = lsf::brick_grid(nx, ny, nz);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  double* part = static_cast<double*>(partials);
  double* out = static_cast<double*>(sums);
  minmax_bwd_kernel<<<grid, dim3(BRICK, BRICK, BRICK), 0, st>>>(
      static_cast<const float*>(phi), static_cast<const float*>(g),
      static_cast<float*>(cot_phi), p, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long nb = (long long)grid.x * grid.y * grid.z;
  lsf::reduce_partials<<<1, 1024, 0, st>>>(part, nb, out);
  lsf::reduce_partials<<<1, 1024, 0, st>>>(part + nb, nb, out + 1);
  return (int)cudaGetLastError();
}
