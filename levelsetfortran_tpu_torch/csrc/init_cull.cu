// K10: the exact-distance init's candidate culling, on the card.  No Pallas
// counterpart: the JAX package builds the culling on the host in numpy
// (levelsetfortran_tpu/ops/init_sign.py:495-657), and so does the port on
// the CPU (ops/init_sign.py:build_init_culling).  On the CUDA route of
// signed_distance_init(culling="auto") K10 builds the selection scan's rows
// (ops/init_cuda.py:Rows) in that build's place.
//
// It computes the host build's definition.  A "row" is a 4^3-block parent
// or a 16^3-point block; d(t) is the float32 distance from the row's centre
// to triangle t's centroid and r(t) the triangle's radius.  Per row: j, the
// argmin of d + r over the row's columns (every triangle for a parent; the
// parent's survivors for a block), the lowest index on a tie; the exact
// float64 distance d_ex from the row's centre to triangle j; then
// ub = d_ex + R + margin, rounded to float32, and the threshold
// ub * (1 + 1e-3) + R + slack in float32.  A column survives where
// d - r <= threshold and, for a block, where its parent keeps it too.  A
// block's survivors are written in ascending triangle order.
//
// Arithmetic: numpy's float32 steps in its order (the dot spelled out in a
// fixed order, * -2, + |c|^2, + |t|^2, sqrt(max(., 0)), - r, <=), built
// with --fmad=false, and ops/cull_cuda.py:_np_point_tri_d2's float64
// steps for d_ex.  So the rows are bitwise the plain version's
// (ops/cull_cuda.py:cull_rows_plain); against the host build, whose BLAS
// may round the three-term dot another way, a pair can differ only within
// a few ulps of the quadratic form from its threshold.
//
// Bound: launches and the one host read between passes 2 and 3 (the row
// counts, which size the output).  The tests are ~10 float operations a
// (row, triangle) pair, a few 10^7 pairs on a 256^3 grid: microseconds.
// Design: three kernels, one thread block of CULL_THREADS per row, and
// nothing of size (rows x triangles) in memory: a block evaluates its
// parent's test again wherever it needs it (one more distance a column).
//   1. cull_parents_kernel: each parent's threshold;
//   2. cull_blocks_kernel: each block's threshold and survivor count;
//   3. cull_fill_kernel: each block's survivors, a tile of CULL_THREADS
//      ascending triangles at a time, placed by a warp ballot and a prefix
//      count over the tile's warps.
#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int CULL_THREADS = 256;
constexpr int CULL_WARPS = CULL_THREADS / 32;
constexpr int PARENT = 4;  // blocks a parent spans along an axis
constexpr unsigned FULL = 0xffffffffu;

// np.maximum / torch.clamp_min: NaN stays NaN
__device__ __forceinline__ float clamp_lo(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// A row's centre minus the shift and its |.|^2, float32.
struct Row {
  float x, y, z, sq;
};

__device__ __forceinline__ Row row_at(const float* cen, const float* sq,
                                      int i) {
  return Row{cen[3 * i], cen[3 * i + 1], cen[3 * i + 2], sq[i]};
}

// The triangles' float32 constants: centroids minus the shift (3, E), their
// |.|^2 and their radii.
struct Columns {
  const float* tc;
  const float* tsq;
  const float* r;
  int E;

  // the centre-to-centroid distance, in numpy's float32 steps
  __device__ __forceinline__ float distance(const Row& c, int t) const {
    float d = (c.x * tc[t] + c.y * tc[E + t]) + c.z * tc[2 * E + t];
    d = d * -2.0f;
    d = d + c.sq;
    d = d + tsq[t];
    return sqrtf(clamp_lo(d, 0.0f));
  }

  __device__ __forceinline__ bool keeps(const Row& c, float thresh,
                                        int t) const {
    return distance(c, t) - r[t] <= thresh;
  }
};

// The block raster (nb0, nb1, nb2) and its parents' (nbc0, nbc1, nbc2);
// thresholds are stored parents first, then blocks.
struct Raster {
  int nb1, nb2, nbc1, nbc2, parents;

  __device__ __forceinline__ int parent(int b) const {
    const int bx = b / (nb1 * nb2), by = (b / nb2) % nb1, bz = b % nb2;
    return ((bx / PARENT) * nbc1 + by / PARENT) * nbc2 + bz / PARENT;
  }
};

// threshold = ub * widen + R32 + slack, ub = float(d_ex + R + margin)
struct Bound {
  double R, margin;
  float widen, R32, slack;
};

// np.argmin's order: the first minimum, a NaN before any number
__device__ __forceinline__ bool before(float v, int i, float bv, int bi) {
  if (isnan(bv)) return isnan(v) && i < bi;
  if (isnan(v)) return true;
  return v < bv || (v == bv && i < bi);
}

__device__ __forceinline__ double dot3d(const double* u, const double* v) {
  return (u[0] * v[0] + u[1] * v[1]) + u[2] * v[2];
}

// numpy's x / where(|y| > 1e-300, y, 1)
__device__ __forceinline__ double guarded(double x, double y) {
  return x / (fabs(y) > 1e-300 ? y : 1.0);
}

// Exact squared distance from p to triangle v (9 doubles), step for step
// ops/cull_cuda.py:_np_point_tri_d2 (the vertex regions win, as its where
// chain has them).
__device__ double point_tri_d2(const double* p, const double* v) {
  double a[3], b[3], c[3], ab[3], ac[3], ap[3], bp[3], cp[3], o[3];
  for (int k = 0; k < 3; ++k) {
    a[k] = v[k];
    b[k] = v[3 + k];
    c[k] = v[6 + k];
    ab[k] = b[k] - a[k];
    ac[k] = c[k] - a[k];
    ap[k] = p[k] - a[k];
    bp[k] = p[k] - b[k];
    cp[k] = p[k] - c[k];
  }
  const double d1 = dot3d(ab, ap), d2 = dot3d(ac, ap);
  const double d3 = dot3d(ab, bp), d4 = dot3d(ac, bp);
  const double d5 = dot3d(ab, cp), d6 = dot3d(ac, cp);
  const double va = d3 * d6 - d5 * d4;
  const double vb = d5 * d2 - d1 * d6;
  const double vc = d1 * d4 - d3 * d2;
  if (d1 <= 0.0 && d2 <= 0.0) {
    for (int k = 0; k < 3; ++k) o[k] = a[k];
  } else if (d3 >= 0.0 && d4 <= d3) {
    for (int k = 0; k < 3; ++k) o[k] = b[k];
  } else if (d6 >= 0.0 && d5 <= d6) {
    for (int k = 0; k < 3; ++k) o[k] = c[k];
  } else if (vc <= 0.0 && d1 >= 0.0 && d3 <= 0.0) {
    const double t = guarded(d1, d1 - d3);
    for (int k = 0; k < 3; ++k) o[k] = a[k] + t * ab[k];
  } else if (vb <= 0.0 && d2 >= 0.0 && d6 <= 0.0) {
    const double t = guarded(d2, d2 - d6);
    for (int k = 0; k < 3; ++k) o[k] = a[k] + t * ac[k];
  } else if (va <= 0.0 && (d4 - d3) >= 0.0 && (d5 - d6) >= 0.0) {
    const double t = guarded(d4 - d3, (d4 - d3) + (d5 - d6));
    for (int k = 0; k < 3; ++k) o[k] = b[k] + t * (c[k] - b[k]);
  } else {
    const double den = va + vb + vc;
    const double inv = 1.0 / (fabs(den) > 1e-300 ? den : 1.0);
    const double vv = vb * inv, ww = vc * inv;
    for (int k = 0; k < 3; ++k) o[k] = (a[k] + vv * ab[k]) + ww * ac[k];
  }
  double u[3];
  for (int k = 0; k < 3; ++k) u[k] = p[k] - o[k];
  return dot3d(u, u);
}

// The threshold of row c (its float64 centre `centre`) over the columns
// that `admit` lets in, the same in every thread of the block.  A row with
// no column keeps none.
template <class Admit>
__device__ float row_threshold(const Columns& C, const Row& c,
                               const double* centre, const double* tri,
                               const Bound& k, Admit admit, float* s_v,
                               int* s_i) {
  float bv = INFINITY;
  int bi = INT_MAX;
  for (int t = threadIdx.x; t < C.E; t += CULL_THREADS) {
    if (!admit(t)) continue;
    const float v = C.distance(c, t) + C.r[t];
    if (before(v, t, bv, bi)) {
      bv = v;
      bi = t;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(FULL, bv, o);
    const int oi = __shfl_xor_sync(FULL, bi, o);
    if (before(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if ((threadIdx.x & 31) == 0) {
    s_v[threadIdx.x >> 5] = bv;
    s_i[threadIdx.x >> 5] = bi;
  }
  __syncthreads();
  bv = s_v[0];
  bi = s_i[0];
  for (int w = 1; w < CULL_WARPS; ++w)
    if (before(s_v[w], s_i[w], bv, bi)) {
      bv = s_v[w];
      bi = s_i[w];
    }
  if (bi == INT_MAX) return -INFINITY;
  const double d_ex = sqrt(point_tri_d2(centre, tri + 9LL * bi));
  const float ub = (float)((d_ex + k.R) + k.margin);
  return ((ub * k.widen) + k.R32) + k.slack;
}

__global__ void __launch_bounds__(CULL_THREADS)
cull_parents_kernel(Columns C, const float* __restrict__ pcen,
                    const float* __restrict__ pc_sq,
                    const double* __restrict__ pcen_abs,
                    const double* __restrict__ tri, Bound k,
                    float* __restrict__ thresh) {
  __shared__ float s_v[CULL_WARPS];
  __shared__ int s_i[CULL_WARPS];
  const int p = blockIdx.x;
  const float th =
      row_threshold(C, row_at(pcen, pc_sq, p), pcen_abs + 3LL * p, tri, k,
                    [](int) { return true; }, s_v, s_i);
  if (threadIdx.x == 0) thresh[p] = th;
}

__global__ void __launch_bounds__(CULL_THREADS)
cull_blocks_kernel(Columns C, const float* __restrict__ cen,
                   const float* __restrict__ c_sq,
                   const double* __restrict__ centers,
                   const float* __restrict__ pcen,
                   const float* __restrict__ pc_sq,
                   const double* __restrict__ tri, Raster g, Bound k,
                   float* __restrict__ thresh, int* __restrict__ counts) {
  __shared__ float s_v[CULL_WARPS];
  __shared__ int s_i[CULL_WARPS];
  __shared__ int s_n[CULL_WARPS];
  const int b = blockIdx.x, p = g.parent(b);
  const Row pc = row_at(pcen, pc_sq, p), c = row_at(cen, c_sq, b);
  const float tp = thresh[p];
  const float tb = row_threshold(
      C, c, centers + 3LL * b, tri, k,
      [&](int t) { return C.keeps(pc, tp, t); }, s_v, s_i);
  int n = 0;
  for (int t = threadIdx.x; t < C.E; t += CULL_THREADS)
    n += C.keeps(pc, tp, t) && C.keeps(c, tb, t);
  for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(FULL, n, o);
  if ((threadIdx.x & 31) == 0) s_n[threadIdx.x >> 5] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < CULL_WARPS; ++w) n += s_n[w];
    counts[b] = n;
    thresh[g.parents + b] = tb;
  }
}

__global__ void __launch_bounds__(CULL_THREADS)
cull_fill_kernel(Columns C, const float* __restrict__ cen,
                 const float* __restrict__ c_sq,
                 const float* __restrict__ pcen,
                 const float* __restrict__ pc_sq, Raster g,
                 const float* __restrict__ thresh,
                 const long long* __restrict__ offsets,
                 int* __restrict__ flat) {
  __shared__ int s_n[CULL_WARPS];
  const int b = blockIdx.x, p = g.parent(b);
  const Row pc = row_at(pcen, pc_sq, p), c = row_at(cen, c_sq, b);
  const float tp = thresh[p], tb = thresh[g.parents + b];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long pos = offsets[b];
  for (int base = 0; base < C.E; base += CULL_THREADS) {
    const int t = base + threadIdx.x;
    const bool keep = t < C.E && C.keeps(pc, tp, t) && C.keeps(c, tb, t);
    const unsigned m = __ballot_sync(FULL, keep);
    if (lane == 0) s_n[warp] = __popc(m);
    __syncthreads();
    int ahead = 0, total = 0;
    for (int w = 0; w < CULL_WARPS; ++w) {
      ahead += w < warp ? s_n[w] : 0;
      total += s_n[w];
    }
    if (keep) flat[pos + ahead + __popc(m & ((1u << lane) - 1u))] = t;
    pos += total;
    __syncthreads();  // the tile's counts are read before the next's
  }
}

}  // namespace

// Passes 1 and 2.  Blocks: cen (B, 3) and c_sq (B) float32, centers (B, 3)
// float64; parents: pcen (Bc, 3), pc_sq (Bc) float32, pcen_abs (Bc, 3)
// float64; triangles: tc (3, E), t_sq (E), r (E) float32, tri (E, 3, 3)
// float64.  Out: thresh (Bc + B) float32, counts (B) int32.
extern "C" int lsf_cull_count(
    const void* cen, const void* c_sq, const void* centers, const void* pcen,
    const void* pc_sq, const void* pcen_abs, const void* tc, const void* t_sq,
    const void* r, const void* tri, int blocks, int parents, int E, int nb1,
    int nb2, int nbc1, int nbc2, double R_b, double R_p, double margin,
    float widen, float R_b32, float R_p32, float slack, void* thresh,
    void* counts, void* stream) {
  if (blocks <= 0) return (int)cudaSuccess;
  const Columns C{(const float*)tc, (const float*)t_sq, (const float*)r, E};
  const cudaStream_t s = (cudaStream_t)stream;
  cull_parents_kernel<<<parents, CULL_THREADS, 0, s>>>(
      C, (const float*)pcen, (const float*)pc_sq, (const double*)pcen_abs,
      (const double*)tri, Bound{R_p, margin, widen, R_p32, slack},
      (float*)thresh);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cull_blocks_kernel<<<blocks, CULL_THREADS, 0, s>>>(
      C, (const float*)cen, (const float*)c_sq, (const double*)centers,
      (const float*)pcen, (const float*)pc_sq, (const double*)tri,
      Raster{nb1, nb2, nbc1, nbc2, parents},
      Bound{R_b, margin, widen, R_b32, slack}, (float*)thresh, (int*)counts);
  return (int)cudaGetLastError();
}

// Pass 3: each block's survivors into flat (int32) from offsets[b] (int64),
// with the thresholds of pass 2.
extern "C" int lsf_cull_fill(const void* cen, const void* c_sq,
                             const void* pcen, const void* pc_sq,
                             const void* tc, const void* t_sq, const void* r,
                             int blocks, int parents, int E, int nb1, int nb2,
                             int nbc1, int nbc2, const void* thresh,
                             const void* offsets, void* flat, void* stream) {
  if (blocks <= 0) return (int)cudaSuccess;
  cull_fill_kernel<<<blocks, CULL_THREADS, 0, (cudaStream_t)stream>>>(
      Columns{(const float*)tc, (const float*)t_sq, (const float*)r, E},
      (const float*)cen, (const float*)c_sq, (const float*)pcen,
      (const float*)pc_sq, Raster{nb1, nb2, nbc1, nbc2, parents},
      (const float*)thresh, (const long long*)offsets, (int*)flat);
  return (int)cudaGetLastError();
}
