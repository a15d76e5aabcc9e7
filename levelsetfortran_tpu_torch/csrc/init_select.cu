// K7: the exact-distance init's selection scan.  No Pallas counterpart: it
// replaces the scan that the JAX package compiles into its jitted init,
// levelsetfortran_tpu/ops/init_sign.py:nearest_sign_scan (:207) inside
// _culled_init (:660) and _dense_signed_distance_init (:785), without the
// final re-evaluation (which stays in PyTorch, where the vertex gradient
// flows).
//
// A row is one culling block of points (R rows of P points, given with
// their centres, the rows' "shifts") and its candidate triangles: a CSR
// list (flat, offsets, counts), or, with flat == NULL, the first counts[r]
// triangles (the dense init).  For each point: the position in its row of
// the candidate nearest by the quadratic-form Ericson distance about the
// row's shift, and the angle-weighted pseudonormal accumulator over the
// candidates tied within rel_tie, tile by tile of `tile` candidates.
//
// Bound: arithmetic, ~70 float operations per (point, candidate) pair
// against a few bytes per candidate.  Design: a thread block takes
// SEL_POINTS points of one row (a row of 16^3 points spans 8 blocks, each
// forming the same per-triangle constants).  Per tile, the block forms the
// constants of its candidates once in shared memory (32 floats each); then
// every thread makes two passes over them for its SEL_PPT points, carried
// in registers: the tile's minimum (its first index), then the tie sum
// against the threshold of the new minimum.  The two passes keep the plain
// version's tile-granular rule: the threshold that decides both a tile's
// contributions and whether the old accumulator survives is that of the
// minimum after the whole tile.
//
// Arithmetic: every expression of the plain version
// (ops/init_cuda.py:_select_scan) in its order, built with --fmad=false,
// the region picked as its where chain picks it (the vertex regions last,
// so they win; only the selected branch is evaluated, so no NaN of another
// branch can leak in).  The distances, and with them the argmin, are
// bitwise the plain version's; the accumulator adds a tile's terms in
// another order, so its last bits differ.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int SEL_THREADS = 256;
constexpr int SEL_PPT = 2;                            // points per thread
constexpr int SEL_POINTS = SEL_THREADS * SEL_PPT;     // points per block
constexpr int TRI_F4 = 8;                             // float4 per triangle
constexpr float EPS = 1e-30f;
constexpr float PI_F = 3.14159265358979323846f;
// 64 float32 machine epsilons (2^-17): the quadratic form's absolute floor
constexpr float QEPS_SCALE = 7.62939453125e-06f;

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return (a0 * b0 + a1 * b1) + a2 * b2;
}

// torch.clamp_min: NaN stays NaN
__device__ __forceinline__ float clamp_lo(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// The constants of triangle t about the shift s, in this float4 layout:
//   0 (ab.x, ab.y, ab.z, ac.x)   1 (ac.y, ac.z, n.x, n.y)
//   2 (n.z, a.x, a.y, a.z)       3 (ab.a, ac.a, ab.b, ac.b)
//   4 (ab.c, ac.c, a.a, b.b - a.a)
//   5 (c.c - a.a, bc.b, n.a, 1/|n|^2)
//   6 (1/|ab|^2, 1/|ac|^2, 1/|bc|^2, rsqrt |n|^2)
//   7 (the angles at a, b, c, 0)
// with a, b, c the vertices minus the shift and n = ab x ac unnormalised.
__device__ __forceinline__ void form_triangle(const float* __restrict__ tri,
                                              const float* __restrict__ ang,
                                              long long t, float s0, float s1,
                                              float s2, float4* out) {
  const float* v = tri + t * 9;
  const float a0 = v[0] - s0, a1 = v[1] - s1, a2 = v[2] - s2;
  const float b0 = v[3] - s0, b1 = v[4] - s1, b2 = v[5] - s2;
  const float c0 = v[6] - s0, c1 = v[7] - s1, c2 = v[8] - s2;
  const float ab0 = b0 - a0, ab1 = b1 - a1, ab2 = b2 - a2;
  const float ac0 = c0 - a0, ac1 = c1 - a1, ac2 = c2 - a2;
  const float bc0 = c0 - b0, bc1 = c1 - b1, bc2 = c2 - b2;
  const float n0 = ab1 * ac2 - ab2 * ac1;
  const float n1 = ab2 * ac0 - ab0 * ac2;
  const float n2 = ab0 * ac1 - ab1 * ac0;
  const float snn = dot3(n0, n1, n2, n0, n1, n2);
  const float saa = dot3(a0, a1, a2, a0, a1, a2);
  const float sbb = dot3(b0, b1, b2, b0, b1, b2);
  const float scc = dot3(c0, c1, c2, c0, c1, c2);
  out[0] = make_float4(ab0, ab1, ab2, ac0);
  out[1] = make_float4(ac1, ac2, n0, n1);
  out[2] = make_float4(n2, a0, a1, a2);
  out[3] = make_float4(dot3(ab0, ab1, ab2, a0, a1, a2),
                       dot3(ac0, ac1, ac2, a0, a1, a2),
                       dot3(ab0, ab1, ab2, b0, b1, b2),
                       dot3(ac0, ac1, ac2, b0, b1, b2));
  out[4] = make_float4(dot3(ab0, ab1, ab2, c0, c1, c2),
                       dot3(ac0, ac1, ac2, c0, c1, c2), saa, sbb - saa);
  out[5] = make_float4(scc - saa, dot3(bc0, bc1, bc2, b0, b1, b2),
                       dot3(n0, n1, n2, a0, a1, a2),
                       1.0f / clamp_lo(snn, EPS));
  const float sab = dot3(ab0, ab1, ab2, ab0, ab1, ab2);
  const float sac = dot3(ac0, ac1, ac2, ac0, ac1, ac2);
  const float sbc = dot3(bc0, bc1, bc2, bc0, bc1, bc2);
  out[6] = make_float4(1.0f / clamp_lo(sab, EPS), 1.0f / clamp_lo(sac, EPS),
                       1.0f / clamp_lo(sbc, EPS), rsqrtf(clamp_lo(snn, EPS)));
  const float* w = ang + t * 3;
  out[7] = make_float4(w[0], w[1], w[2], 0.0f);
}

// The clamped quadratic-form squared distance of point p (minus the shift,
// |p|^2 = psq) to triangle T; `plane` = n.(p - a) and `vert` the vertex
// region (0, 1, 2; 3 for an edge or the face), which the tie sum weighs.
__device__ __forceinline__ float pair_distance(const float4* T, float px,
                                               float py, float pz, float psq,
                                               float& plane, int& vert) {
  const float4 t0 = T[0], t1 = T[1], t2 = T[2], t3 = T[3], t4 = T[4],
               t5 = T[5];
  const float g1 = (px * t0.x + py * t0.y) + pz * t0.z;   // ab.p
  const float g2 = (px * t0.w + py * t1.x) + pz * t1.y;   // ac.p
  const float g3 = (px * t1.z + py * t1.w) + pz * t2.x;   // n.p
  const float g4 = (px * t2.y + py * t2.z) + pz * t2.w;   // a.p
  const float d1 = g1 - t3.x, d2 = g2 - t3.y;
  const float d3 = g1 - t3.z, d4 = g2 - t3.w;
  const float d5 = g1 - t4.x, d6 = g2 - t4.y;
  const float ap2 = (psq - 2.0f * g4) + t4.z;
  plane = g3 - t5.z;
  float d;
  if (d1 <= 0.0f && d2 <= 0.0f) {
    vert = 0;
    d = ap2;
  } else if (d3 >= 0.0f && d4 <= d3) {
    vert = 1;
    d = (ap2 - 2.0f * g1) + t4.w;
  } else if (d6 >= 0.0f && d5 <= d6) {
    vert = 2;
    d = (ap2 - 2.0f * g2) + t5.x;
  } else {
    vert = 3;
    const float va = d3 * d6 - d5 * d4;
    const float vb = d5 * d2 - d1 * d6;
    const float vc = d1 * d4 - d3 * d2;
    if (vc <= 0.0f && d1 >= 0.0f && d3 <= 0.0f) {
      d = ap2 - (d1 * d1) * T[6].x;
    } else if (vb <= 0.0f && d2 >= 0.0f && d6 <= 0.0f) {
      d = ap2 - (d2 * d2) * T[6].y;
    } else if (va <= 0.0f && (d4 - d3) >= 0.0f && (d5 - d6) >= 0.0f) {
      const float bp2 = (ap2 - 2.0f * g1) + t4.w;
      const float bcbp = (g2 - g1) - t5.y;
      d = bp2 - (bcbp * bcbp) * T[6].z;
    } else {
      d = (plane * plane) * t5.w;
    }
  }
  return clamp_lo(d, 0.0f);
}

// amax's rule: NaN wins
__device__ __forceinline__ float max_nan(float m, float q) {
  return (isnan(q) || q > m) ? q : m;
}

__global__ void __launch_bounds__(SEL_THREADS)
init_select_kernel(const float* __restrict__ pts,
                   const float* __restrict__ shift,
                   const float* __restrict__ tri,
                   const float* __restrict__ ang,
                   const int* __restrict__ flat,
                   const long long* __restrict__ offsets,
                   const int* __restrict__ counts, int P, int chunks,
                   int tile, float tie, float tie_floor,
                   int* __restrict__ best_out, float* __restrict__ acc_out) {
  extern __shared__ float4 tris[];                  // tile * TRI_F4
  __shared__ float warp_max[SEL_THREADS / 32];
  const long long row = blockIdx.x / chunks;
  const int chunk = blockIdx.x % chunks;
  const int tid = threadIdx.x;
  const float s0 = shift[row * 3], s1 = shift[row * 3 + 1],
              s2 = shift[row * 3 + 2];
  const float* rp = pts + row * P * 3;

  // qeps: 2^-17 times the largest |p - shift|^2 of the row
  float m = -INFINITY;
  for (int p = tid; p < P; p += SEL_THREADS) {
    const float x = rp[p * 3] - s0, y = rp[p * 3 + 1] - s1,
                z = rp[p * 3 + 2] - s2;
    m = max_nan(m, dot3(x, y, z, x, y, z));
  }
  for (int o = 16; o > 0; o >>= 1)
    m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((tid & 31) == 0) warp_max[tid >> 5] = m;
  __syncthreads();
  m = warp_max[0];
  for (int w = 1; w < SEL_THREADS / 32; ++w) m = max_nan(m, warp_max[w]);
  const float qeps = QEPS_SCALE * m;

  float px[SEL_PPT], py[SEL_PPT], pz[SEL_PPT], psq[SEL_PPT];
  float best_d[SEL_PPT], acc[SEL_PPT];
  int best_i[SEL_PPT];
#pragma unroll
  for (int k = 0; k < SEL_PPT; ++k) {
    const int p = chunk * SEL_POINTS + k * SEL_THREADS + tid;
    const int q = p < P ? p : P - 1;
    px[k] = rp[q * 3] - s0;
    py[k] = rp[q * 3 + 1] - s1;
    pz[k] = rp[q * 3 + 2] - s2;
    psq[k] = dot3(px[k], py[k], pz[k], px[k], py[k], pz[k]);
    best_d[k] = INFINITY;
    acc[k] = 0.0f;
    best_i[k] = 0;
  }

  const int count = counts[row];
  const long long off = flat != nullptr ? offsets[row] : 0;
  for (int base = 0; base < count; base += tile) {
    const int nt = min(tile, count - base);
    __syncthreads();                 // the previous tile's readers are done
    for (int j = tid; j < nt; j += SEL_THREADS) {
      const long long t =
          flat != nullptr ? (long long)flat[off + base + j] : base + j;
      form_triangle(tri, ang, t, s0, s1, s2, tris + j * TRI_F4);
    }
    __syncthreads();

    // pass 1: the tile's minimum, its first index
    float tmin[SEL_PPT];
    int targ[SEL_PPT];
#pragma unroll
    for (int k = 0; k < SEL_PPT; ++k) {
      tmin[k] = INFINITY;
      targ[k] = 0;
    }
    for (int j = 0; j < nt; ++j) {
      const float4* T = tris + j * TRI_F4;
#pragma unroll
      for (int k = 0; k < SEL_PPT; ++k) {
        float plane;
        int vert;
        const float d =
            pair_distance(T, px[k], py[k], pz[k], psq[k], plane, vert);
        if (d < tmin[k] || (isnan(d) && !isnan(tmin[k]))) {
          tmin[k] = d;
          targ[k] = j;
        }
      }
    }
    float new_d[SEL_PPT], thresh[SEL_PPT], tsum[SEL_PPT];
#pragma unroll
    for (int k = 0; k < SEL_PPT; ++k) {
      const bool better = tmin[k] < best_d[k];
      new_d[k] = better ? tmin[k] : best_d[k];
      if (better) best_i[k] = base + targ[k];
      thresh[k] = ((new_d[k] * tie) + tie_floor) + qeps;
      tsum[k] = 0.0f;
    }

    // pass 2: the tile's tie sum against the new minimum's threshold
    for (int j = 0; j < nt; ++j) {
      const float4* T = tris + j * TRI_F4;
#pragma unroll
      for (int k = 0; k < SEL_PPT; ++k) {
        float plane;
        int vert;
        const float d =
            pair_distance(T, px[k], py[k], pz[k], psq[k], plane, vert);
        if (d <= thresh[k]) {
          const float4 t7 = T[7];
          const float w = vert == 0   ? t7.x
                          : vert == 1 ? t7.y
                          : vert == 2 ? t7.z
                                      : PI_F;
          tsum[k] += w * (plane * T[6].w);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < SEL_PPT; ++k) {
      acc[k] = (best_d[k] <= thresh[k] ? acc[k] : 0.0f) + tsum[k];
      best_d[k] = new_d[k];
    }
  }

#pragma unroll
  for (int k = 0; k < SEL_PPT; ++k) {
    const int p = chunk * SEL_POINTS + k * SEL_THREADS + tid;
    if (p < P) {
      best_out[row * P + p] = best_i[k];
      acc_out[row * P + p] = acc[k];
    }
  }
}

}  // namespace

// pts (rows, P, 3), shift (rows, 3), tri (E + 1, 3, 3), ang (E + 1, 3),
// flat (int32, NULL for the dense init), offsets (int64, NULL with flat),
// counts (int32): best (int32) and acc (float32), both (rows, P).
extern "C" int lsf_init_select_f32(const void* pts, const void* shift,
                                   const void* tri, const void* ang,
                                   const void* flat, const void* offsets,
                                   const void* counts, int rows, int P,
                                   int tile, float tie, float tie_floor,
                                   void* best, void* acc, void* stream) {
  if (rows <= 0 || P <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)tile * TRI_F4 * sizeof(float4);
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)init_select_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int chunks = (P + SEL_POINTS - 1) / SEL_POINTS;
  const long long blocks = (long long)rows * chunks;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidConfiguration;
  init_select_kernel<<<(unsigned)blocks, SEL_THREADS, smem,
                       (cudaStream_t)stream>>>(
      (const float*)pts, (const float*)shift, (const float*)tri,
      (const float*)ang, (const int*)flat, (const long long*)offsets,
      (const int*)counts, P, chunks, tile, tie, tie_floor, (int*)best,
      (float*)acc);
  return (int)cudaGetLastError();
}
