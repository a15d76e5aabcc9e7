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
//     cot_phi[t] = cot_c[t] + sum over the 6 neighbours n of cot_lap[n]/dx^2
//     (in the order x+, x-, y+, y-, z-, z+);
//   * cot_h1 = sum gate F g, cot_dx = -2/dx sum cot_lap lap (the kernel
//     applies -2/dx to the float64 sum).
// Gather form, as on the TPU: each cell writes its own cotangent once and no
// float atomics run, so two launches give the same bits.
//
// What bounds it on the H100: bytes (~40 float operations per cell against
// 12 bytes of unique traffic: phi and g read, cot_phi written).  The first
// port gave each 8^3 brick a block and each cell a thread that recomputed
// its six neighbours' cot_lap: 56 loads per cell through L1 with 64-bit
// address arithmetic, four 32-byte z rows per warp, a 10-barrier tree per
// sum and brick and two more launches for the sums.  This kernel is K3's
// march (minmax_step.cu, common.cuh): a block owns a K6_TY x MARCH_TZ (y, z)
// column and a chunk of x-slabs, and walks x one plane per step.  phi (a
// 2-cell y/z rim) and g (a 1-cell rim) are prefetched by cp.async into a
// shared ring; each step evaluates cot_lap ONCE per cell of the next plane
// over the column and a 1-cell rim, keeps the products cs = cot_lap / dx^2
// of the y/z neighbours in a 2-plane shared ring and the column's own x
// neighbours in registers, and gathers the current plane: one barrier per
// plane.  With --fmad=false a product has the same bits whichever thread
// forms it, so every cotangent is the brick-per-cell gather's bitwise.  The
// two sums take block_sum's brick tree (registers, shared memory, shuffles,
// both behind one barrier) and the launch's last block adds the partials
// in reduce_partials's order, both sums side by side.  On the card it runs
// at ~37% of the byte bound (PERF.md §6), held back by the evaluation's
// instructions, the rim (its cells take a second evaluation on four of
// the sixteen warps) and the barrier per plane, not by device memory.
//
// Face rule, as in K3: face cells never update (their cot is g), and a cell
// evaluates cot_lap only inside the global interior and the array's (an
// owned cell's neighbours always are: their +-1 reads lie in the array).
// Other cells give cot_lap = 0 and read nothing.
//
// Banded mode (`active`, one int32 per 8^3 brick): an inactive brick is a
// pure cotangent passthrough, cot_phi = g (+ 0.0f, the dense kernel's
// rounding of its zero terms) with zero partials; a neighbour's cot_lap is
// evaluated whatever its brick's flag.  A slab whose column's bricks are
// all frozen is copied from g with no evaluation, and a banded launch cuts
// its chunks to K6_BANDED_CHUNK slabs, so that the blocks whose columns
// cross the band do not set its time alone.  The caller's mask is the
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
#include "async_copy.cuh"
#include "common.cuh"

namespace {

using lsf::BRICK;
using lsf::MARCH_TZ;

struct MinmaxBwdParams {
  int nx, ny, nz;        // the array's dimensions (padded for a block)
  float h1, inv_dx2, band_dx, threshold;
};

constexpr int K6_TY = 16, K6_NT = K6_TY * MARCH_TZ;
constexpr int K6_PZ = MARCH_TZ + 4, K6_PHI = (K6_TY + 4) * K6_PZ;  // 2-rim
constexpr int K6_GZ = MARCH_TZ + 2, K6_G = (K6_TY + 2) * K6_GZ;    // 1-rim
constexpr int K6_RIM = 2 * K6_GZ + 2 * K6_TY;    // 1-rim cells a plane
constexpr int K6_RING = 8;                        // planes in shared
constexpr int K6_AHEAD = 5;     // plane p + 1 + K6_AHEAD is copied at step p
// a frozen slab costs a copy and a live one a walk, so the blocks of a
// banded launch differ by their columns' live slabs: short chunks of slabs
// let the card's block scheduler even them out
constexpr int K6_BANDED_CHUNK = 2;
// dynamic shared memory: red (both sums' trees, the finish's 2 x 1024
// doubles), the phi and g rings, two cs planes
constexpr int K6_RED = 2 * K6_NT > 2048 ? 2 * K6_NT : 2048;
constexpr size_t K6_SMEM = sizeof(double) * K6_RED
                           + sizeof(float) * (K6_RING * (K6_PHI + K6_G)
                                              + 2 * K6_G);

// cot_lap of the cell at phi-ring offset w (g-ring offset wg) of a plane
// whose phi planes are pm, p0, pp, for the output cotangent plane gp; also
// its lap and the update's cotangent of h1 (F g where the cell updates,
// else 0).  Only for a cell inside the global interior and the array's.
__device__ __forceinline__ float cot_lap_at(const float* pm, const float* p0,
                                            const float* pp, const float* gp,
                                            int w, int wg,
                                            const MinmaxBwdParams& p,
                                            float& lap, float& cot_h1) {
  lap = 0.0f;
  cot_h1 = 0.0f;
  const float c = p0[w];
  if (!(fabsf(c) < p.band_dx)) return 0.0f;
  const float sum6 = ((((pm[w] + pp[w]) + p0[w - K6_PZ]) + p0[w + K6_PZ])
                      + p0[w + 1]) + p0[w - 1];
  lap = (sum6 - 6.0f * c) * p.inv_dx2;
  const bool sel_min = (sum6 + c) * (1.0f / 7.0f) < p.threshold;
  const float f = sel_min ? fminf(lap, 0.0f) : fmaxf(lap, 0.0f);
  const float tie = lap == 0.0f ? 0.5f : 0.0f;
  const float dlap = sel_min ? (lap < 0.0f ? 1.0f : tie)
                             : (lap > 0.0f ? 1.0f : tie);
  const float gv = gp[wg];
  cot_h1 = f * gv;
  return (p.h1 * gv) * dlap;
}

// One cell's evaluation of a plane: cot_lap, its lap and cot_h1, g.
struct CellEval {
  float cot_lap, lap, cot_h1, g;
};

// K6's march (every mode: dense, banded, block).  Per cell, in the frame of
// q:
//   evaluates = global interior && array interior (its cot_lap);
//   writes    = in the launch's bricks, the array and q's rms box (the
//               owned box; the whole grid for a solo launch): cot_phi at
//               its owned-box offset;
//   gathers   = writes && its brick active; else cot_phi = g + 0.0f;
//   counts    = gathers (both sums).
// Planes: at step p a block evaluates plane p over the column and its
// 1-cell rim (threads < K6_RIM take one rim cell each) and writes plane p -
// 1, whose y/z neighbours' cs the last step left in shared memory and whose
// x neighbours' cs (planes p - 2 and p, the same column) the thread holds.
__global__ void __launch_bounds__(K6_NT, 1024 / K6_NT)
minmax_bwd_march_kernel(const float* __restrict__ phi,
                        const float* __restrict__ g,
                        float* __restrict__ cot_phi, MinmaxBwdParams p,
                        lsf::BlockGeom q, lsf::MarchLaunch L,
                        const int* __restrict__ active,
                        double* __restrict__ partials,
                        double* __restrict__ sums,
                        unsigned* __restrict__ ticket, int accumulate,
                        double scale) {
  constexpr int BY = K6_TY / BRICK, BZ = MARCH_TZ / BRICK;
  extern __shared__ __align__(16) unsigned char k6_smem[];
  double* red = reinterpret_cast<double*>(k6_smem);
  float (*ring)[K6_PHI] = reinterpret_cast<float (*)[K6_PHI]>(red + K6_RED);
  float (*gring)[K6_G] = reinterpret_cast<float (*)[K6_G]>(ring + K6_RING);
  float (*cs)[K6_G] = gring + K6_RING;
  const int tid = threadIdx.x;
  const int ty = tid / MARCH_TZ, tz = tid % MARCH_TZ;
  const int cx = blockIdx.z;
  const int sx = p.ny * p.nz;                 // an array has < 2^31 cells
  const long long nbr = (long long)L.tn[0] * L.tn[1] * L.tn[2];
  const int byl0 = blockIdx.y * BY, bzl0 = blockIdx.x * BZ;
  const int y0 = q.c[1] + (q.t0[1] + byl0) * BRICK;
  const int z0 = q.c[2] + (q.t0[2] + bzl0) * BRICK;
  // whether array cell (., j, k) evaluates on the y/z axes
  auto yz_eval = [&](int j, int k) {
    const int gj = q.o[1] + j, gk = q.o[2] + k;
    return gj >= 1 && gj <= q.g[1] - 2 && gk >= 1 && gk <= q.g[2] - 2
           && j >= 1 && j <= p.ny - 2 && k >= 1 && k <= p.nz - 2;
  };
  const int j = y0 + ty, k = z0 + tz;
  const int gj = q.o[1] + j, gk = q.o[2] + k;
  const bool col_in = j >= 0 && j < p.ny && k >= 0 && k < p.nz;
  const bool col = col_in && byl0 + ty / BRICK < L.tn[1]
                   && bzl0 + tz / BRICK < L.tn[2];
  const bool col_w = col && gj >= q.rms[2] && gj < q.rms[3]
                     && gk >= q.rms[4] && gk < q.rms[5];
  const bool col_eval = yz_eval(j, k);
  const int own = j * p.nz + k;
  const int oyz = q.rms[5] - q.rms[4];
  const int osx = (q.rms[3] - q.rms[2]) * oyz;
  const int oown = (gj - q.rms[2]) * oyz + (gk - q.rms[4]);   // col_w only
  const int wp = (ty + 2) * K6_PZ + tz + 2;       // own cell, phi ring
  const int wg = (ty + 1) * K6_GZ + tz + 1;       // own cell, g / cs rings
  // this thread's rim cell of the 1-rim frame (two rows of K6_GZ, then two
  // columns of K6_TY)
  int rwp = 0, rwg = 0;
  bool reval = false;
  if (tid < K6_RIM) {
    int ry, rz;
    if (tid < 2 * K6_GZ) {
      ry = tid < K6_GZ ? -1 : K6_TY;
      rz = tid % K6_GZ - 1;
    } else {
      const int r = tid - 2 * K6_GZ;
      ry = r % K6_TY;
      rz = r < K6_TY ? -1 : MARCH_TZ;
    }
    rwp = (ry + 2) * K6_PZ + rz + 2;
    rwg = (ry + 1) * K6_GZ + rz + 1;
    reval = yz_eval(y0 + ry, z0 + rz);
  }
  // the cells this thread copies into each ring plane: phi's 2-rim frame
  // and g's 1-rim frame, each laid out row-major over the block's threads
  int fo[2], go[2];
  bool fin[2], gin[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int e = tid + r * K6_NT;
    const int fj = y0 - 2 + e / K6_PZ, fk = z0 - 2 + e % K6_PZ;
    fin[r] = e < K6_PHI && fj >= 0 && fj < p.ny && fk >= 0 && fk < p.nz;
    fo[r] = fj * p.nz + fk;
    const int hj = y0 - 1 + e / K6_GZ, hk = z0 - 1 + e % K6_GZ;
    gin[r] = e < K6_G && hj >= 0 && hj < p.ny && hk >= 0 && hk < p.nz;
    go[r] = hj * p.nz + hk;
  }
  // plane i of phi and g into the rings (cells outside the array are never
  // read), one group per plane
  auto fetch = [&](int i, int top) {
    if (i >= 0 && i <= top) {
      const int slot = (i - q.c[0]) & (K6_RING - 1);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (fin[r])
          lsf::async_copy4(ring[slot] + tid + r * K6_NT, phi + i * sx + fo[r]);
        if (gin[r])
          lsf::async_copy4(gring[slot] + tid + r * K6_NT, g + i * sx + go[r]);
      }
    }
    lsf::async_commit();
  };
  // plane i evaluates on the x axis
  auto x_eval = [&](int i) {
    const int gi = q.o[0] + i;
    return gi >= 1 && gi <= q.g[0] - 2 && i >= 1 && i <= p.nx - 2;
  };
  // step i's evaluation: the own cell (returned) and, unless own_only, the
  // rim cell, their cs into cs plane csp; ring slots of planes i - 1, i,
  // i + 1
  auto eval = [&](int i, int sm, int s0, int sp, float* csp, bool own_only) {
    CellEval e{0.0f, 0.0f, 0.0f, 0.0f};
    const bool xe = x_eval(i);
    if (col_in) e.g = gring[s0][wg];
    if (xe && col_eval)
      e.cot_lap = cot_lap_at(ring[sm], ring[s0], ring[sp], gring[s0], wp, wg,
                             p, e.lap, e.cot_h1);
    if (!own_only) {
      csp[wg] = e.cot_lap * p.inv_dx2;
      if (tid < K6_RIM) {
        float lap, ch, cl = 0.0f;
        if (xe && reval)
          cl = cot_lap_at(ring[sm], ring[s0], ring[sp], gring[s0], rwp, rwg,
                          p, lap, ch);
        csp[rwg] = cl * p.inv_dx2;
      }
    }
    return e;
  };
  auto brick_on = [&](int bxl, int byl, int bzl) {
    return active == nullptr
           || active[((long long)(q.t0[0] + bxl) * q.nb[1] + q.t0[1] + byl)
                         * q.nb[2] + q.t0[2] + bzl] != 0;
  };
  auto slab_x0 = [&](int bxl) { return q.c[0] + (q.t0[0] + bxl) * BRICK; };
  // a slab evaluates when it has a plane in the array and one of the
  // column's bricks in the launch is active
  auto slab_live = [&](int bxl) {
    const int x0 = slab_x0(bxl);
    if (x0 + BRICK <= 0 || x0 >= p.nx) return false;
    if (active == nullptr) return true;
    bool any = false;
    for (int b = 0; b < BY * BZ; ++b) {
      const int byl = byl0 + b / BZ, bzl = bzl0 + b % BZ;
      if (byl < L.tn[1] && bzl < L.tn[2]) any |= brick_on(bxl, byl, bzl);
    }
    return any;
  };
  auto plane_w = [&](int i) {
    const int gi = q.o[0] + i;
    return col_w && gi >= q.rms[0] && gi < q.rms[1];
  };
  auto out_at = [&](int i) { return (q.o[0] + i - q.rms[0]) * osx + oown; };
  double* const parts[2] = {partials, partials + nbr};
  const int bxa = cx * L.chunk, bxb = min(bxa + L.chunk, L.tn[0]);
  for (int first = bxa; first < bxb;) {
    if (!slab_live(first)) {
      // every brick of the column frozen: g passes through, the slab's
      // loads all in flight at once
      const int x0 = slab_x0(first);
      float v[BRICK];
#pragma unroll
      for (int m = 0; m < BRICK; ++m) {
        const int i = x0 + m;
        v[m] = i >= 0 && i < p.nx && plane_w(i) ? __ldg(g + i * sx + own)
                                                 : 0.0f;
      }
#pragma unroll
      for (int m = 0; m < BRICK; ++m) {
        const int i = x0 + m;
        if (i >= 0 && i < p.nx && plane_w(i)) cot_phi[out_at(i)] = v[m] + 0.0f;
      }
      lsf::march_zero_partials<K6_TY>(partials, first, L, byl0, bzl0);
      lsf::march_zero_partials<K6_TY>(partials + nbr, first, L, byl0, bzl0);
      ++first;
      continue;
    }
    // a single dead slab between two live ones joins the run
    int last = first;
    while (last + 1 < bxb
           && (slab_live(last + 1) || (last + 2 < bxb && slab_live(last + 2))))
      ++last;
    const int xs = max(slab_x0(first), 0), xe = min(slab_x0(last + 1), p.nx);
    const int top = min(xe + 1, p.nx - 1);    // the last plane a step reads
    auto slot = [&](int i) { return (i - q.c[0]) & (K6_RING - 1); };
    __syncthreads();                  // the rings of the last run are free
    for (int i = xs - 2; i <= xs - 1 + K6_AHEAD; ++i) fetch(i, top);
    // planes xs - 1 (own cell only) and xs
    lsf::async_wait<K6_AHEAD - 1>();
    __syncthreads();
    fetch(xs + K6_AHEAD, top);
    const float csm0 = eval(xs - 1, slot(xs - 2), slot(xs - 1), slot(xs),
                            nullptr, true).cot_lap * p.inv_dx2;
    lsf::async_wait<K6_AHEAD - 1>();
    __syncthreads();
    fetch(xs + 1 + K6_AHEAD, top);
    CellEval cur = eval(xs, slot(xs - 1), slot(xs), slot(xs + 1),
                        cs[xs & 1], false);
    float csm = csm0;                         // cs of the plane before cur
    for (int sl = first; sl <= last; ++sl) {
      // one slab, its planes unrolled: plane x0 + m lies in ring slot m
      const int x0 = slab_x0(sl);
      const bool act = col && brick_on(sl, byl0 + ty / BRICK,
                                       bzl0 + tz / BRICK);
      const bool odd = x0 & 1;
      float vdx[BRICK], vh[BRICK];
#pragma unroll
      for (int m = 0; m < BRICK; ++m) {
        const int i = x0 + m;
        vdx[m] = 0.0f;
        vh[m] = 0.0f;
        if (i < xs || i >= xe) continue;      // uniform over the block
        lsf::async_wait<K6_AHEAD - 1>();      // planes i .. i + 2
        __syncthreads();
        fetch(i + 2 + K6_AHEAD, top);         // into plane i - 1's slot
        // plane i + 1 into cs plane (i + 1) & 1, then plane i's gather
        float* csn = cs[(m + 1 + odd) & 1];
        const float* csc = cs[(m + odd) & 1];
        const CellEval nxt = eval(i + 1, m, (m + 1) % K6_RING,
                                  (m + 2) % K6_RING, csn, false);
        if (plane_w(i)) {
          float r = cur.g + 0.0f;             // frozen: passthrough
          if (act) {
            const float csp = nxt.cot_lap * p.inv_dx2;
            float acc = cur.g - (6.0f * p.inv_dx2) * cur.cot_lap;
            acc = acc + csp;                                  // x+
            acc = acc + csm;                                  // x-
            acc = acc + csc[wg + K6_GZ];                      // y+
            acc = acc + csc[wg - K6_GZ];                      // y-
            acc = acc + csc[wg - 1];                          // z-
            acc = acc + csc[wg + 1];                          // z+
            r = acc;
            vdx[m] = cur.cot_lap * cur.lap;
            vh[m] = cur.cot_h1;
          }
          cot_phi[out_at(i)] = r;
        }
        csm = cur.cot_lap * p.inv_dx2;
        cur = nxt;
      }
      // both sums' trees behind one barrier; red's last readers (the
      // last slab's trees) are done: a plane's barrier came since
      double dd[BRICK], xt[2];
#pragma unroll
      for (int m = 0; m < BRICK; ++m) dd[m] = (double)vdx[m];
      xt[0] = lsf::x_tree(dd);
#pragma unroll
      for (int m = 0; m < BRICK; ++m) dd[m] = (double)vh[m];
      xt[1] = lsf::x_tree(dd);
      lsf::march_brick_partials<K6_TY, 2>(xt, red, parts, sl, L, byl0, bzl0);
    }
    lsf::async_wait<0>();
    first = last + 1;
  }
  if (!lsf::march_last(ticket, gridDim.x * gridDim.y * L.nchunk)) return;
  double sv[2];
  lsf::ordered_sums<2>(partials, nbr, red, sv);
  if (tid == 0) {
    // cot_dx = -2/dx times its sum; with accumulate, added to the running
    // totals as a caller adds each step's (total + step)
    const double cdx = scale * sv[0];
    sums[0] = accumulate ? sums[0] + cdx : cdx;
    sums[1] = accumulate ? sums[1] + sv[1] : sv[1];
    *ticket = 0u;
  }
}

int launch_minmax_bwd(const void* phi, const void* g, void* cot_phi,
                      const MinmaxBwdParams& p, const int* geom,
                      const void* active, void* partials, void* sums,
                      void* ticket, int accumulate, double scale,
                      void* stream) {
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t attr = lsf::allow_dynamic_smem(
      (const void*)minmax_bwd_march_kernel, K6_SMEM, smem_set);
  if (attr != cudaSuccess) return (int)attr;
  const lsf::BlockGeom q = lsf::block_geom(geom);
  lsf::MarchLaunch L = lsf::march_launch(
      geom + 21, K6_TY, 1,
      lsf::march_slots((const void*)minmax_bwd_march_kernel, K6_NT, K6_SMEM),
      2);
  if (active != nullptr && L.chunk > K6_BANDED_CHUNK) {
    L.chunk = K6_BANDED_CHUNK;
    L.nchunk = (L.tn[0] + L.chunk - 1) / L.chunk;
  }
  minmax_bwd_march_kernel<<<lsf::march_grid(L, K6_TY, 1), K6_NT, K6_SMEM,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(phi), static_cast<const float*>(g),
      static_cast<float*>(cot_phi), p, q, L, static_cast<const int*>(active),
      static_cast<double*>(partials), static_cast<double*>(sums),
      static_cast<unsigned*>(ticket), accumulate, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Solo grid, dense (active == nullptr) or banded.  partials: 2 x the brick
// grid's doubles; sums: (cot_dx, cot_h1), written, or added to with
// accumulate; ticket: one zeroed unsigned (left zeroed); scale: -2/dx.
extern "C" int lsf_minmax_bwd_f32(const void* phi, const void* g,
                                  void* cot_phi, int nx, int ny, int nz,
                                  float h1, float inv_dx2, float band_dx,
                                  float threshold, const void* active,
                                  void* partials, void* sums, void* ticket,
                                  int accumulate, double scale,
                                  void* stream) {
  const MinmaxBwdParams p{nx, ny, nz, h1, inv_dx2, band_dx, threshold};
  int geom[lsf::BLOCK_GEOM_INTS];
  lsf::solo_geom(nx, ny, nz, geom);
  return launch_minmax_bwd(phi, g, cot_phi, p, geom, active, partials, sums,
                           ticket, accumulate, scale, stream);
}

// Block mode: geom: BLOCK_GEOM_INTS host ints; nx, ny, nz: the padded
// array's dimensions (the owned box and 2 cells around it inside the
// global grid); cot_phi has the owned box's shape.
extern "C" int lsf_minmax_bwd_block_f32(const void* phi, const void* g,
                                        void* cot_phi, int nx, int ny, int nz,
                                        const int* geom, float h1,
                                        float inv_dx2, float band_dx,
                                        float threshold, void* partials,
                                        void* sums, void* ticket,
                                        int accumulate, double scale,
                                        void* stream) {
  const MinmaxBwdParams p{nx, ny, nz, h1, inv_dx2, band_dx, threshold};
  return launch_minmax_bwd(phi, g, cot_phi, p, geom, nullptr, partials, sums,
                           ticket, accumulate, scale, stream);
}
