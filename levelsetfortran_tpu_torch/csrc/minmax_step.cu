// Kernels K3 and K4: min/max curvature-flow Euler steps.
//
// K3 replaces levelsetfortran_tpu/ops/minmax_pallas.py:minmax_step_padded
// (body _make_kernel), its pack mode that function's `pack=B` (B
// geometries per launch, each with its own h1 and sum); K4 replaces
// minmax_fusedk_padded (body _make_fusedk_kernel).  One step, per cell:
//   sum6 = x- + x+ + y- + y+ + z+ + z-     (this order)
//   lap  = (sum6 - 6 c) / dx^2,  pave = (sum6 + c) / 7
//   F    = min(lap, 0) if pave < threshold else max(lap, 0)
//   c   += h1 F   where |c| < band_radius dx, on the interior only.
// Face rule: face cells never update and the +-1 reads of an interior cell
// never leave the grid, so neither the TPU kernel's edge clamp nor the jnp
// path's wrap is needed here: nothing outside the grid is ever read.
//
// K4 runs K <= 4 steps in one pass.  Both kernels call the same
// minmax_update(), and the library is built with --fmad=false, so K4 is
// bitwise equal to K launches of K3, its fused sum (the last step's) too.
//
// What bounds it on the H100: bytes.  K3 does ~15 float operations per
// cell against 8 bytes of device-memory traffic; K4 moves the same 8 bytes
// for K steps.  The first port gave K4 one 8^3 brick per block widened by
// K on every side: 4,096 loads for 512 cells at K = 4, 5,984 updates (2.9x
// four K3 steps), a runtime divide per update and 36 KB of shared memory,
// so four fused steps took as long as four K3 launches.  The wavefront
// below widens a 16 x 32 column by K in y and z only and walks x once: at
// K = 4 it reads 1.9x the owned cells (through L2) and makes 1.4x the
// updates of four K3 steps, from per-thread cell indices fixed for the
// walk, with one barrier per plane.
//
// K3 walks x too (minmax_march_kernel, below): a brick per block would
// give each warp four 32-byte z rows, 7 loads per cell through L1 over a
// 1.95x halo and a 10-barrier tree per 512 cells.  The march reads one
// 128-byte row per warp and plane, each cell once (plus a 20% y/z rim
// through L2), its planes prefetched by cp.async into a shared ring (a
// prefetch held in registers stalls the walk's register moves), one
// barrier per plane, the brick trees in registers and shuffles, and the
// sum finished by the launch's last block.  A kernel of its own, simpler
// than minmax_fusedk_kernel<1> (whose level-0 plane goes through shared
// memory in x too); every mode is a layout of the same walk (common.cuh).
//
// The narrow band skips whole inactive bricks: `active` holds one int32
// per brick; an inactive brick copies its cells (copy_inactive, the mint
// step) or writes nothing (the ping-pong buffer already holds its values),
// and writes a zero partial.  The update gate is the cell's own value, so a
// brick with no in-band cell can never change: the banded solve equals the
// dense one bitwise, and K3 and K4 skip the runs of slabs whose bricks are
// all frozen.
//
// Pack mode (the TPU kernel's `pack=B`): B same-shape geometries stacked
// (B, nx, ny, nz), geometry b on the blocks b * nchunk .. of the launch's
// z axis with its own h1 (the device vector h1s), its partials in the solo
// brick order, geometry-major, and its own sum; a frozen geometry (live[b]
// == 0) copies its cells and writes zero partials.
//
// Block mode (the TPU kernel's `offsets`): the tensor is one shard's block
// of a domain-decomposed grid with a halo of one neighbour cell on its
// sharded axes (the TPU's wider aprons are layout, not math).  The face
// rule and the fused sum's box are in global coordinates (origin + local
// index, all three axes); a cell updates only where its +-1 reads stay
// inside the array, which every owned cell's do; a frozen brick copies its
// cells.  Same minmax_update() in every mode, so a block's cells equal the
// solo kernel's on the whole grid bit for bit.  K4's block mode
// (minmax_fusedk_padded's `offsets`) is the same record on K4's wavefront:
// with a halo of K cells on the sharded axes the owned cells take the
// global grid's K steps bitwise.
#include <algorithm>

#include "async_copy.cuh"
#include "common.cuh"

namespace {

using lsf::BRICK;

struct MinmaxParams {
  int nx, ny, nz;
  float h1, inv_dx2, band_dx, threshold;
};

__device__ __forceinline__ float minmax_update(float c, float xm, float xp,
                                               float ym, float yp, float zp,
                                               float zm,
                                               const MinmaxParams& p) {
  const float sum6 = ((((xm + xp) + ym) + yp) + zp) + zm;
  const float lap = (sum6 - 6.0f * c) * p.inv_dx2;
  const float pave = (sum6 + c) * (1.0f / 7.0f);
  const float f = pave < p.threshold ? fminf(lap, 0.0f) : fmaxf(lap, 0.0f);
  return c + p.h1 * f;
}

// K3's march (every mode: dense, banded, pack, block).  A block owns a
// K3_TY x MARCH_TZ column of cells of one geometry (common.cuh) and a chunk
// of x-slabs, split into runs of live slabs as K4 splits them; it walks x
// one plane per step.  The planes (the column and a one-cell y/z rim) are
// prefetched K3_AHEAD steps ahead into a shared ring by asynchronous copies
// (async_copy.cuh): no load waits in a register, one barrier per plane.
// Per cell, in the frame of q:
//   steps  = global interior && array interior && |c| < band_dx && the
//            brick active (the dense rule with the whole-grid record);
//   write  = the cell is in the launch's bricks and the array, and its
//            brick is active or copy_inactive (block mode: always);
//   counts = in q's rms box (the whole grid for a solo launch).
// A slab with no active brick in the column is copied (copy_inactive) or
// skipped, with zero partials; a frozen geometry of a pack copies every
// slab.  The partials take block_sum's tree per brick and the last block
// of each group adds them in reduce_partials's order.
constexpr int K3_TY = 16, K3_NT = K3_TY * lsf::MARCH_TZ;
constexpr int K3_PZ = lsf::MARCH_TZ + 2, K3_PLANE = (K3_TY + 2) * K3_PZ;
constexpr int K3_RIM = 2 * K3_PZ + 2 * K3_TY;            // rim cells a plane
constexpr int K3_RING = 8;                               // planes in shared
constexpr int K3_AHEAD = 5;     // plane i + 1 + K3_AHEAD is copied at step i

__global__ void __launch_bounds__(K3_NT, 2)
minmax_march_kernel(const float* __restrict__ phi, float* __restrict__ out,
                    MinmaxParams p, lsf::BlockGeom q, lsf::MarchLaunch L,
                    const float* __restrict__ h1s,
                    const int* __restrict__ live,
                    const int* __restrict__ active, int copy_inactive,
                    double* __restrict__ partials, double* __restrict__ dsq,
                    unsigned* __restrict__ tickets) {
  constexpr int BY = K3_TY / BRICK, BZ = lsf::MARCH_TZ / BRICK;
  __shared__ double red[1024];
  __shared__ float ring[K3_RING][K3_PLANE];
  const int tid = threadIdx.x;
  const int ty = tid / lsf::MARCH_TZ, tz = tid % lsf::MARCH_TZ;
  const int grp = blockIdx.z / L.nchunk;
  const int cx = blockIdx.z - grp * L.nchunk;
  const int sx = p.ny * p.nz;                 // a geometry has < 2^31 cells
  phi += (long long)grp * sx * p.nx;
  out += (long long)grp * sx * p.nx;
  const long long nbr = (long long)L.tn[0] * L.tn[1] * L.tn[2];
  double* part = partials == nullptr ? nullptr : partials + grp * nbr;
  const bool glive = live == nullptr || live[grp] != 0;
  MinmaxParams pp = p;
  if (h1s != nullptr) pp.h1 = h1s[grp];
  const int byl0 = blockIdx.y * BY, bzl0 = blockIdx.x * BZ;
  const int y0 = q.c[1] + (q.t0[1] + byl0) * BRICK;
  const int z0 = q.c[2] + (q.t0[2] + bzl0) * BRICK;
  const int j = y0 + ty, k = z0 + tz;
  const bool col_in = j >= 0 && j < p.ny && k >= 0 && k < p.nz;
  const bool col = col_in && byl0 + ty / BRICK < L.tn[1]
                   && bzl0 + tz / BRICK < L.tn[2];
  const int gj = q.o[1] + j, gk = q.o[2] + k;
  const bool col_steps = gj >= 1 && gj <= q.g[1] - 2 && gk >= 1
                         && gk <= q.g[2] - 2 && j >= 1 && j <= p.ny - 2
                         && k >= 1 && k <= p.nz - 2;
  const bool col_box = col && gj >= q.rms[2] && gj < q.rms[3]
                       && gk >= q.rms[4] && gk < q.rms[5];
  const int own = j * p.nz + k;
  const int ow = (ty + 1) * K3_PZ + tz + 1;
  // this thread's rim cell (two rows of K3_PZ, then two columns of K3_TY)
  int rw = 0, roff = 0;
  bool rin = false;
  if (tid < K3_RIM) {
    int ry, rz;
    if (tid < 2 * K3_PZ) {
      ry = tid < K3_PZ ? -1 : K3_TY;
      rz = tid % K3_PZ - 1;
    } else {
      const int r = tid - 2 * K3_PZ;
      ry = r % K3_TY;
      rz = r < K3_TY ? -1 : lsf::MARCH_TZ;
    }
    rw = (ry + 1) * K3_PZ + rz + 1;
    const int jr = y0 + ry, kr = z0 + rz;
    rin = jr >= 0 && jr < p.ny && kr >= 0 && kr < p.nz;
    roff = jr * p.nz + kr;
  }
  // plane i of the column and its rim into the ring (cells outside the
  // array are never read), one group per plane
  auto fetch = [&](int i, int last) {
    if (i >= 0 && i <= last) {
      float* pl = ring[(i - q.c[0]) & (K3_RING - 1)];
      if (col_in) lsf::async_copy4(pl + ow, phi + i * sx + own);
      if (rin) lsf::async_copy4(pl + rw, phi + i * sx + roff);
    }
    lsf::async_commit();
  };
  auto brick_on = [&](int bxl, int byl, int bzl) {
    return active == nullptr
           || active[((long long)(q.t0[0] + bxl) * q.nb[1] + q.t0[1] + byl)
                         * q.nb[2] + q.t0[2] + bzl] != 0;
  };
  auto slab_x0 = [&](int bxl) { return q.c[0] + (q.t0[0] + bxl) * BRICK; };
  // a slab steps when its geometry does, it has a plane in the array and
  // one of the column's bricks in the launch is active
  auto slab_live = [&](int bxl) {
    const int x0 = slab_x0(bxl);
    if (!glive || x0 + BRICK <= 0 || x0 >= p.nx) return false;
    if (active == nullptr) return true;
    bool any = false;
    for (int b = 0; b < BY * BZ; ++b) {
      const int byl = byl0 + b / BZ, bzl = bzl0 + b % BZ;
      if (byl < L.tn[1] && bzl < L.tn[2]) any |= brick_on(bxl, byl, bzl);
    }
    return any;
  };
  const bool copy = copy_inactive || !glive;
  const int bxa = cx * L.chunk, bxb = min(bxa + L.chunk, L.tn[0]);
  for (int first = bxa; first < bxb;) {
    if (!slab_live(first)) {
      const int x0 = slab_x0(first);
      if (copy && col)
        for (int i = max(x0, 0); i < min(x0 + BRICK, p.nx); ++i)
          out[i * sx + own] = phi[i * sx + own];
      if (part != nullptr)
        lsf::march_zero_partials<K3_TY>(part, first, L, byl0, bzl0);
      ++first;
      continue;
    }
    // a single dead slab between two live ones joins the run
    int last = first;
    while (last + 1 < bxb
           && (slab_live(last + 1) || (last + 2 < bxb && slab_live(last + 2))))
      ++last;
    const int xs = max(slab_x0(first), 0), xe = min(slab_x0(last + 1), p.nx);
    const int top = min(xe, p.nx - 1);        // the last plane a step reads
    __syncthreads();                  // the ring of the last run is free
    for (int i = xs - 1; i <= xs + K3_AHEAD; ++i) fetch(i, top);
    for (int sl = first; sl <= last; ++sl) {
      // one slab, its planes unrolled: plane x0 + m lies in ring slot m
      const int x0 = slab_x0(sl);
      const bool act = col && brick_on(sl, byl0 + ty / BRICK,
                                       bzl0 + tz / BRICK);
      float dq[BRICK];
#pragma unroll
      for (int m = 0; m < BRICK; ++m) {
        const int i = x0 + m;
        dq[m] = 0.0f;
        if (i < xs || i >= xe) continue;      // uniform over the block
        lsf::async_wait<K3_AHEAD - 1>();      // planes i - 1 .. i + 1
        __syncthreads();
        fetch(i + 1 + K3_AHEAD, top);         // into plane i - 2's slot
        const float* pb = ring[m];
        const float c = pb[ow];
        const int gi = q.o[0] + i;
        const bool plane_steps = gi >= 1 && gi <= q.g[0] - 2 && i >= 1
                                 && i <= p.nx - 2;
        float r = c;
        if (act && col_steps && plane_steps && fabsf(c) < p.band_dx)
          r = minmax_update(c, ring[(m + K3_RING - 1) % K3_RING][ow],
                            ring[(m + 1) % K3_RING][ow], pb[ow - K3_PZ],
                            pb[ow + K3_PZ], pb[ow + 1], pb[ow - 1], pp);
        if (col && (act || copy_inactive)) out[i * sx + own] = r;
        if (col_box && gi >= q.rms[0] && gi < q.rms[1]) dq[m] = r - c;
      }
      if (part != nullptr)
        lsf::march_partials<K3_TY>(dq, red, part, sl, L, byl0, bzl0);
    }
    lsf::async_wait<0>();
    first = last + 1;
  }
  if (part != nullptr)
    lsf::march_finish(part, nbr, dsq + grp, tickets + grp,
                      gridDim.x * gridDim.y * L.nchunk, red);
}

// K4's wavefront.  A block owns a (FK_TY x FK_TZ) column of cells and a
// run of x-slabs (whole bricks); it walks x one plane per step.  Level 0 is
// phi; level s is level s-1 after one more step.  At step t the block loads
// level-0 plane t and computes level s at plane t - 2s (s = 1..K), whose
// three input planes t-2s-1 .. t-2s+1 of level s-1 were done by step t-1:
// one barrier per step, and a ring of 4 planes per level (the planes read
// and the one being written are 4 consecutive ones).  Each plane is the
// column widened by K cells in y and z; level s is computed on the column
// widened by K - s, so level K is the owned column, and in x a run reads K
// planes beyond each end (none past the array: an array face plane never
// changes).  The x-tree of lsf::block_sum (x-planes i with i+4, i+2, i+1)
// runs in each thread's registers over the 8 planes of a brick, the y- and
// z-trees in shared memory and shuffles once the brick's last plane is
// done, so the partial is the K3 launch's bitwise.
//
// Everything is in the BlockGeom frame (common.cuh), as K3's march: the
// dense and banded modes are the whole-grid record (solo_geom); the block
// mode (BLOCK, the TPU kernel's `offsets`) is one shard's padded block, its
// brick grid (the launch's columns and slabs) over the owned cells, a cell
// stepping only where it is interior in the array AND in the global grid,
// the fused sum counting the record's global box.  With a halo of K cells
// on the sharded axes, the K levels of an owned cell read only cells of the
// array, so they equal the global grid's K steps bit for bit.  The solo
// instantiation (BLOCK false) folds the record's global terms away (read
// at run time they cost the dense walk 16-18% of its device time on an
// H100 80GB HBM3 at 700 W); what is left of the frame still costs it 4-8%
// (spills at the walk's 64 registers: 32 bytes at K = 4 against 16).
constexpr int FK_TY = 16, FK_TZ = 32, FK_NT = FK_TY * FK_TZ;

template <int K>
constexpr int fk_plane() { return (FK_TY + 2 * K) * (FK_TZ + 2 * K); }

template <int K>
constexpr size_t fk_smem() {
  return sizeof(float) * K * 4 * fk_plane<K>() + sizeof(double) * FK_NT;
}

// Whether x-slab bx of the block's column holds an active brick.
__device__ __forceinline__ bool slab_live(const int* __restrict__ active,
                                          int bx, int by0, int bz0, int nby,
                                          int nbz) {
  if (active == nullptr) return true;
  bool live = false;
  for (int b = 0; b < (FK_TY / BRICK) * (FK_TZ / BRICK); ++b) {
    const int by = by0 + b / (FK_TZ / BRICK), bz = bz0 + b % (FK_TZ / BRICK);
    if (by < nby && bz < nbz)
      live |= active[((long long)bx * nby + by) * nbz + bz] != 0;
  }
  return live;
}

template <int K, bool BLOCK>
__global__ void __launch_bounds__(FK_NT, 2)
minmax_fusedk_kernel(const float* __restrict__ phi, float* __restrict__ out,
                     MinmaxParams p, lsf::BlockGeom q,
                     const int* __restrict__ active, int copy_inactive,
                     double* __restrict__ partials, int chunk) {
  constexpr int EY = FK_TY + 2 * K, EZ = FK_TZ + 2 * K, P = EY * EZ;
  constexpr int NB = (FK_TY / BRICK) * (FK_TZ / BRICK);   // bricks per slab
  constexpr int NL = (P + FK_NT - 1) / FK_NT;     // level-0 cells a thread
  constexpr int NC = ((EY - 2) * (EZ - 2) + FK_NT - 1) / FK_NT;  // level >= 1
  constexpr int NS = K > 1 ? K - 1 : 1;
  extern __shared__ double fk_shared[];
  double* red = fk_shared;                                // FK_NT
  float* ring = reinterpret_cast<float*>(fk_shared + FK_NT);  // [K][4][P]
  const int tid = threadIdx.x;
  const int ty = tid / FK_TZ, tz = tid % FK_TZ;
  const int nbx = q.nb[0], nby = q.nb[1], nbz = q.nb[2];
  const int cx = BLOCK ? q.c[0] : 0;           // brick (0, 0, 0) in the array
  const int by0 = blockIdx.y * (FK_TY / BRICK);
  const int bz0 = blockIdx.x * (FK_TZ / BRICK);
  const int y0 = (BLOCK ? q.c[1] : 0) + by0 * BRICK;
  const int z0 = (BLOCK ? q.c[2] : 0) + bz0 * BRICK;
  const int bx0 = blockIdx.z * chunk, bx1 = min(bx0 + chunk, nbx);
  const long long sy = p.nz, sx = (long long)p.ny * p.nz;
  // a cell steps where it is interior in the array and, in the block mode,
  // in the global grid
  const int nx = p.nx, ny = p.ny, nz = p.nz;
  const int ox = q.o[0], oy = q.o[1], oz = q.o[2];
  const int gx = q.g[0], gy = q.g[1], gz = q.g[2];
  auto x_ok = [=](int i) {
    return i >= 1 && i <= nx - 2
           && (!BLOCK || (ox + i >= 1 && ox + i <= gx - 2));
  };
  auto y_ok = [=](int j) {
    return j >= 1 && j <= ny - 2
           && (!BLOCK || (oy + j >= 1 && oy + j <= gy - 2));
  };
  auto z_ok = [=](int k) {
    return k >= 1 && k <= nz - 2
           && (!BLOCK || (oz + k >= 1 && oz + k <= gz - 2));
  };
  const int j = y0 + ty, k = z0 + tz;                     // owned column
  const bool col_in = j < p.ny && k < p.nz
                      && (!BLOCK || (j >= 0 && k >= 0
                                     && by0 + ty / BRICK < nby
                                     && bz0 + tz / BRICK < nbz));
  const bool col_box = col_in
                       && (!BLOCK || (q.o[1] + j >= q.rms[2]
                                      && q.o[1] + j < q.rms[3]
                                      && q.o[2] + k >= q.rms[4]
                                      && q.o[2] + k < q.rms[5]));

  // this thread's cells of each level, fixed for the whole walk: level 0
  // (the loads), levels 1 .. K-1 (the widened columns), level K (owned)
  long long goff[NL];
  bool gin[NL];
#pragma unroll
  for (int r = 0; r < NL; ++r) {
    const int c = tid + r * FK_NT;
    const int gj = y0 - K + c / EZ, gk = z0 - K + c % EZ;
    gin[r] = c < P && gj >= 0 && gj < p.ny && gk >= 0 && gk < p.nz;
    goff[r] = gj * sy + gk;
  }
  int lw[NS][NC];
  bool lin[NS][NC], lok[NS][NC];
#pragma unroll
  for (int s = 1; s < K; ++s) {
    const int rz = EZ - 2 * s, n = (EY - 2 * s) * rz;
#pragma unroll
    for (int r = 0; r < NC; ++r) {
      const int c = tid + r * FK_NT;
      const int wy = s + c / rz, wz = s + c % rz;
      lw[s - 1][r] = wy * EZ + wz;
      lin[s - 1][r] = c < n;
      lok[s - 1][r] = y_ok(y0 - K + wy) && z_ok(z0 - K + wz);
    }
  }
  const int ow = (K + ty) * EZ + K + tz;
  const bool own_ok = y_ok(j) && z_ok(k);
  const long long own_off = j * sy + k;
  auto slab_x0 = [=](int bx) { return cx + bx * BRICK; };

  // the chunk in runs of live slabs (a single dead slab between two live
  // ones joins the run: sweeping it costs 8 steps, a restart 3K); a dead
  // slab outside every run has only frozen bricks: copied under mint, zero
  // sums
  auto live = [&](int bx) {
    return slab_live(active, bx, by0, bz0, nby, nbz);
  };
  for (int first = bx0; first < bx1;) {
    if (!live(first)) {
      if (copy_inactive && col_in)
        for (int i = max(slab_x0(first), 0);
             i < min(slab_x0(first) + BRICK, p.nx); ++i)
          out[i * sx + own_off] = phi[i * sx + own_off];
      if (partials != nullptr && tid < NB) {
        const int by = by0 + tid / (FK_TZ / BRICK);
        const int bz = bz0 + tid % (FK_TZ / BRICK);
        if (by < nby && bz < nbz)
          partials[((long long)first * nby + by) * nbz + bz] = 0.0;
      }
      ++first;
      continue;
    }
    int last = first;
    while (last + 1 < bx1
           && (live(last + 1) || (last + 2 < bx1 && live(last + 2))))
      ++last;
    const int xs = max(slab_x0(first), 0);
    const int xe = min(slab_x0(last + 1), p.nx);
    const int xr = max(xs - K, 0);             // first plane loaded
    const int xl = min(xe + K, p.nx);          // end of the planes loaded
    float dq[BRICK];                           // last-step changes, this brick
#pragma unroll
    for (int m = 0; m < BRICK; ++m) dq[m] = 0.0f;

    for (int t = xr; t <= xe - 1 + 2 * K; ++t) {
      // level 0, plane t: loaded now, stored after this step's compute
      float v[NL];
      const bool load = t < xl;
#pragma unroll
      for (int r = 0; r < NL; ++r)
        v[r] = load && gin[r] ? __ldg(phi + t * sx + goff[r]) : 0.0f;
      // levels 1 .. K-1 into their rings
#pragma unroll
      for (int s = 1; s < K; ++s) {
        const int pl = t - 2 * s;
        const int lo = xr == 0 ? 0 : xr + s;
        const int hi = xl == p.nx ? p.nx - 1 : xl - 1 - s;
        if (pl < lo || pl > hi) continue;      // uniform over the block
        const bool iok = x_ok(pl);
        const float* src = ring + (s - 1) * 4 * P;
        const float* bm = src + ((pl + 3) & 3) * P;
        const float* b0 = src + (pl & 3) * P;
        const float* bp = src + ((pl + 1) & 3) * P;
        float* dst = ring + s * 4 * P + (pl & 3) * P;
#pragma unroll
        for (int r = 0; r < NC; ++r) {
          if (!lin[s - 1][r]) continue;
          const int w = lw[s - 1][r];
          const float c = b0[w];
          float u = c;
          if (iok && lok[s - 1][r] && fabsf(c) < p.band_dx)
            u = minmax_update(c, bm[w], bp[w], b0[w - EZ], b0[w + EZ],
                              b0[w + 1], b0[w - 1], p);
          dst[w] = u;
        }
      }
      // level K at plane t - 2K: the owned column's cells
      const int pl = t - 2 * K;
      if (pl >= xs && pl < xe) {
        const float* src = ring + (K - 1) * 4 * P;
        const float* b0 = src + (pl & 3) * P;
        const float c = b0[ow];
        float r = c;
        if (x_ok(pl) && own_ok && fabsf(c) < p.band_dx)
          r = minmax_update(c, src[((pl + 3) & 3) * P + ow],
                            src[((pl + 1) & 3) * P + ow], b0[ow - EZ],
                            b0[ow + EZ], b0[ow + 1], b0[ow - 1], p);
        const int lp = pl - cx;                // plane in the brick grid
        const int bx = lp / BRICK, m_pl = lp & (BRICK - 1);
        const bool act = active == nullptr
            || (col_in && active[((long long)bx * nby + by0 + ty / BRICK)
                                     * nbz + bz0 + tz / BRICK] != 0);
        if (col_in) {
          const long long idx = pl * sx + own_off;
          if (act) out[idx] = r;
          else if (copy_inactive) out[idx] = phi[idx];
        }
        const bool x_box = !BLOCK || (q.o[0] + pl >= q.rms[0]
                                      && q.o[0] + pl < q.rms[1]);
        const float d = col_box && x_box ? r - c : 0.0f;
#pragma unroll
        for (int m = 0; m < BRICK; ++m)
          if (m_pl == m) dq[m] = d;
        if (partials != nullptr && (m_pl == BRICK - 1 || pl == xe - 1)) {
          // the brick's last plane: its 512 changes in block_sum's tree
          double dd[BRICK];
#pragma unroll
          for (int m = 0; m < BRICK; ++m)
            dd[m] = (double)dq[m] * (double)dq[m];
          red[tid] = ((dd[0] + dd[4]) + (dd[2] + dd[6]))
                     + ((dd[1] + dd[5]) + (dd[3] + dd[7]));
          __syncthreads();
          if (tid < NB * BRICK) {
            const int b = tid / BRICK, zi = tid % BRICK;
            const int ly = (b / (FK_TZ / BRICK)) * BRICK;
            const int lz = (b % (FK_TZ / BRICK)) * BRICK + zi;
            double u[BRICK];
#pragma unroll
            for (int yi = 0; yi < BRICK; ++yi)
              u[yi] = red[(ly + yi) * FK_TZ + lz];
            double a = ((u[0] + u[4]) + (u[2] + u[6]))
                       + ((u[1] + u[5]) + (u[3] + u[7]));
            a += __shfl_down_sync(0xffffffffu, a, 4);
            a += __shfl_down_sync(0xffffffffu, a, 2);
            a += __shfl_down_sync(0xffffffffu, a, 1);
            const int by = by0 + b / (FK_TZ / BRICK);
            const int bz = bz0 + b % (FK_TZ / BRICK);
            if (zi == 0 && by < nby && bz < nbz) {
              const long long brick = ((long long)bx * nby + by) * nbz + bz;
              partials[brick] =
                  active == nullptr || active[brick] != 0 ? a : 0.0;
            }
          }
        }
        if (m_pl == BRICK - 1) {
#pragma unroll
          for (int m = 0; m < BRICK; ++m) dq[m] = 0.0f;
        }
      }
      if (load) {
        float* dst = ring + (t & 3) * P;
#pragma unroll
        for (int r = 0; r < NL; ++r)
          if (tid + r * FK_NT < P) dst[tid + r * FK_NT] = v[r];
      }
      __syncthreads();
    }
    first = last + 1;
  }
}

}  // namespace

namespace {

// One K3 launch over `batch` geometries laid out by the host record geom.
int launch_minmax_march(const void* phi, void* out, int batch,
                        const MinmaxParams& p, const int* geom,
                        const void* h1s, const void* live, const void* active,
                        int copy_inactive, void* partials, void* dsq,
                        void* tickets, void* stream) {
  const lsf::BlockGeom q = lsf::block_geom(geom);
  const lsf::MarchLaunch L = lsf::march_launch(
      geom + 21, K3_TY, batch,
      lsf::march_slots((const void*)minmax_march_kernel, K3_NT, 0), 2);
  minmax_march_kernel<<<lsf::march_grid(L, K3_TY, batch), K3_NT, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(phi), static_cast<float*>(out), p, q, L,
      static_cast<const float*>(h1s), static_cast<const int*>(live),
      static_cast<const int*>(active), copy_inactive,
      static_cast<double*>(partials), static_cast<double*>(dsq),
      static_cast<unsigned*>(tickets));
  return (int)cudaGetLastError();
}

}  // namespace

// tickets: one zeroed unsigned per geometry (the fused sum's tickets; each
// launch leaves them zeroed), read only with partials.
extern "C" int lsf_minmax_step_f32(const void* phi, void* out, int nx,
                                   int ny, int nz, float h1, float inv_dx2,
                                   float band_dx, float threshold,
                                   const void* active, int copy_inactive,
                                   void* partials, void* dsq, void* tickets,
                                   void* stream) {
  int geom[lsf::BLOCK_GEOM_INTS];
  lsf::solo_geom(nx, ny, nz, geom);
  return launch_minmax_march(
      phi, out, 1, MinmaxParams{nx, ny, nz, h1, inv_dx2, band_dx, threshold},
      geom, nullptr, nullptr, active, copy_inactive, partials, dsq, tickets,
      stream);
}

extern "C" int lsf_minmax_step_packed_f32(const void* phi, void* out,
                                          int batch, int nx, int ny, int nz,
                                          const void* h1s, float inv_dx2,
                                          float band_dx, float threshold,
                                          const void* live, void* partials,
                                          void* dsq, void* tickets,
                                          void* stream) {
  int geom[lsf::BLOCK_GEOM_INTS];
  lsf::solo_geom(nx, ny, nz, geom);
  return launch_minmax_march(
      phi, out, batch,
      MinmaxParams{nx, ny, nz, 0.0f, inv_dx2, band_dx, threshold}, geom, h1s,
      live, nullptr, 0, partials, dsq, tickets, stream);
}

namespace {

template <int K, bool BLOCK>
int launch_fusedk(const float* in, float* o, const MinmaxParams& p,
                  const lsf::BlockGeom& q, const int* act, int copy_inactive,
                  double* part, cudaStream_t st) {
  constexpr size_t smem = fk_smem<K>();
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t attr = lsf::allow_dynamic_smem(
      (const void*)minmax_fusedk_kernel<K, BLOCK>, smem, smem_set);
  if (attr != cudaSuccess) return (int)attr;
  // x-slabs per block: the count that minimises waves x steps a block
  // walks (8 per slab and 3K more for a run's ends), the waves counted over
  // the card's resident blocks
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, minmax_fusedk_kernel<K, BLOCK>, FK_NT, smem);
  const long long slots = std::max(1LL, (long long)sms * per_sm);
  const int nbx = q.nb[0];
  const int gy = (q.nb[1] + FK_TY / BRICK - 1) / (FK_TY / BRICK);
  const int gz = (q.nb[2] + FK_TZ / BRICK - 1) / (FK_TZ / BRICK);
  const long long cols = (long long)gy * gz;
  int chunk = nbx;
  long long best = -1;
  for (int c = 1; c <= nbx; ++c) {
    const long long waves = ((nbx + c - 1) / c * cols + slots - 1) / slots;
    const long long cost = waves * (BRICK * c + 3 * K);
    if (best < 0 || cost < best) {
      best = cost;
      chunk = c;
    }
  }
  const dim3 grid(gz, gy, (nbx + chunk - 1) / chunk);
  minmax_fusedk_kernel<K, BLOCK><<<grid, FK_NT, smem, st>>>(
      in, o, p, q, act, copy_inactive, part, chunk);
  return (int)cudaGetLastError();
}

// One K4 launch laid out by the host record geom (its whole brick grid),
// then the fused sum's second pass.
template <bool BLOCK>
int launch_fusedk_geom(const void* phi, void* out, const MinmaxParams& p,
                       const int* geom, int ksteps, const void* active,
                       int copy_inactive, void* partials, void* dsq,
                       void* stream) {
  const lsf::BlockGeom q = lsf::block_geom(geom);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* in = static_cast<const float*>(phi);
  float* o = static_cast<float*>(out);
  const int* act = static_cast<const int*>(active);
  double* part = static_cast<double*>(partials);
  int e;
  switch (ksteps) {
    case 1:
      e = launch_fusedk<1, BLOCK>(in, o, p, q, act, copy_inactive, part, st);
      break;
    case 2:
      e = launch_fusedk<2, BLOCK>(in, o, p, q, act, copy_inactive, part, st);
      break;
    case 3:
      e = launch_fusedk<3, BLOCK>(in, o, p, q, act, copy_inactive, part, st);
      break;
    case 4:
      e = launch_fusedk<4, BLOCK>(in, o, p, q, act, copy_inactive, part, st);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != 0) return e;
  return lsf::finish(dim3(q.nb[2], q.nb[1], q.nb[0]), partials, dsq, st);
}

}  // namespace

extern "C" int lsf_minmax_fusedk_f32(const void* phi, void* out, int nx,
                                     int ny, int nz, float h1, float inv_dx2,
                                     float band_dx, float threshold,
                                     int ksteps, const void* active,
                                     int copy_inactive, void* partials,
                                     void* dsq, void* stream) {
  int geom[lsf::BLOCK_GEOM_INTS];
  lsf::solo_geom(nx, ny, nz, geom);
  return launch_fusedk_geom<false>(
      phi, out, MinmaxParams{nx, ny, nz, h1, inv_dx2, band_dx, threshold},
      geom, ksteps, active, copy_inactive, partials, dsq, stream);
}

// K4's block mode: geom as for lsf_minmax_step_block_f32, its launch box
// the whole brick grid; frozen bricks copy their cells.
extern "C" int lsf_minmax_fusedk_block_f32(const void* phi, void* out,
                                           int nx, int ny, int nz,
                                           const int* geom, float h1,
                                           float inv_dx2, float band_dx,
                                           float threshold, int ksteps,
                                           const void* active,
                                           void* partials, void* dsq,
                                           void* stream) {
  return launch_fusedk_geom<true>(
      phi, out, MinmaxParams{nx, ny, nz, h1, inv_dx2, band_dx, threshold},
      geom, ksteps, active, 1, partials, dsq, stream);
}

// geom: BLOCK_GEOM_INTS host ints (common.cuh); nx, ny, nz: the padded
// array's dimensions.
extern "C" int lsf_minmax_step_block_f32(const void* phi, void* out, int nx,
                                         int ny, int nz, const int* geom,
                                         float h1, float inv_dx2,
                                         float band_dx, float threshold,
                                         const void* active, void* partials,
                                         void* dsq, void* tickets,
                                         void* stream) {
  return launch_minmax_march(
      phi, out, 1, MinmaxParams{nx, ny, nz, h1, inv_dx2, band_dx, threshold},
      geom, nullptr, nullptr, active, 1, partials, dsq, tickets, stream);
}
