// One chunk of preconditioned conjugate gradients on the damped reduced pose
// system S = T - V V^T of a large graph, with V streamed from the banded tile
// stack, on a persistent cooperative grid of thread-block clusters.
//
// Replaces toyslam_tpu/ops/fused_pcg.py::_make_band_kernel (the streamed band
// fused-PCG Pallas kernel, launched by band_fused_pcg).  One launch keeps
// that kernel's contract:
//
//   * chunk_iters CG trips from the carried state (x, r, p, rz, it, stop),
//     then one extra trip whose matvec is on x: r_true = rhs - S x and its
//     squared norm (alpha = 0 there: x and r take a zero step);
//   * restart != 0: r := rt (the carried true residual) and p := M^-1 r;
//   * breakdown (p^T A p <= 0 or not finite) sets a sticky stop; a done trip
//     (stop, rr <= atol2 or it >= maxit) masks to a no-op;
//   * T block tridiagonal with circular neighbours (p +- 1 mod Np);
//   * V V^T per landmark chunk c: first t = sum_{k,a} x[a, window k] .
//     tiles[c,k,a] over ALL K windows of the chunk, then the w-pass
//     w[a, window k] += tiles[c,k,a] . t.  A landmark seen in several
//     windows has one column split across them, so splitting t per window
//     would drop the cross-window terms;
//   * wide and loop-closure columns u [dp, Mw, Np]: w += u (u^T x);
//   * M^-1 = L levels of PCR (shifts 1, 2, 4, ..., circular), the
//     block-diagonal binv, and an optional additive coarse level
//     rmat cinv rmat^T over groups of `group` consecutive poses (rmat is
//     their 0/1 restriction, which the wrapper checks; the kernel reads the
//     group of pose q as q / group).  All f32 (the reference keeps the PCR
//     planes in bf16 to fit its on-chip memory; there is no such limit here).
//
// What bounds it on an H100: streaming the tile stack from device memory on
// every matvec.  The stack is [39, 2, 3, 512, 512] f32 = 245 MB at 10k
// poses and [388, 10, 3, 256, 256] = 3.05 GB at 100k, larger than the 50 MB
// L2, and each trip's matvec depends on the one before: chunk_iters + 1
// reads of it at the card's 3.35 TB/s, 0.91 ms a trip at 100k.
//
// How a matvec reads the stack once.  A chunk has rows = K*DP*Wrow tile
// rows (k, a, w) and B*dl columns.  t restricted to a band of `cols`
// columns needs only the band, and so does the band's share of the w-pass,
// rows . t over its columns, which adds up over the bands.  Two schedules,
// picked per layout by the host's plan (ops/fused_pcg.py::band_tile_plan):
//
// The slab schedule, where a whole-height band of at least 16 columns (a
// slab) fits one block's shared memory (3072 rows a chunk at 10k poses):
// the wrapper re-lays the stack slab-major once per stack, so a slab is one
// contiguous run, and block b takes slabs b, b + grid, ... : it copies each
// with 16-byte asynchronous copies (cp.async, bypassing L1) in four row
// parts, each its own group, issued while the previous slab's w-pass frees
// them; sums the slab's t over its rows part by part as they land; and
// writes the w-pass rows to the slab's slot of wpart.  No block waits on
// another.
//
// The cluster-band schedule, for taller chunks (7680 rows at 100k, where a
// slab would be 4 columns wide and its partials a quarter of the stack),
// reads the stack as it was built (no re-laid copy).  A cluster of R
// blocks takes one chunk's band at a time,
// block r its share of the rows, as `parts` parts of `pr` rows; the host's
// plan (ops/fused_pcg.py::band_tile_plan) picks R (up to 16, a
// non-portable size) and cols (64 or 128: each row a run of 256 or 512
// contiguous bytes of the stack) per layout.  Thread 0 of each block
// streams its sequence of parts through a ring of `slots` parts in shared
// memory with the tensor memory accelerator: cols / 32 2D boxes [pr, 32]
// per part (swizzled 128B, so that a quarter warp's float4s fall in
// distinct banks) and a 1D bulk copy of the rows' state values, completing
// on the slot's mbarrier; the other threads issue nothing.  Per band:
//   1. the block's partial t over its rows, part by part as they land;
//   2. R > 1: the R partials (cols floats each) are exchanged through
//      distributed shared memory behind one cluster barrier and summed in
//      rank order, so every block of the cluster holds the same t bits;
//   3. the w-pass of the block's rows, each thread owning one row of each
//      part, whose sums stay in registers across the unit's bands; each
//      part's slot, once every thread is done with it, takes the part
//      `slots` further on.
// A unit of work is a chunk's `segments`-th share of its bands (a slab, on
// the slab schedule); its w sums go to the unit's slot of wpart [n_chunks,
// rows, segments] once per unit: a row's slots lie side by side, so the
// gather reads them as one run, and at 100k (one unit per chunk) a warp's
// store is contiguous.  The gather sums a pose's covering window rows over
// their unit slots, in (chunk, window, segment) order.  The matvec input at the window rows
// (x, or this trip's p) is laid out once per trip in xwin, behind one grid
// barrier, and each block copies its rows of it with each part (or slab).
// The next trip's first parts are issued at the end of a trip's band
// phase, so they land while the gather and the preconditioner run.
//
// Grid barriers per CG trip: xwin | bands | gather (ap, p.ap) | update +
// PCR levels 0-1 | one per further pair of PCR levels (the coarse
// restriction beside the first, the coarse solve beside the second) | the
// preconditioner end (z, r.z, r.r) -- 10 at L=14.  The p update is folded
// into the next trip's first phase (p is double buffered), the x/r update
// into the first preconditioner phase (r is double buffered; level 0
// recomputes r at its neighbours), and every per-pose phase gives a block
// the same poses, so the last PCR level's output and the new r are read
// back only by the block that wrote them.  Cooperative launch and cluster
// dimensions combine on Hopper; the grid barrier is cooperative groups'.
//
// Determinism: no atomics.  Every sum has a fixed order: t over a block's
// rows (row groups, then warps, then ranks), w per row over the unit's
// bands, a per-pose sum over the covering windows in (chunk, window) order
// from a static table (`cover`, built once per graph structure) and over
// the segments in order, the coarse restriction per group in a warp's
// fixed tree, and the dot products as per-block partials summed in block
// order by every block.  Runs repeat bit for bit at one plan.
//
// Instantiated for what a path's plan takes: the slab schedule at DP = 3
// (SE(2) poses) and DP = 6 (SE(3) bundle adjustment), and cluster bands of
// 64 and 128 columns at DP = 3; the C entry points dispatch on (dp, cols,
// schedule) and refuse any other.
//
// Built with nvcc for sm_90a, WITHOUT --use_fast_math: the breakdown test
// needs isfinite() to see NaN/inf, and alpha/beta need IEEE division.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxParts = 8;      // parts (of <= kThreads rows) of a block's rows
constexpr int kMaxSlots = 16;     // ring slots of one part each
constexpr int kBoxCols = 32;      // columns of a TMA box: 128 bytes, the swizzle span
constexpr int kMaxCluster = 16;   // a non-portable cluster size (8 is portable)
constexpr int kWideSeg = 1024;    // poses per wide-column partial
constexpr int kPartialSlots = 4;  // floats per block in a partial-sum buffer
constexpr int kRedFloats = 64;
constexpr int kTimers = 10;       // see the enum below Timer

constexpr int kNumDims = 20;
constexpr int kNumPtrs = 30;

struct Params {
  CUtensorMap tmap;   // the tile stack as [n_chunks * rows, B*dl], boxes [pr, 32]
  int np, n_chunks, k_win, w_row, b_dl, mw, nlevels, nc, cover_cap;
  int chunk_iters, maxit, restart;
  int rows;       // tile rows per chunk, K*DP*Wrow
  int cluster;    // R: blocks per cluster, splitting a chunk's rows
  int rpb;        // rows per block of a cluster
  int cols;       // columns per band
  int lw4;        // log2(cols / 4)
  int seg;        // units (segments) per chunk
  int nbu;        // bands per unit
  int units;      // n_chunks * seg
  int parts;      // parts of a block's rows per band: ceil(rpb / kThreads)
  int pr;         // rows per part: rpb / parts, a multiple of 8
  int slots;      // ring slots
  int group;      // poses per coarse group (nc > 0)
  const float* atol2;
  const int* it_in;
  const float* rz_in;
  const int* stop_in;
  const float* rhs;
  const float* x_in;
  const float* r_in;
  const float* p_in;
  const float* rt_in;
  const float* tiles;    // [n_chunks, K, DP, Wrow, B*dl] as built (bands), or
                         // its slab-major copy [units, rows, cols] (slabs)
  const int* win_off;    // [n_chunks, K]
  const int* cover;      // [Np, cap] chunk row c*rows + (k*DP)*Wrow + w, -1 pads
  const float* u;        // [DP, Mw, Np] or null
  const float* td;       // [DP, DP, Np]
  const float* tu;
  const float* tl;
  const float* alphas;   // [L, DP, DP, Np]
  const float* gammas;
  const float* binv;     // [DP, DP, Np]
  const float* cinv;     // [DP, DP, nc, nc] or null
  // outputs; x and p are also working state
  float* x;
  float* r;
  float* p;
  float* rt;
  int* it_out;
  float* rz_out;
  int* stop_out;
  float* rr_out;
  long long* timing;     // [grid, kTimers] clock64 sums per block, or null
  // workspace (written and read inside the launch: never the read-only
  // cache)
  float* ap;        // [DP, Np]
  float* z;
  float* ta;        // PCR ping-pong
  float* tb;
  float* ra;        // r ping-pong
  float* rb;
  float* pb;        // p ping-pong partner of `p`
  float* xwin;      // [n_chunks, rows] the matvec input at the window rows
  float* wpart;     // [n_chunks, rows, seg] w-pass rows per unit (slot u % seg)
  float* widepart;  // [n_wseg, Mw]
  float* rc;        // [DP, nc]
  float* za;        // [DP, nc]
  float* partials;  // [2, grid, kPartialSlots]
};

struct Layout {
  size_t ap, z, ta, tb, ra, rb, pb, xwin, wpart, widepart, rc, za, partials,
      total;
};

__host__ __device__ inline int n_wseg(int np) { return (np + kWideSeg - 1) / kWideSeg; }
__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// How R blocks split `rows`: `parts` parts of `pr` rows each a block (pr a
// multiple of 8, at most kThreads), parts * pr >= rows / R.
struct RowSplit {
  int parts, pr;
};

inline RowSplit row_split(int rows, int cluster) {
  const int rpb = (rows + cluster - 1) / cluster;
  const int parts = (rpb + kThreads - 1) / kThreads;
  return {parts, (((rpb + parts - 1) / parts) + 7) & ~7};
}

Layout layout(int dp, int np, int n_chunks, int rows, int units, int mw,
              int nc, int grid) {
  Layout L;
  const size_t n = (size_t)dp * np;
  size_t o = 0;
  L.ap = o; o += n;
  L.z = o; o += n;
  L.ta = o; o += n;
  L.tb = o; o += n;
  L.ra = o; o += n;
  L.rb = o; o += n;
  L.pb = o; o += n;
  o = (o + 3) & ~(size_t)3;   // 16-byte copies out of xwin
  L.xwin = o; o += (size_t)n_chunks * rows;
  L.wpart = o; o += (size_t)units * rows;
  L.widepart = o; o += (size_t)n_wseg(np) * mw;
  L.rc = o; o += (size_t)dp * nc;
  L.za = o; o += (size_t)dp * nc;
  L.partials = o; o += (size_t)2 * grid * kPartialSlots;
  L.total = o;
  return L;
}

// Shared memory of one block in floats: the ring of `slots` parts (the
// part's rows of the band as cols / 32 swizzled TMA boxes [pr, 32], 1024-
// byte aligned), their state values [slots, pr], the cluster-visible
// partial t (two buffers), t, the row-group combination buffer, u^T v,
// reduction slots, and one mbarrier per slot (mirrored by band_smem_bytes
// in ops/fused_pcg.py).
struct Smem {
  size_t ring, xs, tp, ts, comb, urow, red, bars, total;
};

__host__ __device__ inline Smem smem_layout(int pr, int cols, int slots, int mw) {
  Smem S;
  size_t o = 0;   // in floats
  S.ring = o; o += (size_t)slots * pr * cols;
  S.xs = o; o += (size_t)slots * pr;
  S.tp = o; o += 2 * cols;
  S.ts = o; o += cols;
  S.comb = o; o += 4 * kThreads;
  S.urow = o; o += round4(mw);
  S.red = o; o += kRedFloats;
  o = (o + 1) & ~(size_t)1;   // 8-byte mbarriers
  S.bars = o; o += 2 * slots;
  S.total = o * sizeof(float);
  return S;
}

// --- PTX helpers: asynchronous 16-byte copies (the slab schedule) ----------

constexpr int kParts = 4;   // row parts of a slab, one copy group each

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most `pending` of this thread's newest copy groups are in
// flight (0 <= pending < kParts).
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;" ::: "memory"); break;
  }
}

// --- PTX helpers: the tensor memory accelerator and mbarriers --------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)));
}

// This thread's arrival, expecting `bytes` of asynchronous copies.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// A 2D box of the tensor map at (column x, row y) into shared memory.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int x, int y,
                                        unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(map), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}

// `bytes` (a multiple of 16) contiguous bytes into shared memory.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ float4 f4add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 f4fma(float s, float4 b, float4 a) {
  return make_float4(fmaf(s, b.x, a.x), fmaf(s, b.y, a.y), fmaf(s, b.z, a.z),
                     fmaf(s, b.w, a.w));
}

__device__ __forceinline__ float4 f4shfl_xor(float4 v, int o) {
  return make_float4(__shfl_xor_sync(0xffffffffu, v.x, o),
                     __shfl_xor_sync(0xffffffffu, v.y, o),
                     __shfl_xor_sync(0xffffffffu, v.z, o),
                     __shfl_xor_sync(0xffffffffu, v.w, o));
}

// --- reductions ---------------------------------------------------------------

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums of NV values over the block, returned to every thread, in a fixed
// order for a fixed block size.  red holds kWarps * NV + NV floats.
template <int NV>
__device__ void block_sum(float (&v)[NV], float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const float s = warp_sum(v[j]);
    if (lane == 0) red[j * kWarps + warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float t = lane < kWarps ? red[j * kWarps + lane] : 0.f;
      t = warp_sum(t);
      if (lane == 0) red[NV * kWarps + j] = t;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NV; ++j) v[j] = red[NV * kWarps + j];
  __syncthreads();
}

// This block's share of NV grid-wide sums, stored in slot blockIdx.x of
// partial buffer `buf`.
template <int NV>
__device__ void put_partials(const Params& P, int buf, float (&v)[NV],
                             float* red) {
  block_sum<NV>(v, red);
  if (threadIdx.x == 0) {
    float* dst = P.partials + ((size_t)buf * gridDim.x + blockIdx.x) * kPartialSlots;
#pragma unroll
    for (int j = 0; j < NV; ++j) dst[j] = v[j];
  }
}

// The NV grid-wide sums of partial buffer `buf` (after a grid barrier), the
// same bits in every block: blocks in a fixed order.
template <int NV>
__device__ void grid_totals(const Params& P, int buf, float (&v)[NV],
                            float* red) {
#pragma unroll
  for (int j = 0; j < NV; ++j) v[j] = 0.f;
  const float* src = P.partials + (size_t)buf * gridDim.x * kPartialSlots;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += blockDim.x) {
#pragma unroll
    for (int j = 0; j < NV; ++j) v[j] += src[(size_t)b * kPartialSlots + j];
  }
  block_sum<NV>(v, red);
}

// Every per-element phase gives block b the poses [b*ppb, (b+1)*ppb) and
// walks their (component, pose) elements with all its threads, the same way
// in every phase: a block reads back only what it wrote itself, after a
// block barrier.
__device__ __forceinline__ int poses_per_block(int n) {
  return (n + gridDim.x - 1) / gridDim.x;
}

__device__ __forceinline__ int grid_thread() {
  return blockIdx.x * blockDim.x + threadIdx.x;
}
__device__ __forceinline__ int grid_threads() { return gridDim.x * blockDim.x; }

// The search direction of the current trip at element idx: p_in or the
// previous p (mode 0), z (mode 1, restart), or z + beta p (mode 2).
struct PDir {
  const float* z;
  const float* pold;
  float beta;
  int mode;
  __device__ __forceinline__ float operator()(size_t idx) const {
    if (mode == 0) return pold[idx];
    if (mode == 1) return z[idx];
    return fmaf(beta, pold[idx], z[idx]);
  }
};

// r at element i after this trip's update (rsrc alone at chunk entry).
struct RNew {
  const float* r;
  const float* ap;
  float alpha;
  __device__ __forceinline__ float operator()(size_t i) const {
    return ap ? fmaf(-alpha, ap[i], r[i]) : r[i];
  }
};

// clock64 sums of each block's thread 0 per phase kind (on when P.timing).
struct Timer {
  bool on;
  long long t, acc[kTimers];
  __device__ void lap(int k) {
    if (on) {
      const long long now = clock64();
      acc[k] += now - t;
      t = now;
    }
  }
};
// laying out xwin, waiting for band copies, partial t, the cluster's t
// exchange, w-pass, wide columns, gather, preconditioner work, grid
// barriers, the rest
enum {
  kTXwin = 0, kTCopyWait = 1, kTPartial = 2, kTExchange = 3, kTWpass = 4,
  kTWide = 5, kTGather = 6, kTPrecond = 7, kTSync = 8, kTOther = 9
};

__device__ __forceinline__ void gsync(cg::grid_group& grid, Timer& tm, int kind) {
  tm.lap(kind);
  grid.sync();
  tm.lap(kTSync);
}

struct SmemPtrs {
  float* ring;
  float* xs;
  float* tp;
  float* ts;
  float4* comb;
  float* urow;
  float* red;
  unsigned long long* bars;
};

// --- the matvec: out = S v ------------------------------------------------------

// This block's rows of a chunk, [row0, row0 + nrows), and its cluster's
// walk: cluster cl of ncl takes units cl, cl + ncl, ..., `bands` bands in
// all (the unit's bands in order, then the next unit's).
struct Share {
  int row0, nrows, cl, ncl, bands;
};

__device__ __forceinline__ Share block_share(const Params& P) {
  const int rank = (int)(blockIdx.x % P.cluster);
  const int row0 = rank * P.rpb;
  const int cl = blockIdx.x / P.cluster, ncl = gridDim.x / P.cluster;
  const int units = cl < P.units ? (P.units - cl + ncl - 1) / ncl : 0;
  return {row0, max(0, min(P.rpb, P.rows - row0)), cl, ncl, units * P.nbu};
}

// Ring slot of the part with launch-wide index gg (parts are numbered
// across the launch's trips, so that slot gg % slots completes one
// mbarrier phase per part, of parity (gg / slots) & 1).  A slot holds the
// part's rows as cols / 32 TMA boxes [pr, 32], each swizzled as
// CU_TENSOR_MAP_SWIZZLE_128B lays it out: the 16-byte unit j of row r at
// j ^ (r % 8), so that the eight float4s a quarter warp reads (one column
// of eight rows, or eight columns of one row) fall in distinct banks.
__device__ __forceinline__ float* ring_slot(const Params& P, const SmemPtrs& S,
                                           long long gg) {
  return S.ring + (size_t)(gg % P.slots) * P.pr * P.cols;
}

__device__ __forceinline__ float* ring_x(const Params& P, const SmemPtrs& S,
                                        long long gg) {
  return S.xs + (size_t)(gg % P.slots) * P.pr;
}

// The chunk and first column of band beta of this block's sequence.
__device__ __forceinline__ void band_of(const Params& P, const Share& sh,
                                        int beta, int& c, int& col0) {
  const int k = beta / P.nbu, b = beta - k * P.nbu;
  const int u = sh.cl + k * sh.ncl;
  c = u / P.seg;
  col0 = ((u - c * P.seg) * P.nbu + b) * P.cols;
}

// The block's rows of part g of its sequence (band g / parts, rows
// [(g % parts) * pr, + pr) of its share) in xwin, and how many of them.
__device__ __forceinline__ const float* part_x(const Params& P, const Share& sh,
                                               int g, int& nr) {
  const int beta = g / P.parts, i = g - beta * P.parts;
  int c, col0;
  band_of(P, sh, beta, c, col0);
  nr = max(0, min(P.pr, sh.nrows - i * P.pr));
  return P.xwin + (size_t)c * P.rows + sh.row0 + i * P.pr;
}

// Thread 0: start copying part g of the block's sequence of this trip
// (launch-wide index base + g: its cols / 32 TMA boxes, with `with_x` also
// its state values from xwin) into its ring slot; completion on the slot's
// mbarrier.  The box may reach past the block's rows (into the next chunk,
// or zeros past the stack); those rows are never read.
__device__ void issue_part(const Params& P, const SmemPtrs& S, const Share& sh,
                           long long base, int g, bool with_x) {
  const int beta = g / P.parts, i = g - beta * P.parts;
  int c, col0;
  band_of(P, sh, beta, c, col0);
  int nr;
  const float* xsrc = part_x(P, sh, g, nr);
  const int boxes = P.cols / kBoxCols;
  const unsigned xbytes = with_x ? 4u * nr : 0u;
  unsigned long long* bar = S.bars + (base + g) % P.slots;
  mbar_expect(bar, 4u * P.pr * P.cols + xbytes);
  float* slot = ring_slot(P, S, base + g);
  const int y = c * P.rows + sh.row0 + i * P.pr;
  for (int bx = 0; bx < boxes; ++bx)
    tma_box(slot + (size_t)bx * P.pr * kBoxCols, &P.tmap, col0 + bx * kBoxCols, y, bar);
  if (xbytes) bulk_copy(ring_x(P, S, base + g), xsrc, xbytes, bar);
}

// Phase 1 of a trip: this trip's p into `pnew`, the matvec input v at the
// window rows into xwin (grid barrier), then the bands' t and w-pass (see
// the header) and the wide-column partials of v.  The first `slots` parts
// of the block's sequence were issued before the phase (their state values
// are read here); with `prefetch` the next trip's are issued at its end.
// `parts_base` counts the parts of the launch's earlier trips.
// The matvec input at element i: x on the true-residual trip, else this
// trip's p.
struct VIn {
  const float* x;
  PDir pd;
  bool last;
  __device__ __forceinline__ float operator()(size_t i) const {
    return last ? x[i] : pd(i);
  }
};

// This trip's p into `pnew` (the block's own poses) and the matvec input v
// at every window row (k, a, w) of every chunk into xwin (zero past Np),
// then a grid barrier.
template <int DP>
__device__ void layout_xwin(const Params& P, cg::grid_group& grid, const VIn& v,
                            float* pnew, Timer& tm) {
  const int n = P.np;
  const int ppb = poses_per_block(n), q0 = blockIdx.x * ppb;
  for (int i = threadIdx.x; i < DP * ppb; i += kThreads) {
    const int a = i / ppb, q = q0 + i - a * ppb;
    if (q < n) pnew[(size_t)a * n + q] = v.pd((size_t)a * n + q);
  }
  for (int idx = grid_thread(); idx < P.n_chunks * P.rows; idx += grid_threads()) {
    const int c = idx / P.rows, rho = idx - c * P.rows;
    const int ka = rho / P.w_row, w = rho - ka * P.w_row;
    const int kw = ka / DP, a = ka - kw * DP;
    const int q = __ldg(P.win_off + c * P.k_win + kw) + w;
    P.xwin[idx] = q < n ? v((size_t)a * n + q) : 0.f;
  }
  gsync(grid, tm, kTXwin);
}

// Wide columns: widepart[s, m] = sum_{a, p in segment s} v[a,p] u[a,m,p],
// on the blocks with the fewest units first.
template <int DP>
__device__ void wide_partials(const Params& P, const VIn& v, const SmemPtrs& S) {
  const int n = P.np, nseg = n_wseg(n);
  const int n_wide = P.mw * nseg;
  for (int item = (int)gridDim.x - 1 - (int)blockIdx.x; item < n_wide;
       item += gridDim.x) {
    const int m = item / nseg, sg = item - m * nseg;
    const int p0 = sg * kWideSeg, p1 = min(n, p0 + kWideSeg);
    float accw[1] = {0.f};
    for (int q = p0 + threadIdx.x; q < p1; q += kThreads) {
#pragma unroll
      for (int a = 0; a < DP; ++a)
        accw[0] = fmaf(v((size_t)a * n + q),
                       __ldg(P.u + ((size_t)a * P.mw + m) * n + q), accw[0]);
    }
    block_sum<1>(accw, S.red);
    if (threadIdx.x == 0) P.widepart[(size_t)sg * P.mw + m] = accw[0];
  }
}

template <int DP, int W4>
__device__ void phase_bands(const Params& P, cg::grid_group& grid, const VIn& v,
                            float* pnew, bool prefetch, const SmemPtrs& S,
                            Timer& tm, long long* parts_base) {
  const int tid = threadIdx.x;
  layout_xwin<DP>(P, grid, v, pnew, tm);

  cg::cluster_group cluster = cg::this_cluster();
  const Share sh = block_share(P);
  constexpr int w4 = W4;                  // float4 columns of a band
  constexpr int H = kThreads / w4;        // row groups of the partial t
  const int c4 = tid % w4, h = tid / w4;
  const int warp = tid >> 5, lane = tid & 31;
  const float4* ts4 = reinterpret_cast<const float4*>(S.ts);
  const int total = sh.bands * P.parts;   // parts of this trip
  const long long base = *parts_base;
  // the state values of the parts issued before xwin was laid out
  for (int g = 0; g < min(P.slots, total); ++g) {
    int nr;
    const float* src = part_x(P, sh, g, nr);
    float* dst = ring_x(P, S, base + g);
    for (int f = tid; f < nr; f += kThreads) dst[f] = src[f];
  }
  int tbuf = 0;   // the partial-t buffer of this band (the cluster's, alternated)
  float acc[kMaxParts];
  for (int beta = 0; beta < sh.bands; ++beta) {
    const int k = beta / P.nbu, b = beta - k * P.nbu;
    if (b == 0) {
#pragma unroll
      for (int m = 0; m < kMaxParts; ++m) acc[m] = 0.f;
    }
    // the partial t over the block's rows of the band, part by part as
    // they land: thread (column quad c4, row group h) sums rows h, h + H, ...
    float4 acc4 = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = 0; i < P.parts; ++i) {
      const long long gg = base + beta * P.parts + i;
      mbar_wait(S.bars + gg % P.slots, (unsigned)((gg / P.slots) & 1));
      if (i == 0) {
        if (beta == 0) __syncthreads();   // the state values written above
        tm.lap(kTCopyWait);
      }
      // column quad c4 of row r: box c4 / 8, unit (c4 % 8) ^ (r % 8)
      const float4* col4 = reinterpret_cast<const float4*>(ring_slot(P, S, gg)) +
                           (c4 >> 3) * P.pr * (kBoxCols / 4);
      const float* xs = ring_x(P, S, gg);
      const int nr = min(P.pr, sh.nrows - i * P.pr), cq = c4 & 7;
#pragma unroll 4
      for (int r = h; r < nr; r += H)
        acc4 = f4fma(xs[r], col4[r * (kBoxCols / 4) + (cq ^ (r & 7))], acc4);
    }
    // row groups combined in a fixed order: within a warp by a shuffle
    // tree over the lanes of one column quad, then the warps in order
    if (w4 < 32) {
#pragma unroll
      for (int o = 16; o >= w4; o >>= 1) acc4 = f4add(acc4, f4shfl_xor(acc4, o));
      if (lane < w4) S.comb[warp * w4 + c4] = acc4;
    } else {
      S.comb[h * w4 + c4] = acc4;
    }
    __syncthreads();
    float* tout = P.cluster > 1 ? S.tp + tbuf * P.cols : S.ts;
    if (tid < w4) {
      constexpr int groups = w4 < 32 ? kWarps : H;
      float4 t4 = S.comb[tid];
#pragma unroll
      for (int q = 1; q < groups; ++q) t4 = f4add(t4, S.comb[q * w4 + tid]);
      reinterpret_cast<float4*>(tout)[tid] = t4;
    }
    tm.lap(kTPartial);
    if (P.cluster > 1) {
      // every rank's partial t, added in rank order (double-buffered: a
      // buffer is written again only after the next band's barrier,
      // which every reader passes after its reads)
      cluster.sync();
      if (tid < P.cols) {
        float pt[kMaxCluster];   // every rank's partial asked for at once
#pragma unroll
        for (int q = 0; q < kMaxCluster; ++q)
          pt[q] = q < P.cluster ? cluster.map_shared_rank(tout, q)[tid] : 0.f;
        float s = pt[0];
#pragma unroll
        for (int q = 1; q < kMaxCluster; ++q) s += pt[q];
        S.ts[tid] = s;
      }
      tbuf ^= 1;
      tm.lap(kTExchange);
    }
    __syncthreads();
    // the w-pass: thread tid owns row tid of each part; its sums over the
    // unit's bands stay in acc.  Each part's slot, once every thread is
    // done with it, takes the part `slots` further on
#pragma unroll
    for (int i = 0; i < kMaxParts; ++i) {
      if (i < P.parts) {
        const int g = beta * P.parts + i;
        if (tid < min(P.pr, sh.nrows - i * P.pr)) {
          // row tid's float4s: box kk / 8, unit (kk % 8) ^ (tid % 8)
          const float4* row = reinterpret_cast<const float4*>(
                                  ring_slot(P, S, base + g)) + tid * (kBoxCols / 4);
          const int sw = tid & 7, box = P.pr * (kBoxCols / 4);
          float s = 0.f;
#pragma unroll
          for (int kk = 0; kk < w4; ++kk) {
            const float4 a = row[(kk >> 3) * box + ((kk & 7) ^ sw)], bq = ts4[kk];
            s = fmaf(a.x, bq.x, s);
            s = fmaf(a.y, bq.y, s);
            s = fmaf(a.z, bq.z, s);
            s = fmaf(a.w, bq.w, s);
          }
          acc[i] += s;
        }
        if (g + P.slots < total) {
          __syncthreads();
          if (tid == 0) issue_part(P, S, sh, base, g + P.slots, true);
        }
      }
    }
    tm.lap(kTWpass);
    if (b + 1 == P.nbu) {
      // the unit's w rows, once: slot u % seg of each row of chunk u / seg
      const int u = sh.cl + k * sh.ncl, c = u / P.seg;
      float* wdst = P.wpart + ((size_t)c * P.rows + sh.row0) * P.seg + (u - c * P.seg);
#pragma unroll
      for (int i = 0; i < kMaxParts; ++i) {
        const int r = i * P.pr + tid;
        if (i < P.parts && tid < P.pr && r < sh.nrows) wdst[(size_t)r * P.seg] = acc[i];
      }
    }
  }
  *parts_base = base + total;

  wide_partials<DP>(P, v, S);
  if (prefetch) {
    __syncthreads();   // every slot read
    if (tid == 0)
      for (int g = 0; g < min(P.slots, total); ++g)
        issue_part(P, S, sh, base + total, g, false);
  }
  tm.lap(kTWide);
}

// --- the slab schedule: whole-height slabs of a slab-major copy ------------

// All threads: start copying row part q of slab g (one contiguous run of the
// slab-major copy [units, rows, cols]) into shared memory, as one copy
// group.
__device__ void load_slab_part(const Params& P, const SmemPtrs& S, int g, int q) {
  const int pr = (P.rows + kParts - 1) / kParts;
  const size_t f0 = (size_t)q * pr * P.cols;
  const size_t f1 = (size_t)min(P.rows, (q + 1) * pr) * P.cols;
  const float* base = P.tiles + (size_t)g * P.rows * P.cols;
  for (size_t f = f0 + 4 * threadIdx.x; f < f1; f += 4 * kThreads)
    cp_async16(S.ring + f, base + f);
  cp_async_commit();
}

// All threads: start copying the state values of slab g's chunk from xwin,
// as one copy group.
__device__ void load_slab_x(const Params& P, const SmemPtrs& S, int g) {
  const float* src = P.xwin + (size_t)(g / P.seg) * P.rows;
  for (int i = threadIdx.x; i < P.rows / 4; i += kThreads)
    cp_async16(S.xs + 4 * i, src + 4 * i);
  cp_async_commit();
}

// Phase 1 of a trip on the slab schedule: a unit is one slab, all of a
// chunk's rows by `cols` columns, one block's (block b takes slabs b,
// b + grid, ...): its partial t is the slab's t, and its w rows go to the
// unit's slot of wpart.  The row parts of the block's first slab were
// issued before the phase; with `prefetch` the next trip's are issued at
// its end.
template <int DP>
__device__ void phase_slabs(const Params& P, cg::grid_group& grid, const VIn& v,
                            float* pnew, bool prefetch, const SmemPtrs& S,
                            Timer& tm) {
  const int tid = threadIdx.x;
  layout_xwin<DP>(P, grid, v, pnew, tm);
  const int pr = (P.rows + kParts - 1) / kParts;
  const int w4 = P.cols / 4;
  const int H = kThreads / w4;          // row groups of the partial t
  const int c4 = tid % w4, h = tid / w4;
  const float4* slab4 = reinterpret_cast<const float4*>(S.ring);
  const float4* ts4 = reinterpret_cast<const float4*>(S.ts);
  bool first = true;
  for (int g = blockIdx.x; g < P.units; g += gridDim.x) {
    if (first) {
      // its parts were issued before the phase, its state values now
      load_slab_x(P, S, g);
      cp_async_wait(0);
    }
    // the partial t over the slab's columns, part by part as they land:
    // thread (column quad c4, row group h) sums rows h, h + H, ...
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < kParts; ++q) {
      if (!first) cp_async_wait(kParts - 1 - q);
      __syncthreads();
      if (q == 0) tm.lap(kTCopyWait);
      const int r1 = min(P.rows, (q + 1) * pr);
      if (h < H) {
#pragma unroll 4
        for (int r = q * pr + h; r < r1; r += H)
          acc = f4fma(S.xs[r], slab4[(size_t)r * w4 + c4], acc);
      }
    }
    // row groups combined in a fixed order
    S.comb[tid] = acc;
    __syncthreads();
    if (tid < w4) {
      float4 t4 = acc;
      for (int hh = 1; hh < H; ++hh) t4 = f4add(t4, S.comb[hh * w4 + tid]);
      reinterpret_cast<float4*>(S.ts)[tid] = t4;
    }
    __syncthreads();
    tm.lap(kTPartial);
    const int gn = g + gridDim.x;
    if (gn < P.units) load_slab_x(P, S, gn);   // xs is free: the next slab's
    // the w-pass: one thread per row, rows . t over the slab's columns,
    // part by part, written to the slab's slot of each row; each freed part
    // takes the next slab's rows
    const int c = g / P.seg;
    float* wdst = P.wpart + (size_t)c * P.rows * P.seg + (g - c * P.seg);
    for (int q = 0; q < kParts; ++q) {
      const int r1 = min(P.rows, (q + 1) * pr);
      for (int r = q * pr + tid; r < r1; r += kThreads) {
        // the row's float4s from a rotated start: fewer bank conflicts
        const float4* row = slab4 + (size_t)r * w4;
        float s = 0.f;
        int kk = r % w4;
        for (int k = 0; k < w4; ++k) {
          const float4 a = row[kk], b = ts4[kk];
          s = fmaf(a.x, b.x, s);
          s = fmaf(a.y, b.y, s);
          s = fmaf(a.z, b.z, s);
          s = fmaf(a.w, b.w, s);
          if (++kk == w4) kk = 0;
        }
        wdst[(size_t)r * P.seg] = s;
      }
      __syncthreads();
      if (gn < P.units) load_slab_part(P, S, gn, q);
    }
    tm.lap(kTWpass);
    first = false;
  }
  wide_partials<DP>(P, v, S);
  if (prefetch && (int)blockIdx.x < P.units) {
    for (int q = 0; q < kParts; ++q) load_slab_part(P, S, blockIdx.x, q);
  }
  tm.lap(kTWide);
}

// Phase 2: ap = (T v - u urow) - band rows, and this block's p . ap.
template <int DP>
__device__ void phase_gather(const Params& P, const float* v, const float* pcur,
                             int buf, const SmemPtrs& S) {
  const int n = P.np, cap = P.cover_cap, nseg = n_wseg(n);
  for (int m = threadIdx.x; m < P.mw; m += kThreads) {
    float s = 0.f;
    for (int sg = 0; sg < nseg; ++sg) s += P.widepart[(size_t)sg * P.mw + m];
    S.urow[m] = s;
  }
  __syncthreads();
  float part[1] = {0.f};
  const int ppb = poses_per_block(n), q0 = blockIdx.x * ppb;
  for (int i = threadIdx.x; i < DP * ppb; i += kThreads) {
    const int a = i / ppb, q = q0 + i - a * ppb;
    if (q >= n) continue;
    const int qu = (q + 1 == n) ? 0 : q + 1;
    const int ql = (q == 0) ? n - 1 : q - 1;
    float yd = 0.f, yu = 0.f, yl = 0.f;
#pragma unroll
    for (int b = 0; b < DP; ++b) {
      const size_t o = (size_t)(a * DP + b) * n;
      yd = fmaf(__ldg(P.td + o + q), v[(size_t)b * n + q], yd);
      yu = fmaf(__ldg(P.tu + o + q), v[(size_t)b * n + qu], yu);
      yl = fmaf(__ldg(P.tl + o + q), v[(size_t)b * n + ql], yl);
    }
    float y = yd + yu + yl;
    if (P.mw > 0) {
      float wide = 0.f;
      for (int m = 0; m < P.mw; ++m)
        wide = fmaf(__ldg(P.u + ((size_t)a * P.mw + m) * n + q), S.urow[m], wide);
      y -= wide;
    }
    // the covering windows in (chunk, window) order, each over its row's
    // unit slots in order (side by side)
    float band = 0.f;
    const bool seg4 = P.seg % 4 == 0;
    for (int s = 0; s < cap; ++s) {
      const int cv = __ldg(P.cover + (size_t)q * cap + s);
      if (cv < 0) break;
      const float* wr = P.wpart + ((size_t)cv + (size_t)a * P.w_row) * P.seg;
      if (seg4) {
        const float4* wr4 = reinterpret_cast<const float4*>(wr);
        for (int k = 0; k < P.seg / 4; ++k) {
          const float4 w = wr4[k];
          band += w.x;
          band += w.y;
          band += w.z;
          band += w.w;
        }
      } else {
        for (int sg = 0; sg < P.seg; ++sg) band += wr[sg];
      }
    }
    y -= band;
    const size_t e = (size_t)a * n + q;
    P.ap[e] = y;
    part[0] = fmaf(pcur[e], y, part[0]);
  }
  put_partials<1>(P, buf, part, S.red);
}

// --- the preconditioner: z = M^-1 r ------------------------------------------

__device__ __forceinline__ int grid_warp() { return grid_thread() >> 5; }
__device__ __forceinline__ int grid_warps() { return grid_threads() >> 5; }

// Coarse restriction rc[b, g] = sum of r[b, p] over group g's poses: one
// warp per entry, lanes over the group, then the warp's sum tree.
template <int DP>
__device__ void coarse_restrict(const Params& P, const float* r) {
  const int n = P.np, G = P.group, lane = threadIdx.x & 31;
  for (int i = grid_warp(); i < DP * P.nc; i += grid_warps()) {
    const int b = i / P.nc, g = i - b * P.nc;
    const float* src = r + (size_t)b * n + (size_t)g * G;
    float acc = 0.f;
    for (int k = lane; k < G; k += 32) acc += src[k];
    acc = warp_sum(acc);
    if (lane == 0) P.rc[i] = acc;
  }
}

// Coarse solve za[a, g] = sum_{b, h} cinv[a, b, g, h] rc[b, h]: one warp
// per (a, g).
template <int DP>
__device__ void coarse_solve(const Params& P) {
  const int nc = P.nc, lane = threadIdx.x & 31;
  for (int q = grid_warp(); q < DP * nc; q += grid_warps()) {
    const int a = q / nc, g = q - a * nc;
    float acc = 0.f;
    for (int t = lane; t < DP * nc; t += 32) {
      const int b = t / nc, h = t - b * nc;
      acc = fmaf(__ldg(P.cinv + ((size_t)(a * DP + b) * nc + g) * nc + h),
                 P.rc[t], acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) P.za[q] = acc;
  }
}

// Shift 2^l mod n.
__device__ __forceinline__ int pcr_shift(int l, int n) { return (int)((1LL << l) % n); }

__device__ __forceinline__ int wrap(int q, int n) {
  return q < 0 ? q + n : (q >= n ? q - n : q);
}

// The update r := rn (into rdst) and z = M^-1 r, in max(ceil(L/2), 4 with a
// coarse level, 1) phases with a grid barrier between them.  Phase k runs
// PCR levels 2k and 2k+1: the thread of element (a, q) computes level 2k at
// q and q -+ 2^(2k+1) itself (the values level 2k+1 reads there; the same
// arithmetic as the threads that own them, so the same bits), and level
// 2k+1 at q.  Level 0 reads r through rn.  With a coarse level, phase 1
// also takes the restriction, phase 2 the coarse solve; the last phase
// binv, the coarse prolongation and this block's r . z and r . r into
// buffer `buf`.  Ends with a grid barrier.
template <int DP>
__device__ void precond_phases(const Params& P, cg::grid_group& grid, Timer& tm,
                               const RNew& rn, float* rdst, int buf,
                               const SmemPtrs& S) {
  const bool coarse = P.nc > 0;
  const int L = P.nlevels, n = P.np, nc = P.nc;
  const int nlp = (L + 1) / 2;   // phases with PCR levels
  const int nph = max(nlp, coarse ? 4 : 1);
  const int ppb = poses_per_block(n), q0 = blockIdx.x * ppb;
  // with at most one element per thread (and small blocks), binv is
  // loaded up front
  const bool one = DP <= 3 && DP * ppb <= kThreads;
  float cb[DP];
  {
    const int i = threadIdx.x, a = i / ppb, q = q0 + i - a * ppb;
    const bool mine = one && i < DP * ppb && q < n;
#pragma unroll
    for (int b = 0; b < DP; ++b)
      cb[b] = mine ? __ldg(P.binv + (size_t)(a * DP + b) * n + q) : 0.f;
  }
  float part[2] = {0.f, 0.f};
  for (int ph = 0; ph < nph; ++ph) {
    if (ph) gsync(grid, tm, kTPrecond);
    if (coarse && ph == 1) coarse_restrict<DP>(P, rdst);
    if (coarse && ph == 2) coarse_solve<DP>(P);
    // levels l0 (and l0 + 1) of this phase: input `tin` (level l0 - 1), or
    // rn for level 0; output of the phase's last level in `tout`
    const int l0 = 2 * ph;
    const bool pair = l0 + 1 < L;
    float* tout = (ph & 1) ? P.tb : P.ta;
    const float* tin = (ph & 1) ? P.ta : P.tb;
    auto tv = [&](int b, int q) {
      return ph ? tin[(size_t)b * n + q] : rn((size_t)b * n + q);
    };
    // level l0 at pose qc: its components a2 (all, or only `only`), each
    // handed to f(a2, value) as it is formed
    auto level0 = [&](int qc, int only, auto&& f) {
      const int s = pcr_shift(l0, n);
      const int qd = wrap(qc - s, n), qu = wrap(qc + s, n);
      float td[DP], tu[DP];
#pragma unroll
      for (int b = 0; b < DP; ++b) {
        td[b] = tv(b, qd);
        tu[b] = tv(b, qu);
      }
      const float* al = P.alphas + (size_t)l0 * DP * DP * n;
      const float* ga = P.gammas + (size_t)l0 * DP * DP * n;
#pragma unroll(DP <= 3 ? DP : 2)
      for (int a2 = 0; a2 < DP; ++a2) {
        if (only >= 0 && a2 != only) continue;
        float sa = 0.f, sg = 0.f;
#pragma unroll
        for (int b = 0; b < DP; ++b) {
          const size_t c = (size_t)(a2 * DP + b) * n + qc;
          sa = fmaf(__ldg(al + c), td[b], sa);
          sg = fmaf(__ldg(ga + c), tu[b], sg);
        }
        f(a2, tv(a2, qc) + sa + sg);
      }
    };
    if (ph == 0 || l0 < L) {
      for (int i = threadIdx.x; i < DP * ppb; i += kThreads) {
        const int a = i / ppb, q = q0 + i - a * ppb;
        if (q >= n) continue;
        const size_t e = (size_t)a * n + q;
        if (ph == 0) rdst[e] = rn(e);
        if (l0 >= L) continue;
        float uq = 0.f;
        level0(q, a, [&](int, float u) { uq = u; });
        if (!pair) {
          tout[e] = uq;
          continue;
        }
        // level l0 + 1 at q from level l0 at q -+ 2^(l0+1), consumed as
        // each component is formed
        const int s2 = pcr_shift(l0 + 1, n);
        const float* al = P.alphas + (size_t)(l0 + 1) * DP * DP * n;
        const float* ga = P.gammas + (size_t)(l0 + 1) * DP * DP * n;
        float sa = 0.f, sg = 0.f;
        level0(wrap(q - s2, n), -1, [&](int b, float u) {
          sa = fmaf(__ldg(al + (size_t)(a * DP + b) * n + q), u, sa);
        });
        level0(wrap(q + s2, n), -1, [&](int b, float u) {
          sg = fmaf(__ldg(ga + (size_t)(a * DP + b) * n + q), u, sg);
        });
        tout[e] = uq + sa + sg;
      }
    }
    if (ph == nph - 1) {
      __syncthreads();   // the block's last level and r complete
      const float* tf = L ? (((nlp - 1) & 1) ? P.tb : P.ta) : rdst;
      for (int i = threadIdx.x; i < DP * ppb; i += kThreads) {
        const int a = i / ppb, q = q0 + i - a * ppb;
        if (q >= n) continue;
        float acc = 0.f;
#pragma unroll
        for (int b = 0; b < DP; ++b) {
          const float bi = one ? cb[b] : __ldg(P.binv + (size_t)(a * DP + b) * n + q);
          acc = fmaf(bi, tf[(size_t)b * n + q], acc);
        }
        if (coarse) acc += P.za[a * nc + q / P.group];
        const size_t e = (size_t)a * n + q;
        P.z[e] = acc;
        const float re = rdst[e];
        part[0] = fmaf(re, acc, part[0]);
        part[1] = fmaf(re, re, part[1]);
      }
    }
  }
  put_partials<2>(P, buf, part, S.red);
  gsync(grid, tm, kTPrecond);
}

// --- the kernel ------------------------------------------------------------------

// W4: float4 columns of a band (the cluster-band schedule), or 0 for the
// slab schedule.
template <int DP, int W4>
__global__ void __launch_bounds__(kThreads, 1)
band_fused_pcg_chunk_kernel(const __grid_constant__ Params P) {
  extern __shared__ __align__(1024) float smem[];
  const Smem SL = smem_layout(P.pr, P.cols, P.slots, P.mw);
  const SmemPtrs S{smem + SL.ring, smem + SL.xs, smem + SL.tp, smem + SL.ts,
                   reinterpret_cast<float4*>(smem + SL.comb), smem + SL.urow,
                   smem + SL.red,
                   reinterpret_cast<unsigned long long*>(smem + SL.bars)};
  cg::grid_group grid = cg::this_grid();
  Timer tm;
  tm.on = P.timing != nullptr && threadIdx.x == 0;
  tm.t = tm.on ? clock64() : 0;
#pragma unroll
  for (int k = 0; k < kTimers; ++k) tm.acc[k] = 0;
  const int n = P.np;
  // the ring's mbarriers, and the first trip's first parts, copied while
  // the chunk entry runs
  long long parts_base = 0;
  if constexpr (W4 == 0) {
    if ((int)blockIdx.x < P.units)
      for (int q = 0; q < kParts; ++q) load_slab_part(P, S, blockIdx.x, q);
  } else {
    if (threadIdx.x == 0) {
      for (int s = 0; s < P.slots; ++s) mbar_init(S.bars + s);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      const Share sh = block_share(P);
      for (int g = 0; g < min(P.slots, sh.bands * P.parts); ++g)
        issue_part(P, S, sh, 0, g, false);
    }
    __syncthreads();
  }
  for (int e = grid_thread(); e < DP * n; e += grid_threads()) P.x[e] = P.x_in[e];

  // chunk entry: restart replaces the recurrence residual with the carried
  // true residual and resets the search direction
  int buf = 0;   // partial-sum buffer, alternated per grid-wide sum
  float rr, rz;
  PDir pd{P.z, P.p_in, 0.f, 0};
  if (P.restart != 0) {
    precond_phases<DP>(P, grid, tm, RNew{P.rt_in, nullptr, 0.f}, P.ra, buf, S);
    float s2[2];
    grid_totals<2>(P, buf, s2, S.red);
    buf ^= 1;
    rz = s2[0];
    rr = s2[1];
    pd.mode = 1;
  } else {
    float s1[1] = {0.f};
    for (int e = grid_thread(); e < DP * n; e += grid_threads()) {
      const float re = P.r_in[e];
      P.ra[e] = re;
      s1[0] = fmaf(re, re, s1[0]);
    }
    put_partials<1>(P, buf, s1, S.red);
    gsync(grid, tm, kTOther);
    grid_totals<1>(P, buf, s1, S.red);
    buf ^= 1;
    rr = s1[0];
    rz = *P.rz_in;
  }
  bool stop = *P.stop_in > 0;
  int it = *P.it_in;
  const float atol2 = *P.atol2;
  float rr_true = 0.f;
  float* rcur = P.ra;
  float* rnext = P.rb;

  for (int i = 0; i <= P.chunk_iters; ++i) {
    const bool last = i == P.chunk_iters;
    // p ping-pong, arranged so that the last trip's p lands in P.p
    float* pnew = ((P.chunk_iters - i) & 1) ? P.pb : P.p;
    tm.lap(kTOther);
    const VIn v{P.x, pd, last};
    if constexpr (W4 == 0)
      phase_slabs<DP>(P, grid, v, pnew, !last, S, tm);
    else
      phase_bands<DP, W4>(P, grid, v, pnew, !last, S, tm, &parts_base);
    gsync(grid, tm, kTOther);
    phase_gather<DP>(P, last ? P.x : pnew, pnew, buf, S);
    gsync(grid, tm, kTGather);
    float sp[1];
    grid_totals<1>(P, buf, sp, S.red);
    buf ^= 1;
    const float pap = sp[0];
    if (!last) stop = stop || !(pap > 0.f) || !isfinite(pap);
    const bool done = last || stop || (rr <= atol2) || (it >= P.maxit);
    const float alpha = done ? 0.f : rz / pap;
    if (last) {
      float st[1] = {0.f};
      for (int e = grid_thread(); e < DP * n; e += grid_threads()) {
        const float ape = P.ap[e];
        P.x[e] = fmaf(alpha, pnew[e], P.x[e]);
        P.r[e] = fmaf(-alpha, ape, rcur[e]);
        const float rte = P.rhs[e] - ape;
        P.rt[e] = rte;
        st[0] = fmaf(rte, rte, st[0]);
      }
      put_partials<1>(P, buf, st, S.red);
      gsync(grid, tm, kTOther);
      grid_totals<1>(P, buf, st, S.red);
      rr_true = st[0];
      break;
    }
    for (int e = grid_thread(); e < DP * n; e += grid_threads())
      P.x[e] = fmaf(alpha, pnew[e], P.x[e]);
    precond_phases<DP>(P, grid, tm, RNew{rcur, P.ap, alpha}, rnext, buf, S);
    float s2[2];
    grid_totals<2>(P, buf, s2, S.red);
    buf ^= 1;
    const float rz_new = s2[0];
    rr = s2[1];
    const float safe_rz = (rz == 0.f) ? 1.f : rz;
    const float beta = done ? 0.f : rz_new / safe_rz;
    pd = PDir{P.z, pnew, beta, done ? 0 : 2};
    rz = done ? rz : rz_new;
    it += done ? 0 : 1;
    float* t = rcur;
    rcur = rnext;
    rnext = t;
  }

  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *P.it_out = it;
    *P.rz_out = rz;
    *P.stop_out = stop ? 1 : 0;
    *P.rr_out = rr_true;
  }
  if (tm.on) {
    tm.lap(kTOther);
    for (int k = 0; k < kTimers; ++k) P.timing[blockIdx.x * kTimers + k] = tm.acc[k];
  }
}

// `iters` grid barriers and nothing else, on the same grid: the cost of one.
__global__ void __launch_bounds__(kThreads, 1) grid_sync_probe_kernel(int iters) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < iters; ++i) grid.sync();
}

using KernelFn = void (*)(Params);

// The instantiation for a pose block size, band width and schedule (null
// for one that is not built).  Built: those a path's plan takes
// (ops/fused_pcg.py::BAND_COLS): slabs at DP 3 and 6, and cluster bands of
// 64 and 128 columns at DP 3.
KernelFn kernel_for(int dp, int cols, bool slab) {
  if (slab) {
    if (dp == 3) return band_fused_pcg_chunk_kernel<3, 0>;
    if (dp == 6) return band_fused_pcg_chunk_kernel<6, 0>;
    return nullptr;
  }
  if (dp != 3) return nullptr;
  if (cols == 64) return band_fused_pcg_chunk_kernel<3, 16>;
  if (cols == 128) return band_fused_pcg_chunk_kernel<3, 32>;
  return nullptr;
}

bool valid_cluster(int cluster) {
  return cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8 ||
         cluster == kMaxCluster;
}

// cols: on the cluster-band schedule two or four whole TMA boxes of 32
// columns; on the slab schedule a multiple of 4 up to a float4 per thread
bool valid_cols(int cols, bool slab) {
  if (slab) return cols >= 4 && cols % 4 == 0 && cols <= 4 * kThreads;
  return cols == 64 || cols == 128;
}

// dims: dp np n_chunks k_win w_row b_dl mw nlevels nc cover_cap chunk_iters
// maxit restart grid cluster cols segments group slots slab
bool valid_dims(const int* d) {
  const long long rows = (long long)d[3] * d[0] * d[4];
  const bool slab = d[19] != 0;
  if (kernel_for(d[0], d[15], slab) == nullptr || d[1] < 1 || d[2] < 1 ||
      d[3] < 1 || d[4] < 1 || d[5] < 128 || d[5] % 128 || d[6] < 0 ||
      d[7] < 0 || d[7] >= 62 || d[8] < 0 || d[9] < 1 || d[10] < 0 ||
      d[12] < 0 || d[13] < 1 || !valid_cluster(d[14]) || d[13] % d[14] ||
      !valid_cols(d[15], slab) || d[5] % d[15] || d[16] < 1 ||
      (d[5] / d[15]) % d[16] || rows % 4 || rows * d[2] * d[16] >= (1LL << 31))
    return false;
  if (d[8] > 0 && ((long long)d[17] * d[8] != d[1] || d[17] < 1)) return false;
  // a slab is one block's unit: a whole chunk's rows, one slab a segment
  if (slab) return d[14] == 1 && d[16] == d[5] / d[15];
  // the ring holds at least one band's parts
  const RowSplit rs = row_split((int)rows, d[14]);
  return rs.parts <= kMaxParts && d[18] >= rs.parts && d[18] <= kMaxSlots;
}

// cuTensorMapEncodeTiled through the runtime's entry-point query (no link
// against libcuda).
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*,
                                   const cuuint32_t*, const cuuint32_t*,
                                   CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
  if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                              &found) != cudaSuccess ||
      found != cudaDriverEntryPointSuccess)
    return nullptr;
  return (EncodeTiledFn)fn;
}

// The shared memory and the non-portable cluster size (16) a function may
// take.
cudaError_t set_attributes(const void* fn, size_t smem_bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

cudaLaunchConfig_t launch_config(int grid, int cluster, size_t smem_bytes,
                                 cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cfg;
}

}  // namespace

extern "C" {

// The device's SM count and opt-in shared memory per block.  Returns a
// cudaError_t.
int band_fused_pcg_chunk_device(int device, int* sms, int* smem_optin) {
  cudaError_t err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                     device);
}

// Dynamic shared memory of one block, in bytes (the slab schedule: pr the
// chunk's rows, one slot).
long long band_fused_pcg_chunk_smem_bytes(int pr, int cols, int slots, int mw) {
  return (long long)smem_layout(pr, cols, slots, mw).total;
}

// Clusters of `cluster` blocks of the (dp, cols, slab) instantiation that
// the card runs at once at `smem_bytes` per block (the cooperative grid is
// that many), or 0 when none fits or the device cannot launch
// cooperatively.  Returns a cudaError_t.
int band_fused_pcg_chunk_clusters(int dp, int cols, int slab, int device,
                                  long long smem_bytes, int cluster, int* count) {
  *count = 0;
  const KernelFn kernel = kernel_for(dp, cols, slab != 0);
  if (kernel == nullptr || !valid_cluster(cluster)) return (int)cudaErrorInvalidValue;
  int sms = 0, coop = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return 0;
  err = set_attributes((const void*)kernel, (size_t)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg =
      launch_config(cluster * sms, cluster, (size_t)smem_bytes, nullptr, attr);
  return (int)cudaOccupancyMaxActiveClusters(count, kernel, &cfg);
}

// The (dp, cols, slab) instantiation as the card compiled it: out[0] its
// registers a thread, out[1] its local memory a thread (spilled registers).
// Returns a cudaError_t.
int band_fused_pcg_chunk_attrs(int dp, int cols, int slab, long long* out) {
  const KernelFn kernel = kernel_for(dp, cols, slab != 0);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = (long long)fa.numRegs;
  out[1] = (long long)fa.localSizeBytes;
  return 0;
}

// Floats of workspace one launch needs (< 0 for dimensions the kernel does
// not take).
long long band_fused_pcg_chunk_workspace_floats(const int* dims, int ndims) {
  if (ndims != kNumDims || !valid_dims(dims)) return -1;
  const int rows = dims[3] * dims[0] * dims[4];
  return (long long)layout(dims[0], dims[1], dims[2], rows, dims[2] * dims[16],
                           dims[6], dims[8], dims[13]).total;
}

// `iters` grid barriers on a cooperative grid of `grid` blocks in clusters
// of `cluster` at the band kernel's shared memory (the grid from
// band_fused_pcg_chunk_clusters).
int band_grid_sync_probe(int grid, int cluster, long long smem_bytes, int iters,
                         void* stream) {
  if (!valid_cluster(cluster) || grid % cluster) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_attributes((const void*)grid_sync_probe_kernel, (size_t)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg = launch_config(grid, cluster, (size_t)smem_bytes,
                                               (cudaStream_t)stream, attr);
  err = cudaLaunchKernelEx(&cfg, grid_sync_probe_kernel, iters);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Launch one chunk of the dims[0] instantiation (dp = 3 or 6) on `stream` as
// a cooperative grid of dims[13] blocks in clusters of dims[14], on the
// slab schedule when dims[19] (tiles: the slab-major copy), else on the
// cluster-band schedule (tiles: the stack as built).
// ptrs: atol2 it rz stop rhs x r p rt | tiles win_off cover u td tu tl
// alphas gammas binv cinv | x r p rt it rz stop rr (outputs) | workspace |
// timing (or null).  Returns a cudaError_t (0 = launched).
int band_fused_pcg_chunk_launch(const int* dims, int ndims, void* const* ptrs,
                                int nptrs, void* stream) {
  if (ndims != kNumDims || nptrs != kNumPtrs || !valid_dims(dims))
    return (int)cudaErrorInvalidValue;
  const int dp = dims[0], np = dims[1], n_chunks = dims[2], k_win = dims[3],
            w_row = dims[4], b_dl = dims[5], mw = dims[6], nlevels = dims[7],
            nc = dims[8], grid = dims[13], cluster = dims[14], cols = dims[15],
            seg = dims[16];
  const bool has_coarse = ptrs[19] != nullptr;
  if (has_coarse != (nc > 0) || (mw > 0) != (ptrs[12] != nullptr) ||
      (nlevels > 0 && ptrs[16] == nullptr))
    return (int)cudaErrorInvalidValue;
  // every pointer but u, alphas, gammas, cinv and timing is required
  static const int kRequired[] = {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11,
                                  13, 14, 15, 18, 20, 21, 22, 23, 24, 25, 26, 27, 28};
  for (int i : kRequired)
    if (ptrs[i] == nullptr) return (int)cudaErrorInvalidValue;
  // the 16-byte copies need aligned tiles and workspace
  if (((uintptr_t)ptrs[9] & 15) || ((uintptr_t)ptrs[28] & 15))
    return (int)cudaErrorInvalidValue;

  const int rows = k_win * dp * w_row;
  const int units = n_chunks * seg;
  const Layout L = layout(dp, np, n_chunks, rows, units, mw, nc, grid);
  float* ws = (float*)ptrs[28];
  Params P;
  P.np = np; P.n_chunks = n_chunks; P.k_win = k_win; P.w_row = w_row;
  P.b_dl = b_dl; P.mw = mw; P.nlevels = nlevels; P.nc = nc;
  P.cover_cap = dims[9]; P.chunk_iters = dims[10]; P.maxit = dims[11];
  P.restart = dims[12];
  // the slab schedule: one block, one part of all the rows, one slot
  const bool slab = dims[19] != 0;
  const RowSplit rs = slab ? RowSplit{1, rows} : row_split(rows, cluster);
  P.rows = rows; P.cluster = cluster; P.rpb = rs.parts * rs.pr;
  P.cols = cols;
  P.lw4 = 0;
  while ((4 << P.lw4) < cols) ++P.lw4;
  P.seg = seg; P.nbu = b_dl / cols / seg; P.units = units;
  P.parts = rs.parts; P.pr = rs.pr; P.slots = slab ? 1 : dims[18];
  P.group = nc > 0 ? dims[17] : 1;
  P.atol2 = (const float*)ptrs[0];
  P.it_in = (const int*)ptrs[1];
  P.rz_in = (const float*)ptrs[2];
  P.stop_in = (const int*)ptrs[3];
  P.rhs = (const float*)ptrs[4];
  P.x_in = (const float*)ptrs[5];
  P.r_in = (const float*)ptrs[6];
  P.p_in = (const float*)ptrs[7];
  P.rt_in = (const float*)ptrs[8];
  P.tiles = (const float*)ptrs[9];
  P.win_off = (const int*)ptrs[10];
  P.cover = (const int*)ptrs[11];
  P.u = (const float*)ptrs[12];
  P.td = (const float*)ptrs[13];
  P.tu = (const float*)ptrs[14];
  P.tl = (const float*)ptrs[15];
  P.alphas = (const float*)ptrs[16];
  P.gammas = (const float*)ptrs[17];
  P.binv = (const float*)ptrs[18];
  P.cinv = (const float*)ptrs[19];
  P.x = (float*)ptrs[20];
  P.r = (float*)ptrs[21];
  P.p = (float*)ptrs[22];
  P.rt = (float*)ptrs[23];
  P.it_out = (int*)ptrs[24];
  P.rz_out = (float*)ptrs[25];
  P.stop_out = (int*)ptrs[26];
  P.rr_out = (float*)ptrs[27];
  P.timing = (long long*)ptrs[29];
  P.ap = ws + L.ap;
  P.z = ws + L.z;
  P.ta = ws + L.ta;
  P.tb = ws + L.tb;
  P.ra = ws + L.ra;
  P.rb = ws + L.rb;
  P.pb = ws + L.pb;
  P.xwin = ws + L.xwin;
  P.wpart = ws + L.wpart;
  P.widepart = ws + L.widepart;
  P.rc = ws + L.rc;
  P.za = ws + L.za;
  P.partials = ws + L.partials;

  if (!slab) {
    // the stack as a 2D tensor [n_chunks * rows, B*dl], read in boxes of
    // [pr, 32] swizzled 128B (see ring_slot)
    static const EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return (int)cudaErrorNotSupported;
    const cuuint64_t gdim[2] = {(cuuint64_t)b_dl, (cuuint64_t)n_chunks * rows};
    const cuuint64_t gstride[1] = {(cuuint64_t)b_dl * sizeof(float)};
    const cuuint32_t box[2] = {(cuuint32_t)kBoxCols, (cuuint32_t)P.pr};
    const cuuint32_t estride[2] = {1, 1};
    if (encode(&P.tmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)ptrs[9], gdim,
               gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  const size_t bytes = smem_layout(P.pr, cols, P.slots, mw).total;
  const KernelFn kernel = kernel_for(dp, cols, slab);
  cudaError_t err = set_attributes((const void*)kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg =
      launch_config(grid, cluster, bytes, (cudaStream_t)stream, attr);
  err = cudaLaunchKernelEx(&cfg, kernel, P);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
