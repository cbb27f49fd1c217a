// One chunk of preconditioned conjugate gradients on the damped reduced pose
// system S = T - V V^T of a large graph, with V streamed from the banded tile
// stack, on a persistent cooperative grid of one block per SM.
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
//     rmat cinv rmat^T.  All f32 (the reference keeps the PCR planes in
//     bf16 to fit its on-chip memory; there is no such limit here).
//
// What bounds it on an H100: streaming the tile stack from device memory.
// At the 10k-pose graph the stack is [39, 2, 3, 512, 512] f32 = 245 MB, five
// times the 50 MB L2, so every matvec must read it from HBM once: 73 us at
// the card's 3.35 TB/s.
//
// How it reads the stack once per matvec, with no wait between blocks.  A
// chunk's rows (k, a, w) -- `rows` = K*DP*Wrow of them -- are cut by
// COLUMNS into slabs of `cols` columns and all the rows (ops/fused_pcg.py::
// band_slab_plan picks the widest that fits in shared memory: 3072 x 16
// floats = 196 KB at 10k poses).  t restricted to a slab's columns needs
// only that slab, and so does the slab's part of the w-pass, rows . t over
// its columns.  The wrapper hands the kernel the stack re-laid slab-major
// (once per stack), so a slab is one contiguous run.  Block b takes slabs
// b, b + grid, ... and for each
//   1. copies it into shared memory with 16-byte asynchronous copies
//      (cp.async, bypassing L1) in four row parts, each its own group, the
//      parts issued while the previous slab's w-pass frees them;
//   2. accumulates the partial t over each part as it lands;
//   3. does the w-pass from shared memory into its own slot of wpart
//      [n_chunks * rows, slabs per chunk].
// The gather sums a window row's slots (contiguous) in slab order.  The
// matvec input at the window rows (x, or this trip's p) is laid out once
// per trip in xwin, behind one grid barrier, and copied with each slab.
//
// Grid barriers per CG trip: xwin | slabs | gather (ap, p.ap) | update +
// PCR levels 0-1 + the blocks' coarse restriction shares | one per further
// pair of PCR levels (the shares' sum beside the first, the coarse solve
// beside the second) | the preconditioner end (z, r.z, r.r) -- 10 at
// L=14.  The p update is folded into the next trip's first phase (p is
// double buffered), the x/r update into the first preconditioner phase (r
// is double buffered; level 0 recomputes r at its neighbours), and every
// per-pose phase gives a block the same poses, so the last PCR level's
// output and the new r are read back only by the block that wrote them.
//
// Determinism: no atomics.  Every sum has a fixed order: t over a slab's
// rows, w per window row and slab, a per-pose sum over the covering windows
// in (chunk, window) order from a static table (`cover`, built once per
// graph structure) and over the slabs in order, and the dot products as
// per-block partials summed in block order by every block.  Runs repeat bit
// for bit at one grid size.
//
// Instantiated for DP = 3 (SE(2) poses) and DP = 6 (SE(3) bundle
// adjustment); the C entry points dispatch on dp.  At the 512-pose,
// 4096-point BA graph a chunk holds K*DP*Wrow = 4*6*128 = 3072 rows, so a
// slab is 16 columns wide (24 slabs per chunk) and each block owns four
// poses in the per-pose phases.
//
// Built with nvcc for sm_90a, WITHOUT --use_fast_math: the breakdown test
// needs isfinite() to see NaN/inf, and alpha/beta need IEEE division.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kParts = 4;         // row parts of a slab, one copy group each
constexpr int kWideSeg = 1024;    // poses per wide-column partial
constexpr int kPartialSlots = 4;  // floats per block in a partial-sum buffer
constexpr int kRedFloats = 64;
constexpr int kTimers = 9;        // see the enum below Timer

constexpr int kNumDims = 15;
constexpr int kNumPtrs = 31;

struct Params {
  int np, n_chunks, k_win, w_row, b_dl, mw, nlevels, nc, cover_cap;
  int chunk_iters, maxit, restart;
  int rows, cols, spc;   // rows per chunk (K*DP*Wrow), columns per slab, slabs per chunk
  const float* atol2;
  const int* it_in;
  const float* rz_in;
  const int* stop_in;
  const float* rhs;
  const float* x_in;
  const float* r_in;
  const float* p_in;
  const float* rt_in;
  const float* tiles;    // slab-major: [n_chunks, B*dl / cols, K*DP*Wrow, cols]
  const int* win_off;    // [n_chunks, K]
  const int* cover;      // [Np, cap] wpart offsets (component 0), -1 pads
  const float* u;        // [DP, Mw, Np] or null
  const float* td;       // [DP, DP, Np]
  const float* tu;
  const float* tl;
  const float* alphas;   // [L, DP, DP, Np]
  const float* gammas;
  const float* binv;     // [DP, DP, Np]
  const float* cinv;     // [DP, DP, nc, nc] or null
  const float* rmat;     // [Np, nc] or null
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
  float* wpart;     // [n_chunks, rows, spc] w-pass rows per slab
  float* widepart;  // [n_wseg, Mw]
  float* rcpart;    // [grid, DP, nc] per-block restriction shares
  float* rc;        // [DP, nc]
  float* za;        // [DP, nc]
  float* partials;  // [2, grid, kPartialSlots]
};

struct Layout {
  size_t ap, z, ta, tb, ra, rb, pb, xwin, wpart, widepart, rcpart, rc, za,
      partials, total;
};

__host__ __device__ inline int n_wseg(int np) { return (np + kWideSeg - 1) / kWideSeg; }
__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

Layout layout(int dp, int np, int n_chunks, int rows, int spc, int mw,
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
  L.wpart = o; o += (size_t)spc * n_chunks * rows;
  L.widepart = o; o += (size_t)n_wseg(np) * mw;
  L.rcpart = o; o += (size_t)grid * dp * nc;
  L.rc = o; o += (size_t)dp * nc;
  L.za = o; o += (size_t)dp * nc;
  L.partials = o; o += (size_t)2 * grid * kPartialSlots;
  L.total = o;
  return L;
}

// Shared memory of one block in floats: the slab [rows, cols], the state
// values of its rows, t over its columns, the row-group combination buffer,
// u^T v, reduction slots (mirrored by band_smem_bytes in ops/fused_pcg.py).
struct Smem {
  size_t slab, xs, ts, comb, urow, red, total;
};

__host__ __device__ inline Smem smem_layout(int rows, int cols, int mw) {
  Smem S;
  size_t o = 0;   // in floats
  S.slab = o; o += (size_t)rows * cols;
  S.xs = o; o += round4(rows);
  S.ts = o; o += round4(cols);
  S.comb = o; o += 4 * kThreads;
  S.urow = o; o += round4(mw);
  S.red = o; o += kRedFloats;
  S.total = o * sizeof(float);
  return S;
}

// --- PTX helpers: asynchronous 16-byte copies ------------------------------

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

__device__ __forceinline__ float4 f4add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 f4fma(float s, float4 b, float4 a) {
  return make_float4(fmaf(s, b.x, a.x), fmaf(s, b.y, a.y), fmaf(s, b.z, a.z),
                     fmaf(s, b.w, a.w));
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
// laying out xwin, waiting for slab copies, partial t, w-pass, wide
// columns, gather, preconditioner work, grid barriers, the rest
enum {
  kTXwin = 0, kTCopyWait = 1, kTPartial = 2, kTWpass = 3, kTWide = 4,
  kTGather = 5, kTPrecond = 6, kTSync = 7, kTOther = 8
};

__device__ __forceinline__ void gsync(cg::grid_group& grid, Timer& tm, int kind) {
  tm.lap(kind);
  grid.sync();
  tm.lap(kTSync);
}

struct SmemPtrs {
  float* slab;
  float* xs;
  float* ts;
  float4* comb;
  float* urow;
  float* red;
};

// --- the matvec: out = S v ------------------------------------------------------

__device__ __forceinline__ int part_rows(const Params& P) {
  return (P.rows + kParts - 1) / kParts;
}

// All threads: start copying row part q of slab `slab` (one contiguous run
// of the slab-major stack) into shared memory, as one copy group.
__device__ void load_part(const Params& P, const SmemPtrs& S, int slab, int q) {
  const int pr = part_rows(P);
  const size_t f0 = (size_t)q * pr * P.cols;
  const size_t f1 = (size_t)min(P.rows, (q + 1) * pr) * P.cols;
  const float* base = P.tiles + (size_t)slab * P.rows * P.cols;
  for (size_t f = f0 + 4 * threadIdx.x; f < f1; f += 4 * kThreads)
    cp_async16(S.slab + f, base + f);
  cp_async_commit();
}

// All threads: start copying the state values of slab `slab`'s chunk from
// xwin, as one copy group.
__device__ void load_xs(const Params& P, const SmemPtrs& S, int slab) {
  const int c = slab / P.spc;
  const float* src = P.xwin + (size_t)c * P.rows;
  for (int i = threadIdx.x; i < P.rows / 4; i += kThreads)
    cp_async16(S.xs + 4 * i, src + 4 * i);
  cp_async_commit();
}

// Phase 1 of a trip: this trip's p into `pnew`, the matvec input v at the
// window rows into xwin (grid barrier), then the slabs' t and w-pass (see
// the header) and the wide-column partials of v.  The row parts of the
// block's first slab were issued before the phase; with `prefetch` the
// next trip's are issued at its end.
template <int DP>
__device__ void phase_slabs(const Params& P, cg::grid_group& grid,
                            const PDir& pd, bool last, float* pnew,
                            bool prefetch, const SmemPtrs& S, Timer& tm) {
  const int n = P.np, tid = threadIdx.x;
  const int ppb = poses_per_block(n), q0 = blockIdx.x * ppb;
  for (int i = tid; i < DP * ppb; i += kThreads) {
    const int a = i / ppb, q = q0 + i - a * ppb;
    if (q < n) pnew[(size_t)a * n + q] = pd((size_t)a * n + q);
  }
  const float* xv = P.x;
  auto v = [&](size_t i) { return last ? xv[i] : pd(i); };
  // v at every window row (k, a, w) of every chunk; zero past Np
  for (int idx = grid_thread(); idx < P.n_chunks * P.rows; idx += grid_threads()) {
    const int c = idx / P.rows, rho = idx - c * P.rows;
    const int ka = rho / P.w_row, w = rho - ka * P.w_row;
    const int kw = ka / DP, a = ka - kw * DP;
    const int q = __ldg(P.win_off + c * P.k_win + kw) + w;
    P.xwin[idx] = q < n ? v((size_t)a * n + q) : 0.f;
  }
  gsync(grid, tm, kTXwin);

  const int n_slabs = P.n_chunks * P.spc, pr = part_rows(P);
  const int cols = P.cols, w4 = cols / 4;
  const int H = kThreads / w4;          // row groups of the partial t
  const int c4 = tid % w4, h = tid / w4;
  const float4* slab4 = reinterpret_cast<const float4*>(S.slab);
  const float4* ts4 = reinterpret_cast<const float4*>(S.ts);
  bool first = true;
  for (int g = blockIdx.x; g < n_slabs; g += gridDim.x) {
    const int c = g / P.spc, sc = g - c * P.spc;
    if (first) {
      // its parts were issued before the phase, its state values now
      load_xs(P, S, g);
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
    if (gn < n_slabs) load_xs(P, S, gn);   // xs is free: the next slab's
    // the w-pass: one thread per row, rows . t over the slab's columns,
    // part by part; each freed part takes the next slab's rows
    float* wdst = P.wpart + (size_t)c * P.rows * P.spc + sc;
    for (int q = 0; q < kParts; ++q) {
      const int r1 = min(P.rows, (q + 1) * pr);
      for (int r = q * pr + tid; r < r1; r += kThreads) {
        // the row's float4s from a rotated start: fewer bank conflicts
        const float4* row = slab4 + (size_t)r * w4;
        float s = 0.f;
        if (w4 == 4) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int kk = (k + r) & 3;
            const float4 a = row[kk], b = ts4[kk];
            s = fmaf(a.x, b.x, s);
            s = fmaf(a.y, b.y, s);
            s = fmaf(a.z, b.z, s);
            s = fmaf(a.w, b.w, s);
          }
        } else {
          int kk = r % w4;
          for (int k = 0; k < w4; ++k) {
            const float4 a = row[kk], b = ts4[kk];
            s = fmaf(a.x, b.x, s);
            s = fmaf(a.y, b.y, s);
            s = fmaf(a.z, b.z, s);
            s = fmaf(a.w, b.w, s);
            if (++kk == w4) kk = 0;
          }
        }
        wdst[(size_t)r * P.spc] = s;
      }
      __syncthreads();
      if (gn < n_slabs) load_part(P, S, gn, q);
    }
    tm.lap(kTWpass);
    first = false;
  }

  // wide columns: widepart[s, m] = sum_{a, p in segment s} v[a,p] u[a,m,p],
  // on the blocks with the fewest slabs first
  const int nseg = n_wseg(n);
  const int n_wide = P.mw * nseg;
  for (int item = (int)gridDim.x - 1 - (int)blockIdx.x; item < n_wide;
       item += gridDim.x) {
    const int m = item / nseg, sg = item - m * nseg;
    const int p0 = sg * kWideSeg, p1 = min(n, p0 + kWideSeg);
    float accw[1] = {0.f};
    for (int q = p0 + tid; q < p1; q += kThreads) {
#pragma unroll
      for (int a = 0; a < DP; ++a)
        accw[0] = fmaf(v((size_t)a * n + q),
                       __ldg(P.u + ((size_t)a * P.mw + m) * n + q), accw[0]);
    }
    block_sum<1>(accw, S.red);
    if (tid == 0) P.widepart[(size_t)sg * P.mw + m] = accw[0];
  }
  if (prefetch && (int)blockIdx.x < n_slabs) {
    for (int q = 0; q < kParts; ++q) load_part(P, S, blockIdx.x, q);
  }
  tm.lap(kTWide);
}

// Phase 2: ap = (T v - u urow) - band rows, and this block's p . ap.
template <int DP>
__device__ void phase_gather(const Params& P, const float* v, const float* pcur,
                             int buf, const SmemPtrs& S) {
  const int n = P.np, cap = P.cover_cap, nseg = n_wseg(n);
  const bool spc4 = P.spc % 4 == 0;
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
    {
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
      // the covering windows in (chunk, window) order, each over the slabs
      float band = 0.f;
      for (int s = 0; s < cap; ++s) {
        const int cv = __ldg(P.cover + (size_t)q * cap + s);
        if (cv < 0) break;
        const float* wr = P.wpart + ((size_t)cv + (size_t)a * P.w_row) * P.spc;
        if (spc4) {
          const float4* wr4 = reinterpret_cast<const float4*>(wr);
#pragma unroll 8
          for (int k = 0; k < P.spc / 4; ++k) {
            const float4 w = wr4[k];
            band += w.x;
            band += w.y;
            band += w.z;
            band += w.w;
          }
        } else {
          for (int sl = 0; sl < P.spc; ++sl) band += wr[sl];
        }
      }
      y -= band;
      const size_t e = (size_t)a * n + q;
      P.ap[e] = y;
      part[0] = fmaf(pcur[e], y, part[0]);
    }
  }
  put_partials<1>(P, buf, part, S.red);
}

// --- the preconditioner: z = M^-1 r ------------------------------------------

// Coarse restriction, part 1: this block's share of rc[b, g] =
// sum_p r[b, p] rmat[p, g] over its own poses, from the updated r it has
// just written (block barrier before), into rcpart[block].
template <int DP>
__device__ void coarse_restrict_part(const Params& P, const float* r) {
  const int n = P.np, nc = P.nc;
  const int ppb = poses_per_block(n), q0 = blockIdx.x * ppb;
  const int q1 = min(n, q0 + ppb);
  float* dst = P.rcpart + (size_t)blockIdx.x * DP * nc;
  for (int i = threadIdx.x; i < DP * nc; i += kThreads) {
    const int b = i / nc, g = i - b * nc;
    float acc = 0.f;
#pragma unroll 8
    for (int q = q0; q < q1; ++q)
      acc = fmaf(r[(size_t)b * n + q], __ldg(P.rmat + (size_t)q * nc + g), acc);
    dst[i] = acc;
  }
}

// Coarse restriction, part 2: rc = the blocks' shares summed in block
// order, one block per entry.
template <int DP>
__device__ void coarse_restrict_sum(const Params& P, float* red) {
  const int m = DP * P.nc;
  for (int i = blockIdx.x; i < m; i += gridDim.x) {
    float acc[1] = {0.f};
    for (int bb = threadIdx.x; bb < (int)gridDim.x; bb += kThreads)
      acc[0] += P.rcpart[(size_t)bb * m + i];
    block_sum<1>(acc, red);
    if (threadIdx.x == 0) P.rc[i] = acc[0];
  }
}

// Coarse solve za[a, g] = sum_{b, h} cinv[a, b, g, h] rc[b, h]: one block
// per (a, g).
template <int DP>
__device__ void coarse_solve(const Params& P, float* red) {
  const int nc = P.nc;
  for (int q = blockIdx.x; q < DP * nc; q += gridDim.x) {
    const int a = q / nc, g = q - a * nc;
    float acc[1] = {0.f};
    for (int t = threadIdx.x; t < DP * nc; t += blockDim.x) {
      const int b = t / nc, h = t - b * nc;
      acc[0] = fmaf(__ldg(P.cinv + ((size_t)(a * DP + b) * nc + g) * nc + h),
                    P.rc[t], acc[0]);
    }
    block_sum<1>(acc, red);
    if (threadIdx.x == 0) P.za[q] = acc[0];
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
// 2k+1 at q.  Level 0 reads r through rn.  With a coarse level, phase 0
// also takes the blocks' restriction shares, phase 1 their sum, phase 2
// the coarse solve; the last phase binv, the coarse prolongation and this
// block's r . z and r . r into buffer `buf`.  Ends with a grid barrier.
template <int DP>
__device__ void precond_phases(const Params& P, cg::grid_group& grid, Timer& tm,
                               const RNew& rn, float* rdst, int buf,
                               const SmemPtrs& S) {
  const bool coarse = P.nc > 0;
  const int L = P.nlevels, n = P.np, nc = P.nc;
  const int nlp = (L + 1) / 2;   // phases with PCR levels
  const int nph = max(nlp, coarse ? 4 : 1);
  const int ppb = poses_per_block(n), q0 = blockIdx.x * ppb;
  // with at most one element per thread, binv is loaded up front
  const bool one = DP * ppb <= kThreads;
  float cb[DP];
  auto load_binv = [&](int a, int q) {
#pragma unroll
    for (int b = 0; b < DP; ++b) cb[b] = __ldg(P.binv + (size_t)(a * DP + b) * n + q);
  };
  {
    const int i = threadIdx.x, a = i / ppb, q = q0 + i - a * ppb;
    if (one && i < DP * ppb && q < n) load_binv(a, q);
  }
  float part[2] = {0.f, 0.f};
  for (int ph = 0; ph < nph; ++ph) {
    if (ph) gsync(grid, tm, kTPrecond);
    if (coarse && ph == 1) coarse_restrict_sum<DP>(P, S.red);
    if (coarse && ph == 2) coarse_solve<DP>(P, S.red);
    // levels l0 (and l0 + 1) of this phase: input `tin` (level l0 - 1), or
    // rn for level 0; output of the phase's last level in `tout`
    const int l0 = 2 * ph;
    const bool pair = l0 + 1 < L;
    float* tout = (ph & 1) ? P.tb : P.ta;
    const float* tin = (ph & 1) ? P.ta : P.tb;
    auto tv = [&](int b, int q) {
      return ph ? tin[(size_t)b * n + q] : rn((size_t)b * n + q);
    };
    // level l0, all components, at pose qc
    auto level0 = [&](int qc, float (&u)[DP]) {
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
#pragma unroll
      for (int a2 = 0; a2 < DP; ++a2) {
        float sa = 0.f, sg = 0.f;
#pragma unroll
        for (int b = 0; b < DP; ++b) {
          const size_t c = (size_t)(a2 * DP + b) * n + qc;
          sa = fmaf(__ldg(al + c), td[b], sa);
          sg = fmaf(__ldg(ga + c), tu[b], sg);
        }
        u[a2] = tv(a2, qc) + sa + sg;
      }
    };
    if (ph == 0 || l0 < L) {
      for (int i = threadIdx.x; i < DP * ppb; i += kThreads) {
        const int a = i / ppb, q = q0 + i - a * ppb;
        if (q >= n) continue;
        const size_t e = (size_t)a * n + q;
        if (ph == 0) rdst[e] = rn(e);
        if (l0 >= L) continue;
        float uq[DP];
        level0(q, uq);
        if (!pair) {
          tout[e] = uq[a];
          continue;
        }
        const int s2 = pcr_shift(l0 + 1, n);
        float ud[DP], uu[DP];
        level0(wrap(q - s2, n), ud);
        level0(wrap(q + s2, n), uu);
        const float* al = P.alphas + (size_t)(l0 + 1) * DP * DP * n;
        const float* ga = P.gammas + (size_t)(l0 + 1) * DP * DP * n;
        float sa = 0.f, sg = 0.f;
#pragma unroll
        for (int b = 0; b < DP; ++b) {
          const size_t c = (size_t)(a * DP + b) * n + q;
          sa = fmaf(__ldg(al + c), ud[b], sa);
          sg = fmaf(__ldg(ga + c), uu[b], sg);
        }
        tout[e] = uq[a] + sa + sg;
      }
    }
    if (coarse && ph == 0) {
      __syncthreads();
      coarse_restrict_part<DP>(P, rdst);
    }
    if (ph == nph - 1) {
      __syncthreads();   // the block's last level and r complete
      const float* tf = L ? (((nlp - 1) & 1) ? P.tb : P.ta) : rdst;
      for (int i = threadIdx.x; i < DP * ppb; i += kThreads) {
        const int a = i / ppb, q = q0 + i - a * ppb;
        if (q >= n) continue;
        if (!one) load_binv(a, q);
        float acc = 0.f;
#pragma unroll
        for (int b = 0; b < DP; ++b) acc = fmaf(cb[b], tf[(size_t)b * n + q], acc);
        if (coarse) {
          float zc = 0.f;
          for (int g = 0; g < nc; ++g)
            zc = fmaf(P.za[a * nc + g], __ldg(P.rmat + (size_t)q * nc + g), zc);
          acc += zc;
        }
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

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
band_fused_pcg_chunk_kernel(Params P) {
  extern __shared__ __align__(128) float smem[];
  const Smem SL = smem_layout(P.rows, P.cols, P.mw);
  const SmemPtrs S{smem + SL.slab, smem + SL.xs, smem + SL.ts,
                   reinterpret_cast<float4*>(smem + SL.comb), smem + SL.urow,
                   smem + SL.red};
  cg::grid_group grid = cg::this_grid();
  Timer tm;
  tm.on = P.timing != nullptr && threadIdx.x == 0;
  tm.t = tm.on ? clock64() : 0;
#pragma unroll
  for (int k = 0; k < kTimers; ++k) tm.acc[k] = 0;
  const int n = P.np;
  // the first trip's first slab, copied while the chunk entry runs
  if ((int)blockIdx.x < P.n_chunks * P.spc) {
    for (int q = 0; q < kParts; ++q) load_part(P, S, blockIdx.x, q);
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
    phase_slabs<DP>(P, grid, pd, last, pnew, !last, S, tm);
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

// dims: dp np n_chunks k_win w_row b_dl mw nlevels nc cover_cap chunk_iters
// maxit restart grid cols
using KernelFn = void (*)(Params);

// The instantiation for a pose block size (null for one that is not built).
KernelFn kernel_for(int dp) {
  if (dp == 3) return band_fused_pcg_chunk_kernel<3>;
  if (dp == 6) return band_fused_pcg_chunk_kernel<6>;
  return nullptr;
}

bool valid_dims(const int* d) {
  const long long rows = (long long)d[3] * d[0] * d[4];
  return kernel_for(d[0]) != nullptr && d[1] >= 1 && d[2] >= 1 && d[3] >= 1 && d[4] >= 1 &&
         d[5] >= 128 && d[5] % 128 == 0 && d[6] >= 0 && d[7] >= 0 &&
         d[7] < 62 && d[8] >= 0 && d[9] >= 1 && d[10] >= 0 && d[12] >= 0 &&
         d[13] >= 1 && d[14] >= 4 && d[14] % 4 == 0 && d[14] <= 4 * kThreads &&
         d[5] % d[14] == 0 && rows % 4 == 0 && rows * d[2] < (1LL << 31);
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

// Dynamic shared memory of one block, in bytes.
long long band_fused_pcg_chunk_smem_bytes(int rows, int cols, int mw) {
  return (long long)smem_layout(rows, cols, mw).total;
}

// Blocks of the cooperative grid of the dp instantiation on `device` at
// `smem_bytes` per block: one per SM, or 0 when no block fits or the device
// cannot launch cooperatively.  Returns a cudaError_t.
int band_fused_pcg_chunk_grid(int dp, int device, long long smem_bytes, int* grid) {
  *grid = 0;
  const KernelFn kernel = kernel_for(dp);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  int sms = 0, coop = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(grid_sync_probe_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                      (size_t)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  *grid = per_sm >= 1 ? sms : 0;
  return 0;
}

// Floats of workspace one launch needs (< 0 for dimensions the kernel does
// not take).
long long band_fused_pcg_chunk_workspace_floats(const int* dims, int ndims) {
  if (ndims != kNumDims || !valid_dims(dims)) return -1;
  const int rows = dims[3] * dims[0] * dims[4];
  return (long long)layout(dims[0], dims[1], dims[2], rows, dims[5] / dims[14],
                           dims[6], dims[8], dims[13]).total;
}

// `iters` grid barriers on a cooperative grid of `grid` blocks of the band
// kernel's size and shared memory (the grid from band_fused_pcg_chunk_grid).
int band_grid_sync_probe(int grid, long long smem_bytes, int iters, void* stream) {
  void* args[] = {&iters};
  // set here too: another layout's grid query may have changed it since
  cudaError_t err = cudaFuncSetAttribute(
      grid_sync_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchCooperativeKernel(
      (const void*)grid_sync_probe_kernel, dim3(grid), dim3(kThreads), args,
      (size_t)smem_bytes, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Launch one chunk of the dims[0] instantiation (dp = 3 or 6) on `stream` as
// a cooperative grid of dims[13] blocks.
// ptrs: atol2 it rz stop rhs x r p rt | tiles win_off cover u td tu tl
// alphas gammas binv cinv rmat | x r p rt it rz stop rr (outputs) |
// workspace | timing (or null).  Returns a cudaError_t (0 = launched).
int band_fused_pcg_chunk_launch(const int* dims, int ndims, void* const* ptrs,
                                int nptrs, void* stream) {
  if (ndims != kNumDims || nptrs != kNumPtrs || !valid_dims(dims))
    return (int)cudaErrorInvalidValue;
  const int dp = dims[0], np = dims[1], n_chunks = dims[2], k_win = dims[3],
            w_row = dims[4], b_dl = dims[5], mw = dims[6], nlevels = dims[7],
            nc = dims[8], grid = dims[13], cols = dims[14];
  const bool has_coarse = ptrs[19] != nullptr;
  if (has_coarse != (ptrs[20] != nullptr) || (has_coarse && nc < 1) ||
      (mw > 0) != (ptrs[12] != nullptr) || (nlevels > 0 && ptrs[16] == nullptr))
    return (int)cudaErrorInvalidValue;
  // every pointer but u, alphas, gammas, cinv, rmat and timing is required
  static const int kRequired[] = {0,  1,  2,  3,  4,  5,  6,  7,  8,
                                  9,  10, 11, 13, 14, 15, 18, 21, 22,
                                  23, 24, 25, 26, 27, 28, 29};
  for (int i : kRequired)
    if (ptrs[i] == nullptr) return (int)cudaErrorInvalidValue;
  // the 16-byte copies need aligned tiles and workspace
  if (((uintptr_t)ptrs[9] & 15) || ((uintptr_t)ptrs[29] & 15))
    return (int)cudaErrorInvalidValue;

  const int rows = k_win * dp * w_row;
  const int spc = b_dl / cols;
  const Layout L = layout(dp, np, n_chunks, rows, spc, mw,
                          has_coarse ? nc : 0, grid);
  float* ws = (float*)ptrs[29];
  Params P;
  P.np = np; P.n_chunks = n_chunks; P.k_win = k_win; P.w_row = w_row;
  P.b_dl = b_dl; P.mw = mw; P.nlevels = nlevels; P.nc = has_coarse ? nc : 0;
  P.cover_cap = dims[9]; P.chunk_iters = dims[10]; P.maxit = dims[11];
  P.restart = dims[12];
  P.rows = rows; P.cols = cols; P.spc = spc;
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
  P.rmat = (const float*)ptrs[20];
  P.x = (float*)ptrs[21];
  P.r = (float*)ptrs[22];
  P.p = (float*)ptrs[23];
  P.rt = (float*)ptrs[24];
  P.it_out = (int*)ptrs[25];
  P.rz_out = (float*)ptrs[26];
  P.stop_out = (int*)ptrs[27];
  P.rr_out = (float*)ptrs[28];
  P.timing = (long long*)ptrs[30];
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
  P.rcpart = ws + L.rcpart;
  P.rc = ws + L.rc;
  P.za = ws + L.za;
  P.partials = ws + L.partials;

  const size_t bytes = smem_layout(rows, cols, mw).total;
  const KernelFn kernel = kernel_for(dp);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&P};
  err = cudaLaunchCooperativeKernel((const void*)kernel,
                                    dim3(grid), dim3(kThreads), args, bytes,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
