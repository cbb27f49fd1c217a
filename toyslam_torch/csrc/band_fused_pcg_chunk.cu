// One chunk of preconditioned conjugate gradients on the damped reduced pose
// system S = T - V V^T of a large graph, with V streamed from the banded tile
// stack, on a persistent cooperative grid.
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
// What bounds it on an H100: streaming the tile stack.  At the 10k-pose
// graph the stack is [39, 2, 3, 512, 512] f32 = 245 MB, five times the
// 50 MB L2, and every matvec reads it from device memory.  This first
// version reads it twice per matvec (once for the t-pass, once for the
// w-pass; the w-pass walks the chunks in reverse so the last chunks of the
// t-pass are still in L2): about 0.45 GB per matvec, ~0.15 ms at the card's
// 3.35 TB/s.  One thread block on one SM streams about 80 GB/s, so the design
// is a persistent cooperative grid, up to 4 blocks on every SM, that splits
// each pass into many independent items (chunk x window x component x
// column group) and synchronizes the grid between the phases of a CG
// iteration: t-pass, w-pass, gather + T + wide columns, update, each PCR
// level, preconditioner end.  Later work: one pass over the stack with the
// chunk's tiles held in shared memory or L2, TMA loads, fewer grid barriers.
//
// Determinism: no atomics.  Every sum has a fixed order: per-item partials
// (t per (chunk, window, component), w per window row), then a per-pose sum
// over the covering windows in (chunk, window) order from a static table
// (`cover`, built once per graph structure), and the dot products as
// per-block partials summed in block order by every block.
//
// Built with nvcc for sm_90a, WITHOUT --use_fast_math: the breakdown test
// needs isfinite() to see NaN/inf, and alpha/beta need IEEE division.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColGroup = 128;   // t-pass columns per item (2 row halves)
constexpr int kRowGroup = 128;   // w-pass window rows per item
constexpr int kWideSeg = 1024;   // poses per wide-column partial
constexpr int kMaxBlocksPerSM = 4;
constexpr int kPartialSlots = 4; // floats per block in a partial-sum buffer

constexpr int kNumDims = 14;
constexpr int kNumPtrs = 30;

struct Params {
  int np, n_chunks, k_win, w_row, b_dl, mw, nlevels, nc, cover_cap;
  int chunk_iters, maxit, restart;
  const float* atol2;
  const int* it_in;
  const float* rz_in;
  const int* stop_in;
  const float* rhs;
  const float* x_in;
  const float* r_in;
  const float* p_in;
  const float* rt_in;
  const float* tiles;    // [n_chunks, K, DP, Wrow, B*dl]
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
  // outputs; x, r, p are also the working state
  float* x;
  float* r;
  float* p;
  float* rt;
  int* it_out;
  float* rz_out;
  int* stop_out;
  float* rr_out;
  // workspace (written and read inside the launch: plain loads, never the
  // read-only cache)
  float* ap;        // [DP, Np]
  float* z;         // [DP, Np]
  float* ta;        // [DP, Np] PCR ping-pong
  float* tb;
  float* tpart;     // [n_chunks, K, DP, B*dl] t-pass partials
  float* wpart;     // [n_chunks, K, DP, Wrow] w-pass rows
  float* widepart;  // [n_wseg, Mw]
  float* urow;      // [Mw]
  float* rc;        // [DP, nc]
  float* za;        // [DP, nc]
  float* partials;  // [2, grid, kPartialSlots]
};

struct Layout {
  size_t ap, z, ta, tb, tpart, wpart, widepart, urow, rc, za, partials, total;
};

__host__ __device__ inline int n_wseg(int np) { return (np + kWideSeg - 1) / kWideSeg; }

Layout layout(int dp, int np, int n_chunks, int k_win, int w_row, int b_dl,
              int mw, int nc, int grid) {
  Layout L;
  const size_t n = (size_t)dp * np;
  const size_t nck = (size_t)n_chunks * k_win * dp;
  size_t o = 0;
  L.ap = o; o += n;
  L.z = o; o += n;
  L.ta = o; o += n;
  L.tb = o; o += n;
  L.tpart = o; o += nck * b_dl;
  L.wpart = o; o += nck * w_row;
  L.widepart = o; o += (size_t)n_wseg(np) * mw;
  L.urow = o; o += mw;
  L.rc = o; o += (size_t)dp * nc;
  L.za = o; o += (size_t)dp * nc;
  L.partials = o; o += (size_t)2 * grid * kPartialSlots;
  L.total = o;
  return L;
}

size_t smem_bytes(int w_row, int b_dl) {
  const int row = w_row > b_dl ? w_row : b_dl;
  return sizeof(float) * ((size_t)row + kThreads + 64);
}

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

// This block's share of NV grid-wide sums: its threads' values summed over
// the block, stored in slot blockIdx.x of partial buffer `buf`.
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

// The NV grid-wide sums of partial buffer `buf` (after a grid barrier),
// the same bits in every block: blocks in a fixed order.
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

__device__ __forceinline__ int grid_thread() {
  return blockIdx.x * blockDim.x + threadIdx.x;
}
__device__ __forceinline__ int grid_threads() { return gridDim.x * blockDim.x; }

// --- matvec phases: out = S v ------------------------------------------------

// Phase M1: t-pass partials tpart[c, k, a, j] = sum_w v[a, off + w] .
// tiles[c, k, a, w, j] (zero past Np), and the wide-column partials.
template <int DP>
__device__ void phase_tpass(const Params& P, const float* v, float* smem,
                            float* red) {
  const int n = P.np, wr = P.w_row, bdl = P.b_dl;
  const int ncg = bdl / kColGroup;
  const int n_tile_items = P.n_chunks * P.k_win * DP * ncg;
  const int nseg = n_wseg(n);
  const int n_items = n_tile_items + P.mw * nseg;
  float* xs = smem;                    // [Wrow] window of v
  float* half = smem + max(wr, bdl);   // [kColGroup] upper-half sums
  const int half_rows = (wr + 1) / 2;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    if (item < n_tile_items) {
      const int jg = item % ncg;
      const int q = item / ncg;               // (c*K + k)*DP + a
      const int a = q % DP;
      const int ck = q / DP;
      const int off = __ldg(P.win_off + ck);
      for (int w = threadIdx.x; w < wr; w += blockDim.x) {
        const int pp = off + w;
        xs[w] = pp < n ? v[a * n + pp] : 0.f;
      }
      __syncthreads();
      const int col = jg * kColGroup + (threadIdx.x & (kColGroup - 1));
      const int h = threadIdx.x / kColGroup;  // row half 0 or 1
      const int w0 = h * half_rows;
      const int w1 = min(wr, w0 + half_rows);
      const float* tp = P.tiles + ((size_t)q * wr) * bdl + col;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      int w = w0;
      for (; w + 4 <= w1; w += 4) {
        a0 = fmaf(xs[w], __ldg(tp + (size_t)w * bdl), a0);
        a1 = fmaf(xs[w + 1], __ldg(tp + (size_t)(w + 1) * bdl), a1);
        a2 = fmaf(xs[w + 2], __ldg(tp + (size_t)(w + 2) * bdl), a2);
        a3 = fmaf(xs[w + 3], __ldg(tp + (size_t)(w + 3) * bdl), a3);
      }
      for (; w < w1; ++w) a0 = fmaf(xs[w], __ldg(tp + (size_t)w * bdl), a0);
      const float acc = (a0 + a1) + (a2 + a3);
      if (h == 1) half[threadIdx.x - kColGroup] = acc;
      __syncthreads();
      if (h == 0) P.tpart[(size_t)q * bdl + col] = acc + half[threadIdx.x];
      __syncthreads();
    } else {
      // wide columns: widepart[s, m] = sum_{a, p in segment s} v[a,p] u[a,m,p]
      const int wi = item - n_tile_items;
      const int m = wi / nseg, s = wi % nseg;
      const int p0 = s * kWideSeg, p1 = min(n, p0 + kWideSeg);
      float acc[1] = {0.f};
      for (int pp = p0 + threadIdx.x; pp < p1; pp += blockDim.x) {
#pragma unroll
        for (int a = 0; a < DP; ++a)
          acc[0] = fmaf(v[a * n + pp], __ldg(P.u + ((size_t)a * P.mw + m) * n + pp), acc[0]);
      }
      block_sum<1>(acc, red);
      if (threadIdx.x == 0) P.widepart[(size_t)s * P.mw + m] = acc[0];
    }
  }
}

// Phase M2: w-pass rows wpart[c, k, a, w] = tiles[c, k, a, w, :] . t[c, :]
// with t[c] = sum over the chunk's (k, a) partials, chunks in reverse order
// (the last t-pass chunks are the ones still in L2); and urow = u^T v.
template <int DP>
__device__ void phase_wpass(const Params& P, float* smem) {
  const int wr = P.w_row, bdl = P.b_dl;
  const int nrg = (wr + kRowGroup - 1) / kRowGroup;
  const int n_row_items = P.n_chunks * P.k_win * DP * nrg;
  const int n_items = n_row_items + (P.mw > 0 ? 1 : 0);
  const int kd = P.k_win * DP;
  float* ts = smem;            // [B*dl] the chunk's t
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    if (item < n_row_items) {
      const int ir = n_row_items - 1 - item;
      const int rg = ir % nrg;
      const int q = ir / nrg;                 // (c*K + k)*DP + a
      const int c = q / kd;
      const float* tsrc = P.tpart + (size_t)c * kd * bdl;
      for (int j = threadIdx.x; j < bdl; j += blockDim.x) {
        float s = 0.f;
        for (int ka = 0; ka < kd; ++ka) s += tsrc[(size_t)ka * bdl + j];
        ts[j] = s;
      }
      __syncthreads();
      const int r0 = rg * kRowGroup;
      const int r1 = min(wr, r0 + kRowGroup);
      for (int row = r0 + warp; row < r1; row += kWarps) {
        const float* tp = P.tiles + ((size_t)q * wr + row) * bdl;
        float acc = 0.f;
        for (int j = lane; j < bdl; j += 32) acc = fmaf(__ldg(tp + j), ts[j], acc);
        acc = warp_sum(acc);
        if (lane == 0) P.wpart[(size_t)q * wr + row] = acc;
      }
      __syncthreads();
    } else {
      const int nseg = n_wseg(P.np);
      for (int m = threadIdx.x; m < P.mw; m += blockDim.x) {
        float s = 0.f;
        for (int sg = 0; sg < nseg; ++sg) s += P.widepart[(size_t)sg * P.mw + m];
        P.urow[m] = s;
      }
    }
  }
}

// Phase M3: ap = ((T v - u urow) - band rows), and this block's p . ap.
template <int DP>
__device__ void phase_gather(const Params& P, const float* v, int buf,
                             float* red) {
  const int n = P.np, N = DP * n, cap = P.cover_cap;
  float part[1] = {0.f};
  for (int e = grid_thread(); e < N; e += grid_threads()) {
    const int a = e / n, pp = e - a * n;
    const int pu = (pp + 1 == n) ? 0 : pp + 1;
    const int pl = (pp == 0) ? n - 1 : pp - 1;
    float yd = 0.f, yu = 0.f, yl = 0.f;
#pragma unroll
    for (int b = 0; b < DP; ++b) {
      const size_t o = (size_t)(a * DP + b) * n;
      yd = fmaf(__ldg(P.td + o + pp), v[b * n + pp], yd);
      yu = fmaf(__ldg(P.tu + o + pp), v[b * n + pu], yu);
      yl = fmaf(__ldg(P.tl + o + pp), v[b * n + pl], yl);
    }
    float y = yd + yu + yl;
    if (P.mw > 0) {
      float wide = 0.f;
      for (int m = 0; m < P.mw; ++m)
        wide = fmaf(__ldg(P.u + ((size_t)a * P.mw + m) * n + pp), P.urow[m], wide);
      y -= wide;
    }
    float band = 0.f;
    for (int s = 0; s < cap; ++s) {
      const int cv = __ldg(P.cover + (size_t)pp * cap + s);
      if (cv < 0) break;
      band += P.wpart[(size_t)cv + (size_t)a * P.w_row];
    }
    y -= band;
    P.ap[e] = y;
    part[0] = fmaf(P.p[e], y, part[0]);
  }
  put_partials<1>(P, buf, part, red);
}

// --- preconditioner phases: z = M^-1 r ---------------------------------------

// PCR level l: out = t + alpha_l t[p - s] + gamma_l t[p + s], s = 2^l.
template <int DP>
__device__ void pcr_level(const Params& P, int l, const float* t, float* out) {
  const int n = P.np, N = DP * n;
  const float* al = P.alphas + (size_t)l * DP * DP * n;
  const float* ga = P.gammas + (size_t)l * DP * DP * n;
  const int sm = (int)((1LL << l) % n);
  for (int e = grid_thread(); e < N; e += grid_threads()) {
    const int a = e / n, pp = e - a * n;
    int pd = pp - sm;
    if (pd < 0) pd += n;
    int pu = pp + sm;
    if (pu >= n) pu -= n;
    float sa = 0.f, sg = 0.f;
#pragma unroll
    for (int b = 0; b < DP; ++b) {
      const size_t c = (size_t)(a * DP + b) * n + pp;
      sa = fmaf(__ldg(al + c), t[b * n + pd], sa);
      sg = fmaf(__ldg(ga + c), t[b * n + pu], sg);
    }
    out[e] = t[e] + sa + sg;
  }
}

// Coarse restriction rc[b, g] = sum_p r[b, p] rmat[p, g]: one item per g.
template <int DP>
__device__ void coarse_restrict(const Params& P, float* red) {
  const int n = P.np, nc = P.nc;
  for (int g = blockIdx.x; g < nc; g += gridDim.x) {
    float acc[DP];
#pragma unroll
    for (int b = 0; b < DP; ++b) acc[b] = 0.f;
    for (int pp = threadIdx.x; pp < n; pp += blockDim.x) {
      const float rm = __ldg(P.rmat + (size_t)pp * nc + g);
#pragma unroll
      for (int b = 0; b < DP; ++b) acc[b] = fmaf(P.r[b * n + pp], rm, acc[b]);
    }
    block_sum<DP>(acc, red);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int b = 0; b < DP; ++b) P.rc[b * nc + g] = acc[b];
    }
  }
}

// Coarse solve za[a, g] = sum_{b, h} cinv[a, b, g, h] rc[b, h]: one item per
// (a, g).
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

// z = M^-1 r with r complete (grid barrier before).  Ends with a grid
// barrier after the partials of r . z and r . r went to buffer `buf`.
template <int DP>
__device__ void precond(const Params& P, cg::grid_group& grid, int buf,
                        float* red) {
  const bool coarse = P.cinv != nullptr;
  const int nph = max(P.nlevels, coarse ? 2 : 0);
  const float* t = P.r;
  for (int l = 0; l < nph; ++l) {
    if (l < P.nlevels) {
      float* o = (l & 1) ? P.tb : P.ta;
      pcr_level<DP>(P, l, t, o);
      t = o;
    }
    if (coarse && l == 0) coarse_restrict<DP>(P, red);
    if (coarse && l == 1) coarse_solve<DP>(P, red);
    grid.sync();
  }
  const int n = P.np, N = DP * n, nc = P.nc;
  float part[2] = {0.f, 0.f};
  for (int e = grid_thread(); e < N; e += grid_threads()) {
    const int a = e / n, pp = e - a * n;
    float acc = 0.f;
#pragma unroll
    for (int b = 0; b < DP; ++b)
      acc = fmaf(__ldg(P.binv + (size_t)(a * DP + b) * n + pp), t[b * n + pp], acc);
    if (coarse) {
      float zc = 0.f;
      for (int g = 0; g < nc; ++g)
        zc = fmaf(P.za[a * nc + g], __ldg(P.rmat + (size_t)pp * nc + g), zc);
      acc += zc;
    }
    P.z[e] = acc;
    const float re = P.r[e];
    part[0] = fmaf(re, acc, part[0]);
    part[1] = fmaf(re, re, part[1]);
  }
  put_partials<2>(P, buf, part, red);
  grid.sync();
}

template <int DP>
__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSM)
band_fused_pcg_chunk_kernel(Params P) {
  extern __shared__ float smem[];
  const int row = P.w_row > P.b_dl ? P.w_row : P.b_dl;
  float* red = smem + row + kThreads;   // reduction slots (64 floats)
  cg::grid_group grid = cg::this_grid();
  const int n = P.np, N = DP * n;
  const bool restart = P.restart != 0;
  int buf = 0;   // partial-sum buffer, alternated per grid-wide sum

  // chunk entry: restart replaces the recurrence residual with the carried
  // true residual and resets the search direction
  float s1[1] = {0.f};
  for (int e = grid_thread(); e < N; e += grid_threads()) {
    P.x[e] = P.x_in[e];
    const float re = restart ? P.rt_in[e] : P.r_in[e];
    P.r[e] = re;
    if (!restart) P.p[e] = P.p_in[e];
    s1[0] = fmaf(re, re, s1[0]);
  }
  put_partials<1>(P, buf, s1, red);
  grid.sync();
  grid_totals<1>(P, buf, s1, red);
  buf ^= 1;
  float rr = s1[0];
  float rz = *P.rz_in;
  if (restart) {
    precond<DP>(P, grid, buf, red);
    float s2[2];
    grid_totals<2>(P, buf, s2, red);
    buf ^= 1;
    rz = s2[0];
    for (int e = grid_thread(); e < N; e += grid_threads()) P.p[e] = P.z[e];
  }
  bool stop = *P.stop_in > 0;
  int it = *P.it_in;
  const float atol2 = *P.atol2;
  float rr_true = 0.f;

  for (int i = 0; i <= P.chunk_iters; ++i) {
    const bool last = i == P.chunk_iters;
    const float* v = last ? P.x : P.p;
    grid.sync();                                   // v complete
    phase_tpass<DP>(P, v, smem, red);
    grid.sync();
    phase_wpass<DP>(P, smem);
    grid.sync();
    phase_gather<DP>(P, v, buf, red);
    grid.sync();
    float sp[1];
    grid_totals<1>(P, buf, sp, red);
    buf ^= 1;
    const float pap = sp[0];
    if (!last) stop = stop || !(pap > 0.f) || !isfinite(pap);
    const bool done = last || stop || (rr <= atol2) || (it >= P.maxit);
    const float alpha = done ? 0.f : rz / pap;
    float st[1] = {0.f};
    for (int e = grid_thread(); e < N; e += grid_threads()) {
      const float ape = P.ap[e];
      P.x[e] = P.x[e] + alpha * P.p[e];
      P.r[e] = P.r[e] - alpha * ape;
      if (last) {
        const float rte = P.rhs[e] - ape;
        P.rt[e] = rte;
        st[0] = fmaf(rte, rte, st[0]);
      }
    }
    if (last) {
      put_partials<1>(P, buf, st, red);
      grid.sync();
      grid_totals<1>(P, buf, st, red);
      rr_true = st[0];
      break;
    }
    grid.sync();                                   // r complete
    precond<DP>(P, grid, buf, red);
    float s2[2];
    grid_totals<2>(P, buf, s2, red);
    buf ^= 1;
    const float rz_new = s2[0];
    rr = s2[1];
    const float safe_rz = (rz == 0.f) ? 1.f : rz;
    const float beta = done ? 0.f : rz_new / safe_rz;
    if (!done) {
      for (int e = grid_thread(); e < N; e += grid_threads())
        P.p[e] = P.z[e] + beta * P.p[e];
    }
    rz = done ? rz : rz_new;
    it += done ? 0 : 1;
  }

  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *P.it_out = it;
    *P.rz_out = rz;
    *P.stop_out = stop ? 1 : 0;
    *P.rr_out = rr_true;
  }
}

bool valid_dims(const int* d) {
  // dp np n_chunks k_win w_row b_dl mw nlevels nc cover_cap chunk_iters
  // maxit restart grid
  return d[0] == 3 && d[1] >= 1 && d[2] >= 1 && d[3] >= 1 && d[4] >= 1 &&
         d[5] >= kColGroup && d[5] % kColGroup == 0 && d[6] >= 0 &&
         d[7] >= 0 && d[8] >= 0 && d[9] >= 1 && d[10] >= 0 && d[12] >= 0 &&
         d[13] >= 1;
}

}  // namespace

extern "C" {

// Blocks of the cooperative grid on `device` for a layout with window rows
// `w_row` and chunk width `b_dl`: the co-resident maximum, at most
// kMaxBlocksPerSM per SM (0 when no block fits).  Returns a cudaError_t.
int band_fused_pcg_chunk_grid(int device, int w_row, int b_dl, int* grid) {
  *grid = 0;
  int sms = 0, coop = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return 0;
  const size_t bytes = smem_bytes(w_row, b_dl);
  err = cudaFuncSetAttribute(band_fused_pcg_chunk_kernel<3>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, band_fused_pcg_chunk_kernel<3>, kThreads, bytes);
  if (err != cudaSuccess) return (int)err;
  *grid = sms * (per_sm < kMaxBlocksPerSM ? per_sm : kMaxBlocksPerSM);
  return 0;
}

// Floats of workspace one launch needs (< 0 for dimensions the kernel does
// not take).
long long band_fused_pcg_chunk_workspace_floats(const int* dims, int ndims) {
  if (ndims != kNumDims || !valid_dims(dims)) return -1;
  return (long long)layout(dims[0], dims[1], dims[2], dims[3], dims[4], dims[5],
                           dims[6], dims[8], dims[13]).total;
}

// Launch one chunk on `stream` as a cooperative grid of dims[13] blocks.
// ptrs: atol2 it rz stop rhs x r p rt | tiles win_off cover u td tu tl
// alphas gammas binv cinv rmat | x r p rt it rz stop rr (outputs) |
// workspace.  Returns a cudaError_t (0 = launched).
int band_fused_pcg_chunk_launch(const int* dims, int ndims, void* const* ptrs,
                                int nptrs, void* stream) {
  if (ndims != kNumDims || nptrs != kNumPtrs || !valid_dims(dims))
    return (int)cudaErrorInvalidValue;
  const int dp = dims[0], np = dims[1], n_chunks = dims[2], k_win = dims[3],
            w_row = dims[4], b_dl = dims[5], mw = dims[6], nlevels = dims[7],
            nc = dims[8], grid = dims[13];
  const bool has_coarse = ptrs[19] != nullptr;
  if (has_coarse != (ptrs[20] != nullptr) || (has_coarse && nc < 1) ||
      (mw > 0) != (ptrs[12] != nullptr) || (nlevels > 0 && ptrs[16] == nullptr))
    return (int)cudaErrorInvalidValue;
  // every pointer but u, alphas, gammas, cinv and rmat is required
  static const int kRequired[] = {0,  1,  2,  3,  4,  5,  6,  7,  8,
                                  9,  10, 11, 13, 14, 15, 18, 21, 22,
                                  23, 24, 25, 26, 27, 28, 29};
  for (int i : kRequired)
    if (ptrs[i] == nullptr) return (int)cudaErrorInvalidValue;

  const Layout L = layout(dp, np, n_chunks, k_win, w_row, b_dl, mw,
                          has_coarse ? nc : 0, grid);
  float* ws = (float*)ptrs[29];
  Params P;
  P.np = np; P.n_chunks = n_chunks; P.k_win = k_win; P.w_row = w_row;
  P.b_dl = b_dl; P.mw = mw; P.nlevels = nlevels; P.nc = has_coarse ? nc : 0;
  P.cover_cap = dims[9]; P.chunk_iters = dims[10]; P.maxit = dims[11];
  P.restart = dims[12];
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
  P.ap = ws + L.ap;
  P.z = ws + L.z;
  P.ta = ws + L.ta;
  P.tb = ws + L.tb;
  P.tpart = ws + L.tpart;
  P.wpart = ws + L.wpart;
  P.widepart = ws + L.widepart;
  P.urow = ws + L.urow;
  P.rc = ws + L.rc;
  P.za = ws + L.za;
  P.partials = ws + L.partials;

  const size_t bytes = smem_bytes(w_row, b_dl);
  cudaError_t err = cudaFuncSetAttribute(
      band_fused_pcg_chunk_kernel<3>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&P};
  err = cudaLaunchCooperativeKernel((const void*)band_fused_pcg_chunk_kernel<3>,
                                    dim3(grid), dim3(kThreads), args, bytes,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
