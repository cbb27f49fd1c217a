// One chunk of preconditioned conjugate gradients on the damped reduced pose
// system S = T - V V^T, on one thread-block cluster or on a cooperative grid
// of clusters (two schedules, picked per layout by ops/fused_pcg.py::b1_plan).
//
// Replaces toyslam_tpu/ops/fused_pcg.py::_make_kernel (the resident fused-PCG
// Pallas kernel, launched by fused_pcg).  One launch keeps that kernel's
// contract: the same inputs, the same outputs, the same semantics.
//
//   * chunk_iters CG iterations from the carried state (x, r, p, rz, it, stop),
//     then the true residual r_true = rhs - S x and its squared norm;
//   * restart != 0: r := rt (the true residual carried from the previous
//     chunk) and p := M^-1 r;
//   * breakdown (p^T A p <= 0 or not finite) sets a sticky stop; once an
//     iteration is done (stop, rr <= atol2 or it >= maxit) it masks to a no-op
//     and `it` counts only live iterations;
//   * T is block tridiagonal with CIRCULAR neighbour indices (p +- 1 mod Np),
//     exactly as the reference's lane shift: the coefficient planes vanish at
//     the wrap;
//   * M^-1 = L levels of parallel cyclic reduction (shifts 1, 2, 4, ..., also
//     circular), the block-diagonal binv, and an optional additive coarse
//     level rmat cinv rmat^T.
//
// What bounds it on an H100: the V slabs U [DP, Np, Mw] (1.77 MB at the
// 150-pose graph) are read twice per matvec (V^T x, then V urow); one SM
// streams them from L2 at well under 100 GB/s, so the first, one-block
// version took 0.80 ms per 16-iteration chunk.  The bound is ~1 us; what
// is left is latency: shared-memory passes and barriers per CG trip.
//
// Where one cluster cannot hold U in shared memory (the 1088-pose
// multi-loop graph: 10.0 MB; the 2000-pose request: 18.9 MB; the 128-pose
// SE(3) graph: 4.7 MB), U streams from L2 through that cluster's 16 SMs on
// every matvec and the replicated PCR reads its planes from L2 in every
// block: 1.14 ms, 2.01 ms and 0.50 ms a chunk, under 1 % of the bound, the
// split "vt_x + v_urow" 50-57 % and "precond" 27-38 % (chip_smoke.py, line
// b1_layout).  The split schedule (below, "the split schedule") spreads U
// over 112 SMs and splits the state and the PCR, at the price of cluster
// barriers (0.75 us each on an H100) between its steps.
//
// The cluster schedule ("cluster").  One launch is one cluster of C thread
// blocks (C = 16, the non-portable maximum, chosen over the portable 8
// because at C = 16 the 150-pose U slice fits in shared memory beside the
// vectors: 0.22 against 0.39 ms per chunk, both timed by chip_smoke.py).
// Block b owns the columns [b*cp, (b+1)*cp) of U, cp = ceil(Mw / C):
//   * its U slice is loaded into shared memory once per launch where it fits
//     beside the vectors ("resident": Np=192 gives 117 KB, rows padded to an
//     odd number of float4s), else it is read from L2 on every matvec by all
//     C SMs at once ("streamed": Np=2048);
//   * V^T v is local to the block's columns (urow, float4 column quads), and
//     the block forms its partial V urow, a full [DP, Np] vector, one thread
//     per row, in its own shared memory;
//   * after a cluster barrier block b sums the C partials of its share of
//     the elements through distributed shared memory, in block order,
//     applies T there, and writes the result into every block's copy of the
//     output vector; a second cluster barrier completes the matvec;
//   * everything else (dot products, the x/r/p updates, PCR, coarse level)
//     is replicated per block on identical copies of the [DP, Np] state:
//     the same instructions on the same bits give the same bits, so every
//     block takes the same alpha, beta and stop without further exchange.
//     576 threads give each of the 576 state elements at 150 poses its own
//     thread, which loads its PCR planes ahead_levels() levels ahead.
// The plan keeps this schedule where U is resident (Np = 192; Np = 64 at
// DP = 6): there the split schedule's barriers cost more than they save.
// A launch the card refuses (the cluster or the grid does not fit) returns
// its error; nothing falls back to another schedule.
//
// Instantiated for DP = 3 (SE(2) poses) and DP = 6 (SE(3) bundle
// adjustment), each schedule; the C entry points dispatch on dp.
//
// Determinism: no atomics in any result; every sum has a fixed order
// (block sums, the partials in rank order, then in cluster order).  Runs
// repeat bit for bit at one plan.
//
// Built with nvcc for sm_90a, WITHOUT --use_fast_math: the breakdown test
// needs isfinite() to see NaN/inf, and alpha/beta need IEEE division.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

// Threads a block of the cluster schedule: one [3, 192] element each at 150
// poses; at DP = 6 one [6, 64] element each at 64 poses.  A thread has 96
// registers at 576 (18 warps: five on some of an SM's four register files)
// and 168 at 384: at DP = 6, 576 threads spilled 24 bytes (ptxas, sm_90a).
__host__ __device__ constexpr int cluster_threads(int dp) { return dp == 3 ? 576 : 384; }
constexpr int kMaxCluster = 16;
// Levels between loading a level's planes and using them: the ring holds
// 2 (kAhead + 1) DP coefficients per thread.  One at both pose sizes: at
// DP = 3 (576 threads, 96 registers each) depth 1 ran the main path's chunk
// in 0.197 ms against 0.211 at depth 3 (chip_smoke.py, line b1_layout).
template <int DP>
__host__ __device__ constexpr int ahead_levels() { return 1; }

struct Params {
  int np, mw, nlevels, nc, chunk_iters, maxit, restart;
  int cp, resident;      // U columns per block; U slice in shared memory
  int nclusters, ppb, planes;   // split schedule: clusters, poses a block,
                                // its planes in shared memory,
  int klocal;                   // PCR levels run without a cluster barrier
  float* gpart;          // split schedule, nclusters > 1: [2, nclusters, DP*Np]
  const float* atol2;
  const int* it_in;
  const float* rz_in;
  const int* stop_in;
  const float* rhs;
  const float* x_in;
  const float* r_in;
  const float* p_in;
  const float* rt_in;
  const float* u;        // [DP, Np, Mw]
  const float* td;       // [DP, DP, Np]
  const float* tu;
  const float* tl;
  const float* alphas;   // [L, DP, DP, Np]
  const float* gammas;
  const float* binv;     // [DP, DP, Np]
  const float* cinv;     // [DP, DP, nc, nc] or null
  const float* rmat;     // [Np, nc] or null
  float* x_out;
  float* r_out;
  float* p_out;
  float* rt_out;
  int* it_out;
  float* rz_out;
  int* stop_out;
  float* rr_out;
  long long* timing;     // [kTimers] clock64 sums of block 0, or null
};

// V^T v columns, the partial V urow, the cluster exchange, the grid
// barrier, the preconditioner's gather and local levels (split schedule),
// the rest of the preconditioner, the dot products' sums, the cluster
// barriers (split schedule; the "cluster" schedule counts its two with the
// exchange), the rest
constexpr int kTimers = 9;
enum {
  kTVtx = 0, kTVurow = 1, kTExchange = 2, kTGrid = 3, kTLocal = 4, kTPrecond = 5,
  kTDots = 6, kTBarrier = 7, kTOther = 8
};
static_assert(kTOther + 1 == kTimers, "B1_TIMERS in ops/fused_pcg.py names each kind");

// Thread 0 of block 0 adds the cycles since its last lap to out[k] (the
// caller zeroes it) with a reduction that returns nothing, so a lap neither
// stalls nor holds its sums in registers.  Timing only: no result depends
// on it.
struct Timer {
  long long t;
  bool on;
  __device__ void start(const long long* timing, bool mine) {
    on = timing != nullptr && mine;
    t = on ? clock64() : 0;
  }
  // `out` is the launch's timing array (a kernel parameter: no register)
  __device__ __forceinline__ void lap(long long* out, int k) {
    if (on) {
      const long long now = clock64();
      atomicAdd(reinterpret_cast<unsigned long long*>(out) + k,
                (unsigned long long)(now - t));
      t = now;
    }
  }
};

// Shared memory in floats: with `resident` the U slice [DP*Np, cp], rows
// padded to an odd number of float4s so that float4 reads of one row per
// thread meet no bank conflicts; the float4 column-sum scratch; urow; seven
// [DP, Np] vectors (ta doubles as the block's partial V urow during a
// matvec); the coarse scratch; the reduction slots (mirrored by
// chunk_smem_bytes in ops/fused_pcg.py).
struct Smem {
  size_t us, scratch, urow, x, r, p, ap, z, ta, tb, rc, za, red, total;
};

__host__ __device__ inline int slice_stride(int cp) { return 4 * (((cp + 3) / 4) | 1); }

__host__ __device__ inline Smem smem_layout(int dp, int np, int cp, int nc,
                                            int resident) {
  Smem S;
  const size_t n = (size_t)dp * np;
  size_t o = 0;
  S.us = o; o += resident ? n * slice_stride(cp) : 0;
  S.scratch = o; o += 4 * cluster_threads(dp);
  S.urow = o; o += (cp + 3) & ~3;
  S.x = o; o += n;
  S.r = o; o += n;
  S.p = o; o += n;
  S.ap = o; o += n;
  S.z = o; o += n;
  S.ta = o; o += n;
  S.tb = o; o += n;
  S.rc = o; o += (size_t)dp * nc;
  S.za = o; o += (size_t)dp * nc;
  S.red = o; o += 2 * (cluster_threads(dp) / 32) + 2;
  S.total = o * sizeof(float);
  return S;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of a and b over the block of NT threads, returned to every thread.
// Fixed order for a fixed block size, so repeated runs (and every block)
// agree bit for bit.  `red` holds 2 NT/32 + 2 floats.
template <int NT>
__device__ float2 block_sum2(float a, float b, float* red) {
  constexpr int NW = NT / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    red[warp] = a;
    red[NW + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    float ta = lane < NW ? red[lane] : 0.f;
    float tb = lane < NW ? red[NW + lane] : 0.f;
    ta = warp_sum(ta);
    tb = warp_sum(tb);
    if (lane == 0) {
      red[2 * NW] = ta;
      red[2 * NW + 1] = tb;
    }
  }
  __syncthreads();
  const float2 out = make_float2(red[2 * NW], red[2 * NW + 1]);
  __syncthreads();
  return out;
}

__device__ __forceinline__ float4 f4add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 f4fma(float s, float4 b, float4 a) {
  return make_float4(fmaf(s, b.x, a.x), fmaf(s, b.y, a.y), fmaf(s, b.z, a.z),
                     fmaf(s, b.w, a.w));
}

// The block's dynamic shared memory.
__device__ __forceinline__ float* shm() {
  extern __shared__ float smem[];
  return smem;
}

// Buffers as 32-bit offsets into the dynamic shared memory (pointers held
// here spilled registers at 96 a thread).
struct Block {
  int o_ypart;      // this block's partial V urow (= ta)
  int o_urow;       // [round4(cp)], zero past the block's columns
  int o_scratch;    // float4 [cluster_threads(DP)]
  int o_us;         // the resident U slice [DP*Np, cp] (unused where U streams)
  int rank, csize, j0, ncol;   // this block's columns [j0, j0 + ncol)
  __device__ __forceinline__ float* ypart() const { return shm() + o_ypart; }
  __device__ __forceinline__ float* urow() const { return shm() + o_urow; }
  __device__ __forceinline__ float4* scratch() const {
    return reinterpret_cast<float4*>(shm() + o_scratch);
  }
  __device__ __forceinline__ const float* us() const { return shm() + o_us; }
};

// out = S in = T in - V (V^T in), over the cluster.  `in` is complete in
// every block (barrier before); on return `out` is complete in every block.
template <int DP>
__device__ __forceinline__ void matvec(const Params& P, cg::cluster_group& cluster,
                       const Block& B, const float* __restrict__ in,
                       float* __restrict__ out, Timer& tm) {
  const int n = P.np, N = DP * n, mw = P.mw, ncol = B.ncol;
  const int us_stride = slice_stride(P.cp);
  const int tid = threadIdx.x;
  tm.lap(P.timing, kTOther);
  auto uval = [&](int e, int j) {
    return P.resident ? B.us()[(size_t)e * us_stride + j]
                      : __ldg(P.u + (size_t)e * mw + B.j0 + j);
  };
  const int cq = (ncol + 3) / 4;   // the block's float4 column quads
  // float4 rows: the resident slice (zero-padded), or U itself where the
  // block's columns are whole, aligned quads
  const bool quads = P.resident || (mw % 4 == 0 && B.j0 % 4 == 0 && ncol % 4 == 0);
  constexpr int kThreads = cluster_threads(DP), kWarps = kThreads / 32;
  if (quads && cq <= kThreads / 8) {
    // urow = U_b^T in: thread (quad q4, row group g of G) sums rows g,
    // g + G, ...; then 8 groups of the G, then the 8, each in a fixed order
    const int sq = P.resident ? us_stride / 4 : mw / 4, G = kThreads / cq;
    const int q4 = tid % cq, g = tid / cq;
    const float4* us4 = P.resident
        ? reinterpret_cast<const float4*>(B.us())
        : reinterpret_cast<const float4*>(P.u + B.j0);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g < G) {
      if (P.resident) {
        for (int e = g; e < N; e += G) acc = f4fma(in[e], us4[(size_t)e * sq + q4], acc);
      } else {
        for (int e = g; e < N; e += G) acc = f4fma(in[e], __ldg(us4 + (size_t)e * sq + q4), acc);
      }
    }
    B.scratch()[tid] = acc;
    __syncthreads();
    float4 s8 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (tid < 8 * cq) {
      for (int h = tid / cq; h < G; h += 8) s8 = f4add(s8, B.scratch()[h * cq + q4]);
    }
    __syncthreads();
    if (tid < 8 * cq) B.scratch()[tid] = s8;
    __syncthreads();
    if (tid < cq) {
      float4 u4 = B.scratch()[tid];
      for (int h = 1; h < 8; ++h) u4 = f4add(u4, B.scratch()[h * cq + tid]);
      const int j = 4 * tid;   // zero past the block's columns
      B.urow()[j] = j < ncol ? u4.x : 0.f;
      B.urow()[j + 1] = j + 1 < ncol ? u4.y : 0.f;
      B.urow()[j + 2] = j + 2 < ncol ? u4.z : 0.f;
      B.urow()[j + 3] = j + 3 < ncol ? u4.w : 0.f;
    }
    __syncthreads();
    tm.lap(P.timing, kTVtx);
    // the block's partial V urow: one thread per row, float4s of its row
    const float4* ur4 = reinterpret_cast<const float4*>(B.urow());
    for (int e = tid; e < N; e += kThreads) {
      const float4* ur = us4 + (size_t)e * sq;
      float a0 = 0.f, a1 = 0.f;
      for (int k = 0; k < cq; ++k) {
        const float4 u = P.resident ? ur[k] : __ldg(ur + k), w = ur4[k];
        a0 = fmaf(u.x, w.x, a0);
        a1 = fmaf(u.y, w.y, a1);
        a0 = fmaf(u.z, w.z, a0);
        a1 = fmaf(u.w, w.w, a1);
      }
      B.ypart()[e] = a0 + a1;
    }
    tm.lap(P.timing, kTVurow);
  } else {
  // columns not in whole quads, or too many for the float4 path:
  // urow = U_b^T in: thread (column j, row group g of G), groups combined in
  // a fixed order
  float* scratch = reinterpret_cast<float*>(B.scratch());
  const int cpp = ncol >= kThreads ? kThreads : (ncol > 0 ? ncol : 1);
  const int G = kThreads / cpp;
  const int g = tid / cpp;
  for (int c0 = 0; c0 < ncol; c0 += cpp) {
    const int j = c0 + tid % cpp;
    const bool active = g < G && j < ncol;
    float acc = 0.f;
    if (active) {
      float a1 = 0.f, a2 = 0.f, a3 = 0.f;
      int e = g;
      for (; e + 3 * G < N; e += 4 * G) {
        acc = fmaf(in[e], uval(e, j), acc);
        a1 = fmaf(in[e + G], uval(e + G, j), a1);
        a2 = fmaf(in[e + 2 * G], uval(e + 2 * G, j), a2);
        a3 = fmaf(in[e + 3 * G], uval(e + 3 * G, j), a3);
      }
      for (; e < N; e += G) acc = fmaf(in[e], uval(e, j), acc);
      acc = (acc + a1) + (a2 + a3);
    }
    scratch[tid] = acc;
    __syncthreads();
    if (g == 0 && active) {
      float s = acc;
      for (int h = 1; h < G; ++h) s += scratch[h * cpp + tid];
      B.urow()[j] = s;
    }
    __syncthreads();
  }
  tm.lap(P.timing, kTVtx);
  // the block's partial V urow: one warp per row, lanes along its columns
  const int warp = tid >> 5, lane = tid & 31;
  for (int e = warp; e < N; e += kWarps) {
    float acc = 0.f;
    for (int j = lane; j < ncol; j += 32) acc = fmaf(uval(e, j), B.urow()[j], acc);
    acc = warp_sum(acc);
    if (lane == 0) B.ypart()[e] = acc;
  }
  tm.lap(P.timing, kTVurow);
  }
  cluster.sync();
  // this block's share of the elements: the partials summed in block order
  // over distributed shared memory, T applied, the result sent to every block
  const int eb = (N + B.csize - 1) / B.csize;
  const int e1 = min(N, (B.rank + 1) * eb);
  for (int e = B.rank * eb + tid; e < e1; e += kThreads) {
    float s = 0.f;
    for (int b = 0; b < B.csize; ++b) s += cluster.map_shared_rank(B.ypart(), b)[e];
    const int a = e / n, p = e - a * n;
    const int pu = (p + 1 == n) ? 0 : p + 1;
    const int pl = (p == 0) ? n - 1 : p - 1;
    float yd = 0.f, yu = 0.f, yl = 0.f;
#pragma unroll
    for (int b = 0; b < DP; ++b) {
      const size_t o = (size_t)(a * DP + b) * n;
      yd = fmaf(__ldg(P.td + o + p), in[b * n + p], yd);
      yu = fmaf(__ldg(P.tu + o + p), in[b * n + pu], yu);
      yl = fmaf(__ldg(P.tl + o + p), in[b * n + pl], yl);
    }
    const float y = (yd + yu + yl) - s;
    for (int b = 0; b < B.csize; ++b) cluster.map_shared_rank(out, b)[e] = y;
  }
  cluster.sync();
  tm.lap(P.timing, kTExchange);
}

// z = M^-1 r, replicated in every block.  r must be complete (barrier
// before the call); ta/tb are the PCR ping-pong buffers, rc/za the coarse
// scratch.  Ends with a barrier.
template <int DP>
__device__ __forceinline__ void precond(const Params& P, const float* __restrict__ r,
                        float* __restrict__ z, float* ta, float* tb,
                        float* rc, float* za) {
  const int n = P.np, N = DP * n, L = P.nlevels;
  // one PCR level at element e: o = t + alpha t[p - s] + gamma t[p + s],
  // circular
  auto level = [&](const float* t, float* o, int e, int sm,
                   const float (&ca)[DP], const float (&cg)[DP]) {
    const int a = e / n, p = e - a * n;
    int pd = p - sm;
    if (pd < 0) pd += n;
    int pu = p + sm;
    if (pu >= n) pu -= n;
    float sa = 0.f, sg = 0.f;
#pragma unroll
    for (int b = 0; b < DP; ++b) {
      sa = fmaf(ca[b], t[b * n + pd], sa);
      sg = fmaf(cg[b], t[b * n + pu], sg);
    }
    o[e] = t[e] + sa + sg;
  };
  auto load_level = [&](int l, int e, float (&ca)[DP], float (&cg)[DP]) {
    const int a = e / n, p = e - a * n;
#pragma unroll
    for (int b = 0; b < DP; ++b) {
      const size_t c = ((size_t)(l * DP + a) * DP + b) * n + p;
      ca[b] = __ldg(P.alphas + c);
      cg[b] = __ldg(P.gammas + c);
    }
  };
  const float* t = r;
  const int e1 = threadIdx.x;
  const bool one = N <= (int)blockDim.x;
  float cb[DP];   // binv of this thread's element
  auto load_binv = [&]() {
    const int a = e1 / n, p = e1 - a * n;
#pragma unroll
    for (int b = 0; b < DP; ++b) cb[b] = __ldg(P.binv + (size_t)(a * DP + b) * n + p);
  };
  if (one) {
    // one element per thread: its planes are loaded kAhead levels ahead
    // into a ring (slot k holds level l + k, shifted down a slot a level),
    // so their latency hides behind that many levels; binv loads beside
    // the last level, when the ring holds that level alone
    constexpr int kAhead = ahead_levels<DP>();
    float ca[kAhead + 1][DP], cg[kAhead + 1][DP];
#pragma unroll
    for (int l = 0; l < kAhead; ++l)
      if (l < L && e1 < N) load_level(l, e1, ca[l], cg[l]);
    int sm = 1 % n;   // the shift 2^l mod Np
    for (int l = 0; l + 1 < L; ++l) {
      if (l + kAhead < L && e1 < N) load_level(l + kAhead, e1, ca[kAhead], cg[kAhead]);
      float* o = (l & 1) ? tb : ta;
      if (e1 < N) level(t, o, e1, sm, ca[0], cg[0]);
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
#pragma unroll
        for (int b = 0; b < DP; ++b) {
          ca[k][b] = ca[k + 1][b];
          cg[k][b] = cg[k + 1][b];
        }
      }
      __syncthreads();
      t = o;
      sm += sm;
      if (sm >= n) sm -= n;
    }
    if (e1 < N) load_binv();
    if (L > 0) {
      float* o = ((L - 1) & 1) ? tb : ta;
      if (e1 < N) level(t, o, e1, sm, ca[0], cg[0]);
      __syncthreads();
      t = o;
    }
  } else {
    float ca[DP], cg[DP];
    int sm = 1 % n;   // the shift 2^l mod Np
    for (int l = 0; l < L; ++l) {
      float* o = (l & 1) ? tb : ta;
      for (int e = threadIdx.x; e < N; e += blockDim.x) {
        load_level(l, e, ca, cg);
        level(t, o, e, sm, ca, cg);
      }
      __syncthreads();
      t = o;
      sm += sm;
      if (sm >= n) sm -= n;
    }
  }
  for (int e = threadIdx.x; e < N; e += blockDim.x) {
    const int a = e / n, p = e - a * n;
    float acc = 0.f;
#pragma unroll
    for (int b = 0; b < DP; ++b) {
      const float bi = one ? cb[b] : __ldg(P.binv + (size_t)(a * DP + b) * n + p);
      acc = fmaf(bi, t[b * n + p], acc);
    }
    z[e] = acc;
  }
  if (P.cinv != nullptr) {
    const int nc = P.nc;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int nwarps = blockDim.x >> 5;
    // restriction rc[b, g] = sum_p r[b, p] rmat[p, g]: one warp per (b, g)
    for (int q = warp; q < DP * nc; q += nwarps) {
      const int b = q / nc, g = q - b * nc;
      float acc = 0.f;
      for (int p = lane; p < n; p += 32)
        acc = fmaf(r[b * n + p], __ldg(P.rmat + (size_t)p * nc + g), acc);
      acc = warp_sum(acc);
      if (lane == 0) rc[q] = acc;
    }
    __syncthreads();
    // coarse solve za[a, g] = sum_{b, h} cinv[a, b, g, h] rc[b, h]
    for (int q = threadIdx.x; q < DP * nc; q += blockDim.x) {
      const int a = q / nc, g = q - a * nc;
      float acc = 0.f;
      for (int b = 0; b < DP; ++b) {
        const float* ci = P.cinv + ((size_t)(a * DP + b) * nc + g) * nc;
        for (int h = 0; h < nc; ++h) acc = fmaf(__ldg(ci + h), rc[b * nc + h], acc);
      }
      za[q] = acc;
    }
    __syncthreads();
    // prolongation z[a, p] += sum_g za[a, g] rmat[p, g]
    for (int e = threadIdx.x; e < DP * n; e += blockDim.x) {
      const int a = e / n, p = e - a * n;
      float acc = 0.f;
      for (int g = 0; g < nc; ++g)
        acc = fmaf(za[a * nc + g], __ldg(P.rmat + (size_t)p * nc + g), acc);
      z[e] += acc;
    }
  }
  __syncthreads();
}

template <int DP>
__global__ void __launch_bounds__(cluster_threads(DP), 1) fused_pcg_chunk_kernel(Params P) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = P.np, N = DP * n;
  const Smem L = smem_layout(DP, n, P.cp, P.nc, P.resident);
  float* x = smem + L.x;
  float* r = smem + L.r;
  float* p = smem + L.p;
  float* ap = smem + L.ap;
  float* z = smem + L.z;
  float* ta = smem + L.ta;
  float* tb = smem + L.tb;
  float* rc = smem + L.rc;
  float* za = smem + L.za;
  float* red = smem + L.red;
  Timer tm;
  tm.start(P.timing, cluster.block_rank() == 0 && threadIdx.x == 0);
  Block B;
  B.o_ypart = (int)L.ta;
  B.o_urow = (int)L.urow;
  B.o_scratch = (int)L.scratch;
  B.rank = (int)cluster.block_rank();
  B.csize = (int)cluster.num_blocks();
  B.j0 = min(P.mw, B.rank * P.cp);
  B.ncol = min(P.mw - B.j0, P.cp);
  B.o_us = (int)L.us;
  if (P.resident) {
    // the block's U slice, loaded once per launch
    float* us = smem + L.us;
    const int st = slice_stride(P.cp);
    for (int i = threadIdx.x; i < N * st; i += blockDim.x) {
      const int e = i / st, j = i - e * st;
      us[i] = j < B.ncol ? __ldg(P.u + (size_t)e * P.mw + B.j0 + j) : 0.f;
    }
  }

  // chunk entry: restart replaces the recurrence residual with the carried
  // true residual and resets the search direction
  const bool restart = P.restart != 0;
  for (int e = threadIdx.x; e < N; e += blockDim.x) {
    x[e] = P.x_in[e];
    r[e] = restart ? P.rt_in[e] : P.r_in[e];
  }
  __syncthreads();
  tm.lap(P.timing, kTOther);
  precond<DP>(P, r, z, ta, tb, rc, za);
  tm.lap(P.timing, kTPrecond);
  float sz = 0.f, sr = 0.f;
  for (int e = threadIdx.x; e < N; e += blockDim.x) {
    sz = fmaf(r[e], z[e], sz);
    sr = fmaf(r[e], r[e], sr);
    p[e] = restart ? z[e] : P.p_in[e];
  }
  float2 s2 = block_sum2<cluster_threads(DP)>(sz, sr, red);
  float rz = restart ? s2.x : *P.rz_in;
  float rr = s2.y;
  bool stop = *P.stop_in > 0;
  int it = *P.it_in;
  const float atol2 = *P.atol2;

  for (int k = 0; k < P.chunk_iters; ++k) {
    matvec<DP>(P, cluster, B, p, ap, tm);
    float part = 0.f;
    for (int e = threadIdx.x; e < N; e += blockDim.x) part = fmaf(p[e], ap[e], part);
    const float pap = block_sum2<cluster_threads(DP)>(part, 0.f, red).x;
    const bool breakdown = !(pap > 0.f) || !isfinite(pap);
    stop = stop || breakdown;
    const bool done = stop || (rr <= atol2) || (it >= P.maxit);
    const float alpha = done ? 0.f : rz / pap;
    for (int e = threadIdx.x; e < N; e += blockDim.x) {
      x[e] = x[e] + alpha * p[e];
      r[e] = r[e] - alpha * ap[e];
    }
    __syncthreads();
    tm.lap(P.timing, kTOther);
    precond<DP>(P, r, z, ta, tb, rc, za);
    tm.lap(P.timing, kTPrecond);
    sz = 0.f;
    sr = 0.f;
    for (int e = threadIdx.x; e < N; e += blockDim.x) {
      sz = fmaf(r[e], z[e], sz);
      sr = fmaf(r[e], r[e], sr);
    }
    s2 = block_sum2<cluster_threads(DP)>(sz, sr, red);
    const float rz_new = s2.x;
    rr = s2.y;
    const float safe_rz = (rz == 0.f) ? 1.f : rz;
    const float beta = done ? 0.f : rz_new / safe_rz;
    if (!done) {
      for (int e = threadIdx.x; e < N; e += blockDim.x) p[e] = z[e] + beta * p[e];
    }
    rz = done ? rz : rz_new;
    it += done ? 0 : 1;
    __syncthreads();
  }

  // chunk exit: the true residual rhs - S x and its squared norm, written by
  // block 0 (every block holds the same bits)
  tm.lap(P.timing, kTOther);
  matvec<DP>(P, cluster, B, x, ap, tm);
  sr = 0.f;
  for (int e = threadIdx.x; e < N; e += blockDim.x) {
    const float rt = P.rhs[e] - ap[e];
    if (B.rank == 0) {
      P.rt_out[e] = rt;
      P.x_out[e] = x[e];
      P.r_out[e] = r[e];
      P.p_out[e] = p[e];
    }
    sr = fmaf(rt, rt, sr);
  }
  const float rr_true = block_sum2<cluster_threads(DP)>(sr, 0.f, red).x;
  if (B.rank == 0 && threadIdx.x == 0) {
    *P.it_out = it;
    *P.rz_out = rz;
    *P.stop_out = stop ? 1 : 0;
    *P.rr_out = rr_true;
  }
  tm.lap(P.timing, kTOther);
}

// --- the split schedule ------------------------------------------------------
//
// A cooperative grid of `nclusters` clusters of C blocks (C = 16 on the
// card-wide plan, 7 clusters on an H100).  Block g of the grid holds the
// columns [g*cp, (g+1)*cp) of U, cp = ceil(Mw / grid), for every row, in
// shared memory for the whole launch: no U byte is read again after the
// load.  Within a cluster the state is split, not replicated: block b of
// every cluster owns the poses [b*ppb, (b+1)*ppb), ppb = ceil(Np / C), one
// (component, pose) element per thread, held in registers (x, r, p, z, ap);
// every cluster holds the whole state, and the clusters compute the same
// bits.  A CG trip:
//   * matvec: each block keeps the whole search direction p in shared memory
//     (pfull).  V^T p over its columns, T p at its elements, then its
//     partial V urow over all rows into zy; a cluster barrier; each block
//     sums the C partials of its elements over distributed shared memory in
//     rank order; with more than one cluster, each writes that cluster
//     partial to global memory (two buffers by trip parity), one grid
//     barrier, and every block sums the nclusters partials of its elements
//     in cluster order.  One grid barrier a trip;
//   * dot products: a block sum, then the C block sums over distributed
//     shared memory in rank order (a cluster barrier each);
//   * the preconditioner, split over the cluster's blocks.  A cluster
//     barrier costs 0.75 us on an H100 (chip_smoke.py, line b1_barriers),
//     more than a PCR level's work, so the first K levels (shifts 1 ...
//     2^(K-1)) run without one: each block gathers the new residual
//     r - alpha Ap over its poses and H = 2^K - 1 poses each side from the
//     owners' shares (r and Ap published by the p.Ap barrier, so no barrier
//     of its own), then runs K levels on that range, each on a range H_l
//     narrower, to its own poses.  The other L - K levels read their
//     shift-2^l neighbours from the owning block's shared memory, a cluster
//     barrier before each.  The block's share of the planes (and of the
//     local levels' wider ranges) is loaded into shared memory once per
//     launch where it fits beside U ("planes"), else read from L2;
//   * z is pushed into every block's zy, and after the (r.z, r.r) barrier
//     each block forms the whole new p = z + beta p itself, so p needs no
//     barrier of its own.
// Cluster barriers a trip: the partial V urow, p.Ap, (r.z, r.r), L - K for
// the PCR and one for the coarse restriction: L - K + 3 (+1).

constexpr int kSThreads = 384;        // threads a block of the split schedule
constexpr int kSWarps = kSThreads / 32;
constexpr int kMaxClusters = 16;      // clusters of the split schedule's grid
// A split-schedule block asks for at least this much shared memory, so no
// two blocks share an SM (228 KB an SM, 1 KB of it reserved per block): a
// cluster's blocks sit on C SMs and the grid on nclusters * C.
constexpr size_t kOneBlockPerSm = 116 * 1024;

// Shared memory in floats (mirrored by split_smem_bytes in
// ops/fused_pcg.py): the U slice [DP*Np, cp | 1] (odd row stride: no bank
// conflicts when a thread reads a row); pfull and zy, two whole [DP, Np]
// vectors; the block's shares of r, Ap and the two PCR buffers (cluster
// visible); the local levels' buffers [DP, ppb + 2H] (one when K = 0);
// when `planes`, the share of the planes and the local levels' planes over
// their ranges; the coarse partials (two buffers), rc and za; the
// column-sum scratch, urow, the block reduction slots (two buffers), the
// cluster reduction slots and their sums (two pairs each).
struct SSmem {
  size_t us, pfull, zy, rs, aps, ta, tb, xa, xb, al, ga, bi, td, tu, tl, lal, lga,
      rcp, rc, za, colsum, urow, red, cred, cbc, total;
};

// The output range of local level l < K on the extended poses [0, ppb + 2H):
// [2^(l+1) - 1, that + local_len(l)).
__host__ __device__ inline int local_len(int ppb, int K, int l) {
  return ppb + 2 * ((1 << K) - (2 << l));
}

__host__ __device__ inline int split_stride(int cp) { return cp | 1; }

__host__ __device__ inline SSmem split_layout(int dp, int np, int cp, int ppb, int nl,
                                              int nc, int planes, int K) {
  SSmem S;
  const size_t n = (size_t)dp * np, e = (size_t)dp * ppb, pl = (size_t)dp * dp * ppb;
  const size_t ext = (size_t)dp * (ppb + 2 * ((1 << K) - 1));
  size_t lpl = 0;   // the local levels' planes, one kind
  for (int l = 0; l < K; ++l) lpl += (size_t)dp * dp * local_len(ppb, K, l);
  size_t o = 0;
  S.us = o; o += n * split_stride(cp);
  S.pfull = o; o += n;
  S.zy = o; o += n;
  S.rs = o; o += e;
  S.aps = o; o += e;
  S.ta = o; o += e;
  S.tb = o; o += e;
  S.xa = o; o += ext;
  S.xb = o; o += K > 0 ? ext : 0;
  S.al = o; o += planes ? (size_t)nl * pl : 0;
  S.ga = o; o += planes ? (size_t)nl * pl : 0;
  S.bi = o; o += planes ? pl : 0;
  S.td = o; o += planes ? pl : 0;
  S.tu = o; o += planes ? pl : 0;
  S.tl = o; o += planes ? pl : 0;
  S.lal = o; o += planes ? lpl : 0;
  S.lga = o; o += planes ? lpl : 0;
  S.rcp = o; o += 2 * (size_t)dp * nc;
  S.rc = o; o += (size_t)dp * nc;
  S.za = o; o += (size_t)dp * nc;
  S.colsum = o; o += kSThreads;
  S.urow = o; o += cp;
  S.red = o; o += 4 * kSWarps;
  S.cred = o; o += 4;
  S.cbc = o; o += 4;
  S.total = o * sizeof(float);
  if (S.total < kOneBlockPerSm) S.total = kOneBlockPerSm;
  return S;
}

// One block of the split schedule: where it sits, its buffers, and the one
// element its thread owns (component ea of pose ep; slot threadIdx.x of the
// share buffers), live where that pose exists.  Buffers are held as 32-bit
// offsets into the dynamic shared memory, not as pointers: a block of 384
// threads has 168 registers a thread, and pointers spilled.
struct Split {
  int n, N, C, rank, cid, ppb, p0, own, ncol, ust;
  int ea, epl, ep, eg;
  // this thread's element of the extended range of the local PCR levels
  // (component ka of extended pose kj, pose kq), where it has one (klive);
  // its owner ko and the owner's share slot kk
  int ka, kj, kq, ko, kk;
  bool live, planes, klive;
  int o_us, o_pfull, o_zy, o_rs, o_aps, o_ta, o_tb, o_xa, o_xb, o_rcp, o_rc, o_za,
      o_colsum, o_urow, o_red, o_cred, o_cbc, o_al, o_ga, o_bi, o_td, o_tu, o_tl, o_lal,
      o_lga;
  int ps;           // the planes' pose stride: ppb (the share) or Np (global)
  int slot, cslot;  // reduction rings
#define SPLIT_BUF(name) \
  __device__ __forceinline__ float* name() const { return shm() + o_##name; }
  SPLIT_BUF(us) SPLIT_BUF(pfull) SPLIT_BUF(zy) SPLIT_BUF(rs) SPLIT_BUF(aps) SPLIT_BUF(ta)
  SPLIT_BUF(tb) SPLIT_BUF(xa) SPLIT_BUF(xb) SPLIT_BUF(rcp) SPLIT_BUF(rc) SPLIT_BUF(za)
  SPLIT_BUF(colsum) SPLIT_BUF(urow) SPLIT_BUF(red) SPLIT_BUF(cred) SPLIT_BUF(cbc)
#undef SPLIT_BUF
  // a plane kind's base: the block's share, or the global planes at p0
  __device__ __forceinline__ const float* plane(const float* g, int off) const {
    return planes ? shm() + off : g + p0;
  }
};

// Pointer to component 0 of pose q in the copy of a share buffer `t` held by
// the block that owns q (component b at + b * ppb).
__device__ __forceinline__ const float* share_at(const Split& S, cg::cluster_group& cluster,
                                                 const float* t, int q) {
  const int owner = q / S.ppb;
  const int off = q - owner * S.ppb;
  return (owner == S.rank ? t : cluster.map_shared_rank(t, owner)) + off;
}

// Sum of a and b over the block of kSThreads, returned to every thread:
// the warps' sums through `red` (two buffers of 2 kSWarps floats, taken in
// turn by `parity`), then every warp sums them itself in the same order.
// One block barrier: a buffer is written again only two calls later, after
// every warp has passed the barrier of the call between.
__device__ __forceinline__ float2 block_sum2_ring(float a, float b, float* red, int parity) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* r = red + 2 * kSWarps * (parity & 1);
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    r[warp] = a;
    r[kSWarps + warp] = b;
  }
  __syncthreads();
  return make_float2(warp_sum(lane < kSWarps ? r[lane] : 0.f),
                     warp_sum(lane < kSWarps ? r[kSWarps + lane] : 0.f));
}

// The block sums of (a, b) summed over the cluster in rank order: every
// block of every cluster gets the same bits.
__device__ __forceinline__ float2 cluster_sum2(const Params& P, Split& S,
                                               cg::cluster_group& cluster, float a, float b,
                                               Timer& tm) {
  tm.lap(P.timing, kTOther);
  const int parity = S.slot++;
  const float2 part = block_sum2_ring(a, b, S.red(), parity);
  float* slot = S.cred() + 2 * (parity & 1);
  if (threadIdx.x == 0) {
    slot[0] = part.x;
    slot[1] = part.y;
  }
  tm.lap(P.timing, kTDots);
  cluster.sync();
  tm.lap(P.timing, kTBarrier);
  // warp 0 reads the C slots (one request each: every warp asking costs
  // 2-3 us a trip) and shares the sums; a sum buffer is written again only
  // two calls later, after the block barrier of the call between
  float* sums = S.cbc() + 2 * (parity & 1);
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float va = 0.f, vb = 0.f;
    if (lane < S.C) {
      const float* rem = cluster.map_shared_rank(slot, lane);
      va = rem[0];
      vb = rem[1];
    }
    va = warp_sum(va);
    vb = warp_sum(vb);
    if (lane == 0) {
      sums[0] = va;
      sums[1] = vb;
    }
  }
  __syncthreads();
  const float2 out = make_float2(sums[0], sums[1]);
  tm.lap(P.timing, kTDots);
  return out;
}

// Write this thread's element value into `buf` of every block of the
// cluster (visible after the next cluster barrier).  (Staging the share
// and storing float4s, four times fewer requests, measured slower: 0.285
// against 0.270 ms a chunk at Np=128, dp=6, with the float4 y-sum below.)
__device__ __forceinline__ void push_all(const Split& S, cg::cluster_group& cluster, float* buf,
                                         float v) {
  if (!S.live) return;
#pragma unroll
  for (int b = 0; b < kMaxCluster; ++b)
    if (b < S.C) cluster.map_shared_rank(buf, b)[S.eg] = v;
}

// (S in) at this thread's element.  `in` is the whole vector in this
// block's shared memory; the partial V urow goes to zy (which may be `in`:
// it is read before zy is written).  Grid barrier `trip`'s parity picks
// the global partial buffer.
template <int DP>
__device__ __forceinline__ float split_matvec(const Params& P, Split& S,
                                              cg::cluster_group& cluster, const float* in,
                                              int trip, Timer& tm) {
  const int tid = threadIdx.x, N = S.N, n = S.n, ust = S.ust, ncol = S.ncol;
  tm.lap(P.timing, kTOther);
  // urow = U_b^T in: thread (column j, row group g of G), four sums each;
  // the groups combined in a fixed order, H = min(8, G) at a time, then the H
  const int cpp = ncol > 0 ? ncol : 1, G = kSThreads / cpp;
  const int j = tid % cpp, g = tid / cpp;
  if (g < G) {
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    if (j < ncol) {
      int e = g;
      for (; e + 3 * G < N; e += 4 * G) {
        a0 = fmaf(in[e], S.us()[(size_t)e * ust + j], a0);
        a1 = fmaf(in[e + G], S.us()[(size_t)(e + G) * ust + j], a1);
        a2 = fmaf(in[e + 2 * G], S.us()[(size_t)(e + 2 * G) * ust + j], a2);
        a3 = fmaf(in[e + 3 * G], S.us()[(size_t)(e + 3 * G) * ust + j], a3);
      }
      for (; e < N; e += G) a0 = fmaf(in[e], S.us()[(size_t)e * ust + j], a0);
    }
    S.colsum()[tid] = (a0 + a1) + (a2 + a3);
  }
  // T in at this thread's element (circular neighbours), from the whole copy
  float tin = 0.f;
  if (S.live) {
    const int a = S.ea, p = S.ep;
    const int pu = (p + 1 == n) ? 0 : p + 1;
    const int pl = (p == 0) ? n - 1 : p - 1;
    float yd = 0.f, yu = 0.f, yl = 0.f;
#pragma unroll
    for (int b = 0; b < DP; ++b) {
      const size_t o = (size_t)(a * DP + b) * S.ps + S.epl;
      yd = fmaf(S.plane(P.td, S.o_td)[o], in[b * n + p], yd);
      yu = fmaf(S.plane(P.tu, S.o_tu)[o], in[b * n + pu], yu);
      yl = fmaf(S.plane(P.tl, S.o_tl)[o], in[b * n + pl], yl);
    }
    tin = yd + yu + yl;
  }
  __syncthreads();
  const int H = G < 8 ? G : 8;
  float s8 = 0.f;
  if (tid < H * cpp) {
    for (int h = g; h < G; h += H) s8 += S.colsum()[h * cpp + j];
  }
  __syncthreads();
  if (tid < H * cpp) S.colsum()[tid] = s8;
  __syncthreads();
  if (tid < ncol) {
    float u = S.colsum()[tid];
    for (int h = 1; h < H; ++h) u += S.colsum()[h * cpp + tid];
    S.urow()[tid] = u;
  }
  __syncthreads();
  tm.lap(P.timing, kTVtx);
  // the block's partial V urow over every row, one thread per row
  for (int e = tid; e < N; e += kSThreads) {
    const float* ur = S.us() + (size_t)e * ust;
    float a0 = 0.f, a1 = 0.f;
    int k = 0;
    for (; k + 1 < ncol; k += 2) {
      a0 = fmaf(ur[k], S.urow()[k], a0);
      a1 = fmaf(ur[k + 1], S.urow()[k + 1], a1);
    }
    if (k < ncol) a0 = fmaf(ur[k], S.urow()[k], a0);
    S.zy()[e] = a0 + a1;
  }
  tm.lap(P.timing, kTVurow);
  cluster.sync();
  tm.lap(P.timing, kTBarrier);
  // the cluster's V urow at this thread's element: the C partials in rank
  // order
  float y = 0.f;
  if (S.live) {
    // eight loads in flight, then their sum in order (a missing rank adds
    // an exact zero)
    float* zy = S.zy();
    for (int b = 0; b < S.C; b += 8) {
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        v[k] = b + k < S.C ? cluster.map_shared_rank(zy, b + k)[S.eg] : 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) y += v[k];
    }
  }
  tm.lap(P.timing, kTExchange);
  if (P.nclusters > 1) {
    // the whole grid's: the cluster partials in cluster order, through L2
    float* gp = P.gpart + (size_t)(trip & 1) * P.nclusters * N;
    if (S.live) __stcg(gp + (size_t)S.cid * N + S.eg, y);
    tm.lap(P.timing, kTExchange);
    cg::this_grid().sync();
    tm.lap(P.timing, kTGrid);
    y = 0.f;
    if (S.live) {
      // eight L2 reads in flight (7 clusters on an H100: one round trip)
      for (int c = 0; c < P.nclusters; c += 8) {
        float v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          v[k] = c + k < P.nclusters ? __ldcg(gp + (size_t)(c + k) * N + S.eg) : 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k) y += v[k];
      }
    }
    tm.lap(P.timing, kTExchange);
  }
  return tin - y;
}

// z = M^-1 r at this thread's element, where r = rs - alpha aps: the carried
// residual and A p at every block's share, published by the last cluster
// barrier (rs and aps are rewritten only after the next one); `r` is this
// thread's, computed as the gather computes it (the same bits).
template <int DP>
__device__ __forceinline__ float split_precond(const Params& P, Split& S,
                                               cg::cluster_group& cluster, float r,
                                               float alpha, Timer& tm) {
  const int n = S.n, L = P.nlevels, ppb = S.ppb, K = P.klocal, tid = threadIdx.x;
  const int H = (1 << K) - 1, E0 = ppb + 2 * H;
  // level 0's input over the block's poses and H each side (circular), one
  // element a thread
  if (S.klive) {
    const float* rs = S.ko == S.rank ? S.rs() : cluster.map_shared_rank(S.rs(), S.ko);
    const float* aps = S.ko == S.rank ? S.aps() : cluster.map_shared_rank(S.aps(), S.ko);
    S.xa()[tid] = fmaf(-alpha, aps[S.kk], rs[S.kk]);
  }
  __syncthreads();
  float* rcp = nullptr;
  if (P.cinv != nullptr) {
    // the coarse restriction of r over the block's poses, one warp per
    // (b, g), summed over the cluster after the PCR
    const int nc = P.nc, nq = DP * nc;
    const int warp = tid >> 5, lane = tid & 31;
    rcp = S.rcp() + (S.cslot & 1) * nq;
    S.cslot++;
    for (int q = warp; q < nq; q += kSWarps) {
      const int b = q / nc, g = q - b * nc;
      float acc = 0.f;
      for (int pl = lane; pl < S.own; pl += 32)
        acc = fmaf(S.xa()[b * E0 + H + pl], __ldg(P.rmat + (size_t)(S.p0 + pl) * nc + g), acc);
      acc = warp_sum(acc);
      if (lane == 0) rcp[q] = acc;
    }
  }
  // the local levels: level l's output over [2^(l+1) - 1, + local_len)
  float* cur = S.xa();
  float* nxt = S.xb();
  size_t loff = 0;
  for (int l = 0; l < K; ++l) {
    const int sh = 1 << l, lo = 2 * sh - 1, len = local_len(ppb, K, l);
    const int a = S.ka, j = S.kj, jj = j - lo;
    if (S.klive && jj >= 0 && jj < len) {
      float sa = 0.f, sg = 0.f;
#pragma unroll
      for (int b = 0; b < DP; ++b) {
        float ca, cg_;
        if (S.planes) {
          const int c = (int)loff + (a * DP + b) * len + jj;
          ca = shm()[S.o_lal + c];
          cg_ = shm()[S.o_lga + c];
        } else {
          const size_t c = ((size_t)(l * DP + a) * DP + b) * n + S.kq;
          ca = __ldg(P.alphas + c);
          cg_ = __ldg(P.gammas + c);
        }
        sa = fmaf(ca, cur[b * E0 + j - sh], sa);
        sg = fmaf(cg_, cur[b * E0 + j + sh], sg);
      }
      nxt[tid] = cur[tid] + sa + sg;
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
    loff += (size_t)DP * DP * len;
  }
  tm.lap(P.timing, kTLocal);
  // the other levels, split over the cluster: level K's input is the share
  const float* t = cur + H;   // component b of own pose pl at t[b * ts + pl]
  int ts = E0;
  if (K < L) {
    float tv = S.live ? cur[S.ea * E0 + H + S.epl] : 0.f;
    if (S.live) S.ta()[tid] = tv;
    float ca[DP], cg_[DP], na[DP] = {}, ng[DP] = {};
    auto load = [&](int l, float (&a)[DP], float (&g)[DP]) {
#pragma unroll
      for (int b = 0; b < DP; ++b) {
        const size_t k = (size_t)((l * DP + S.ea) * DP + b) * S.ps + S.epl;
        a[b] = S.plane(P.alphas, S.o_al)[k];
        g[b] = S.plane(P.gammas, S.o_ga)[k];
      }
    };
    if (S.live) load(K, na, ng);
    int sm = 1 % n;   // the shift 2^l mod Np
    for (int l = 0; l < K; ++l) {
      sm += sm;
      if (sm >= n) sm -= n;
    }
    tm.lap(P.timing, kTPrecond);
    cluster.sync();
    tm.lap(P.timing, kTBarrier);
    const float* ti = S.ta();
    for (int l = K; l < L; ++l) {
#pragma unroll
      for (int b = 0; b < DP; ++b) {
        ca[b] = na[b];
        cg_[b] = ng[b];
      }
      // the next level's planes load while this one runs
      if (S.live && l + 1 < L) load(l + 1, na, ng);
      float* o = ((l - K) & 1) ? S.ta() : S.tb();
      if (S.live) {
        int pd = S.ep - sm;
        if (pd < 0) pd += n;
        int pu = S.ep + sm;
        if (pu >= n) pu -= n;
        const float* td = share_at(S, cluster, ti, pd);
        const float* tu = share_at(S, cluster, ti, pu);
        float sa = 0.f, sg = 0.f;
#pragma unroll
        for (int b = 0; b < DP; ++b) {
          sa = fmaf(ca[b], td[b * ppb], sa);
          sg = fmaf(cg_[b], tu[b * ppb], sg);
        }
        tv = tv + sa + sg;
        o[tid] = tv;
      }
      tm.lap(P.timing, kTPrecond);
      if (l + 1 < L) cluster.sync();
      else __syncthreads();
      tm.lap(P.timing, kTBarrier);
      ti = o;
      sm += sm;
      if (sm >= n) sm -= n;
    }
    t = ti;
    ts = ppb;
  }
  float z = 0.f;
  if (S.live) {
#pragma unroll
    for (int b = 0; b < DP; ++b)
      z = fmaf(S.plane(P.binv, S.o_bi)[(size_t)(S.ea * DP + b) * S.ps + S.epl], t[b * ts + S.epl], z);
  }
  if (P.cinv != nullptr) {
    const int nc = P.nc, nq = DP * nc;
    tm.lap(P.timing, kTPrecond);
    cluster.sync();
    tm.lap(P.timing, kTBarrier);
    // the cluster's, in rank order
    for (int q = tid; q < nq; q += kSThreads) {
      float acc = 0.f;
      for (int b = 0; b < S.C; ++b) acc += cluster.map_shared_rank(rcp, b)[q];
      S.rc()[q] = acc;
    }
    __syncthreads();
    // coarse solve za[a, g] = sum_{b, h} cinv[a, b, g, h] rc[b, h]
    for (int q = tid; q < nq; q += kSThreads) {
      const int a = q / nc, g = q - a * nc;
      float acc = 0.f;
      for (int b = 0; b < DP; ++b) {
        const float* ci = P.cinv + ((size_t)(a * DP + b) * nc + g) * nc;
        for (int h = 0; h < nc; ++h) acc = fmaf(__ldg(ci + h), S.rc()[b * nc + h], acc);
      }
      S.za()[q] = acc;
    }
    __syncthreads();
    // prolongation at this thread's element
    if (S.live) {
      float acc = 0.f;
      for (int g = 0; g < nc; ++g)
        acc = fmaf(S.za()[S.ea * nc + g], __ldg(P.rmat + (size_t)S.ep * nc + g), acc);
      z += acc;
    }
  }
  return z;
}

template <int DP>
__global__ void __launch_bounds__(kSThreads, 1) fused_pcg_split_kernel(Params P) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  Split S;
  S.n = P.np;
  S.N = DP * P.np;
  S.C = (int)cluster.num_blocks();
  S.rank = (int)cluster.block_rank();
  S.cid = (int)blockIdx.x / S.C;
  S.ppb = P.ppb;
  S.p0 = min(P.np, S.rank * S.ppb);
  S.own = min(P.np - S.p0, S.ppb);
  const int j0 = min(P.mw, (int)blockIdx.x * P.cp);
  S.ncol = min(P.mw - j0, P.cp);
  S.ust = split_stride(P.cp);
  S.ea = tid / S.ppb;
  S.epl = tid - S.ea * S.ppb;
  S.live = S.ea < DP && S.epl < S.own;
  S.ep = S.p0 + S.epl;
  S.eg = S.ea * P.np + S.ep;
  {
    const int H = (1 << P.klocal) - 1, E0 = S.ppb + 2 * H;
    S.ka = tid / E0;
    S.kj = tid - S.ka * E0;
    S.klive = S.ka < DP;
    int q = (S.p0 - H + S.kj) % P.np;
    if (q < 0) q += P.np;
    S.kq = q;
    S.ko = q / S.ppb;
    S.kk = S.ka * S.ppb + (q - S.ko * S.ppb);
  }
  const SSmem L = split_layout(DP, P.np, P.cp, S.ppb, P.nlevels, P.nc, P.planes,
                               P.klocal);
  S.o_us = (int)L.us;
  S.o_pfull = (int)L.pfull;
  S.o_zy = (int)L.zy;
  S.o_rs = (int)L.rs;
  S.o_aps = (int)L.aps;
  S.o_ta = (int)L.ta;
  S.o_tb = (int)L.tb;
  S.o_xa = (int)L.xa;
  S.o_xb = (int)L.xb;
  S.o_rcp = (int)L.rcp;
  S.o_rc = (int)L.rc;
  S.o_za = (int)L.za;
  S.o_colsum = (int)L.colsum;
  S.o_urow = (int)L.urow;
  S.o_red = (int)L.red;
  S.o_cred = (int)L.cred;
  S.o_cbc = (int)L.cbc;
  S.o_al = (int)L.al;
  S.o_ga = (int)L.ga;
  S.o_bi = (int)L.bi;
  S.o_td = (int)L.td;
  S.o_tu = (int)L.tu;
  S.o_tl = (int)L.tl;
  S.o_lal = (int)L.lal;
  S.o_lga = (int)L.lga;
  S.planes = P.planes != 0;
  S.ps = S.planes ? S.ppb : P.np;
  S.slot = 0;
  S.cslot = 0;
  Timer tm;
  tm.start(P.timing, blockIdx.x == 0 && tid == 0);

  // the block's U columns for every row, once per launch (zero past them)
  {
    const int N = S.N, st = S.ust;
    float* us = S.us();
    for (int i = tid; i < N * st; i += kSThreads) {
      const int e = i / st, jj = i - e * st;
      us[i] = jj < S.ncol ? __ldg(P.u + (size_t)e * P.mw + j0 + jj) : 0.f;
    }
  }
  if (S.planes) {
    // the block's share of the planes
    const int dd = DP * DP;
    auto share = [&](size_t off, const float* g, int planes) {
      float* d = smem + off;
      for (int i = tid; i < planes * S.ppb; i += kSThreads) {
        const int k = i / S.ppb, pl = i - k * S.ppb;
        d[i] = pl < S.own ? __ldg(g + (size_t)k * P.np + S.p0 + pl) : 0.f;
      }
    };
    share(L.al, P.alphas, P.nlevels * dd);
    share(L.ga, P.gammas, P.nlevels * dd);
    share(L.bi, P.binv, dd);
    share(L.td, P.td, dd);
    share(L.tu, P.tu, dd);
    share(L.tl, P.tl, dd);
    // the local levels' planes over their ranges of the extended poses
    const int H = (1 << P.klocal) - 1;
    size_t loff = 0;
    for (int l = 0; l < P.klocal; ++l) {
      const int lo = (2 << l) - 1, len = local_len(S.ppb, P.klocal, l);
      for (int i = tid; i < dd * len; i += kSThreads) {
        const int ab = i / len, jj = i - ab * len;
        int q = (S.p0 - H + lo + jj) % P.np;
        if (q < 0) q += P.np;
        const size_t c = ((size_t)l * dd + ab) * P.np + q;
        smem[L.lal + loff + i] = __ldg(P.alphas + c);
        smem[L.lga + loff + i] = __ldg(P.gammas + c);
      }
      loff += (size_t)dd * len;
    }
  }

  // chunk entry: restart replaces the recurrence residual with the carried
  // true residual and resets the search direction
  const bool restart = P.restart != 0;
  float x = 0.f, r = 0.f;
  if (S.live) {
    x = P.x_in[S.eg];
    r = restart ? P.rt_in[S.eg] : P.r_in[S.eg];
    S.rs()[tid] = r;
    S.aps()[tid] = 0.f;
  }
  cluster.sync();
  tm.lap(P.timing, kTOther);
  float z = split_precond<DP>(P, S, cluster, r, 0.f, tm);
  tm.lap(P.timing, kTPrecond);
  if (restart) push_all(S, cluster, S.zy(), z);
  float2 s2 = cluster_sum2(P, S, cluster, r * z, r * r, tm);
  for (int e = tid; e < S.N; e += kSThreads) S.pfull()[e] = restart ? S.zy()[e] : P.p_in[e];
  __syncthreads();
  float p = S.live ? S.pfull()[S.eg] : 0.f;
  float rz = restart ? s2.x : *P.rz_in;
  float rr = s2.y;
  bool stop = *P.stop_in > 0;
  int it = *P.it_in;
  const float atol2 = *P.atol2;
  int trip = 0;

  for (int k = 0; k < P.chunk_iters; ++k) {
    const float ap = split_matvec<DP>(P, S, cluster, S.pfull(), trip++, tm);
    if (S.live) S.aps()[tid] = ap;
    // the barrier also publishes Ap to the preconditioner's gather
    const float pap = cluster_sum2(P, S, cluster, p * ap, 0.f, tm).x;
    const bool breakdown = !(pap > 0.f) || !isfinite(pap);
    stop = stop || breakdown;
    const bool done = stop || (rr <= atol2) || (it >= P.maxit);
    const float alpha = done ? 0.f : rz / pap;
    x = x + alpha * p;
    r = fmaf(-alpha, ap, r);   // as the gather forms it
    tm.lap(P.timing, kTOther);
    z = split_precond<DP>(P, S, cluster, r, alpha, tm);
    tm.lap(P.timing, kTPrecond);
    push_all(S, cluster, S.zy(), z);
    s2 = cluster_sum2(P, S, cluster, r * z, r * r, tm);
    // every block has gathered the old r: the share takes the new one
    if (S.live) S.rs()[tid] = r;
    const float rz_new = s2.x;
    rr = s2.y;
    const float safe_rz = (rz == 0.f) ? 1.f : rz;
    const float beta = done ? 0.f : rz_new / safe_rz;
    if (!done) {
      // every block forms the whole new p from the pushed z: the same bits
      for (int e = tid; e < S.N; e += kSThreads) S.pfull()[e] = S.zy()[e] + beta * S.pfull()[e];
    }
    __syncthreads();
    p = S.live ? S.pfull()[S.eg] : 0.f;
    rz = done ? rz : rz_new;
    it += done ? 0 : 1;
  }

  // chunk exit: the true residual rhs - S x and its squared norm, written by
  // cluster 0 (every cluster holds the same bits).  zy is read by every
  // block until the barrier, then takes the pushed x
  tm.lap(P.timing, kTOther);
  cluster.sync();
  push_all(S, cluster, S.zy(), x);
  cluster.sync();
  const float ax = split_matvec<DP>(P, S, cluster, S.zy(), trip++, tm);
  const float rt = S.live ? P.rhs[S.eg] - ax : 0.f;
  const float rr_true = cluster_sum2(P, S, cluster, rt * rt, 0.f, tm).x;
  if (S.cid == 0 && S.live) {
    P.rt_out[S.eg] = rt;
    P.x_out[S.eg] = x;
    P.r_out[S.eg] = r;
    P.p_out[S.eg] = p;
  }
  if (blockIdx.x == 0 && tid == 0) {
    *P.it_out = it;
    *P.rz_out = rz;
    *P.stop_out = stop ? 1 : 0;
    *P.rr_out = rr_true;
  }
  tm.lap(P.timing, kTOther);
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

int cols_per_block(int mw, int blocks) { return (mw + blocks - 1) / blocks; }

// dims of a launch (mirrored by _b1_dims in ops/fused_pcg.py)
enum {
  kDimDp, kDimNp, kDimMw, kDimLevels, kDimNc, kDimIters, kDimMaxit, kDimRestart,
  kDimSplit,      // 1: the split schedule, 0: the one replicated cluster
  kDimCluster,    // blocks a cluster
  kDimClusters,   // clusters in the grid (1 on the replicated schedule)
  kDimResident,   // replicated schedule: the U slice in shared memory
  kDimPlanes,     // split schedule: the planes' share in shared memory
  kDimLocal,      // split schedule: PCR levels on an extended range, K
  kNumDims
};
constexpr int kNumPtrs = 28;

using KernelFn = void (*)(Params);

// The instantiation for a pose block size and schedule (null for one that
// is not built).
KernelFn kernel_for(int dp, bool split) {
  if (dp == 3) return split ? fused_pcg_split_kernel<3> : fused_pcg_chunk_kernel<3>;
  if (dp == 6) return split ? fused_pcg_split_kernel<6> : fused_pcg_chunk_kernel<6>;
  return nullptr;
}

struct Shape {
  KernelFn kernel;
  bool split;
  int cluster, clusters, threads, cp, ppb;
  size_t bytes;
};

// The launch shape of dims, or false for dims the kernels do not take.
bool shape_of(const int* d, Shape& sh) {
  const int dp = d[kDimDp], np = d[kDimNp], mw = d[kDimMw], cl = d[kDimCluster];
  sh.split = d[kDimSplit] != 0;
  sh.kernel = kernel_for(dp, sh.split);
  if (sh.kernel == nullptr || np < 1 || mw < 1 || d[kDimLevels] < 0 || d[kDimNc] < 0 ||
      d[kDimIters] < 0 || cl < 1 || cl > kMaxCluster)
    return false;
  sh.cluster = cl;
  sh.clusters = d[kDimClusters];
  if (sh.split) {
    if (sh.clusters < 1 || sh.clusters > kMaxClusters) return false;
    sh.threads = kSThreads;
    sh.ppb = (np + cl - 1) / cl;
    sh.cp = cols_per_block(mw, sh.clusters * cl);
    const int K = d[kDimLocal];
    // one element a thread, also on the local levels' extended range
    if (sh.cp > kSThreads || K < 0 || K > d[kDimLevels] || K > 15 ||
        dp * (sh.ppb + 2 * ((1 << K) - 1)) > kSThreads)
      return false;
    sh.bytes = split_layout(dp, np, sh.cp, sh.ppb, d[kDimLevels], d[kDimNc],
                            d[kDimPlanes] != 0, K).total;
  } else {
    if (sh.clusters != 1) return false;
    sh.threads = cluster_threads(dp);
    sh.ppb = 0;
    sh.cp = cols_per_block(mw, cl);
    sh.bytes = smem_layout(dp, np, sh.cp, d[kDimNc], d[kDimResident] != 0).total;
  }
  return true;
}

// the cluster schedule: one cluster, an ordinary launch; the split schedule: a
// cooperative grid of clusters.
cudaLaunchConfig_t launch_config(const Shape& sh, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sh.clusters * sh.cluster);
  cfg.blockDim = dim3(sh.threads);
  cfg.dynamicSmemBytes = sh.bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = sh.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = sh.split ? 2 : 1;
  return cfg;
}

// Attributes are per instantiation: set on the one that will be queried or
// launched.
cudaError_t set_attributes(const void* kernel, int cluster, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                              cluster > 8 ? 1 : 0);
}

// `iters` barriers and nothing else, on the launch shape of a B1 schedule:
// kind 0 the cluster barrier, kind 1 the grid barrier (cooperative launch),
// kind 2 the block barrier.  Timed with CUDA events around the launch.
__global__ void barrier_probe_kernel(int iters, int kind) {
  if (kind == 0) {
    cg::cluster_group cluster = cg::this_cluster();
    for (int i = 0; i < iters; ++i) cluster.sync();
  } else if (kind == 1) {
    cg::grid_group grid = cg::this_grid();
    for (int i = 0; i < iters; ++i) grid.sync();
  } else {
    for (int i = 0; i < iters; ++i) __syncthreads();
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block at dims, in bytes (< 0 for dims the
// kernels do not take).
long long fused_pcg_chunk_smem_bytes(const int* dims, int ndims) {
  Shape sh;
  if (ndims != kNumDims || !shape_of(dims, sh)) return -1;
  return (long long)sh.bytes;
}

// The device's opt-in shared-memory maximum per block, in bytes (< 0 on
// error).
long long fused_pcg_chunk_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return -1;
  return v;
}

// How many clusters of dims' size, at dims' shared memory, the card runs at
// once (0: it refuses the cluster, or cannot launch cooperatively where the
// split schedule needs it).  Returns a cudaError_t.
int fused_pcg_chunk_max_clusters(const int* dims, int ndims, int device, int* count) {
  *count = 0;
  Shape sh;
  if (ndims != kNumDims || !shape_of(dims, sh)) return (int)cudaErrorInvalidValue;
  if (sh.split) {
    int coop = 0;
    cudaError_t err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (err != cudaSuccess) return (int)err;
    if (!coop) return 0;
  }
  cudaError_t err = set_attributes((const void*)sh.kernel, sh.cluster, sh.bytes);
  if (err != cudaSuccess) return (int)err;
  sh.clusters = 1;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = launch_config(sh, 0, attr);
  return (int)cudaOccupancyMaxActiveClusters(count, sh.kernel, &cfg);
}

// An instantiation as the card compiled it: out[0] its registers a thread,
// out[1] its local memory a thread (spilled registers).  Returns a
// cudaError_t.
int fused_pcg_chunk_attrs(int dp, int split, long long* out) {
  const KernelFn kernel = kernel_for(dp, split != 0);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = (long long)fa.numRegs;
  out[1] = (long long)fa.localSizeBytes;
  return 0;
}

// Launch one chunk at dims on `stream`.  ptrs: atol2 it rz stop rhs x r p rt
// | u td tu tl alphas gammas binv cinv rmat | x r p rt it rz stop rr
// (outputs) | gpart (split schedule with more than one cluster: 2 *
// clusters * dp * Np floats, else null) | timing (kTimers clock64 sums of
// block 0, or null).  Returns a cudaError_t (0 = launched).
int fused_pcg_chunk_launch(const int* dims, int ndims, void* const* ptrs, int nptrs,
                           void* stream) {
  Shape sh;
  if (ndims != kNumDims || nptrs != kNumPtrs || !shape_of(dims, sh))
    return (int)cudaErrorInvalidValue;
  auto f = [&](int i) { return (const float*)ptrs[i]; };
  auto fo = [&](int i) { return (float*)ptrs[i]; };
  const float* cinv = f(16);
  const float* rmat = f(17);
  int nc = dims[kDimNc];
  if ((cinv == nullptr) != (rmat == nullptr) || (cinv != nullptr && nc < 1))
    return (int)cudaErrorInvalidValue;
  if (cinv == nullptr && nc != 0) return (int)cudaErrorInvalidValue;
  float* gpart = fo(26);
  if (sh.split && (sh.clusters > 1) != (gpart != nullptr)) return (int)cudaErrorInvalidValue;
  Params P{};
  P.np = dims[kDimNp];
  P.mw = dims[kDimMw];
  P.nlevels = dims[kDimLevels];
  P.nc = nc;
  P.chunk_iters = dims[kDimIters];
  P.maxit = dims[kDimMaxit];
  P.restart = dims[kDimRestart];
  P.cp = sh.cp;
  P.resident = !sh.split && dims[kDimResident] != 0 ? 1 : 0;
  P.nclusters = sh.clusters;
  P.ppb = sh.ppb;
  P.planes = sh.split && dims[kDimPlanes] != 0 ? 1 : 0;
  P.klocal = sh.split ? dims[kDimLocal] : 0;
  P.gpart = gpart;
  P.atol2 = f(0);
  P.it_in = (const int*)ptrs[1];
  P.rz_in = f(2);
  P.stop_in = (const int*)ptrs[3];
  P.rhs = f(4);
  P.x_in = f(5);
  P.r_in = f(6);
  P.p_in = f(7);
  P.rt_in = f(8);
  P.u = f(9);
  P.td = f(10);
  P.tu = f(11);
  P.tl = f(12);
  P.alphas = f(13);
  P.gammas = f(14);
  P.binv = f(15);
  P.cinv = cinv;
  P.rmat = rmat;
  P.x_out = fo(18);
  P.r_out = fo(19);
  P.p_out = fo(20);
  P.rt_out = fo(21);
  P.it_out = (int*)ptrs[22];
  P.rz_out = fo(23);
  P.stop_out = (int*)ptrs[24];
  P.rr_out = fo(25);
  P.timing = (long long*)ptrs[27];
  cudaError_t err = set_attributes((const void*)sh.kernel, sh.cluster, sh.bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = launch_config(sh, (cudaStream_t)stream, attr);
  err = cudaLaunchKernelEx(&cfg, sh.kernel, P);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// `iters` barriers of `kind` (0 cluster, 1 grid, 2 block) on a cooperative
// grid of `clusters` clusters of `cluster` blocks of `threads` threads at
// `smem_bytes` of dynamic shared memory each.  Returns a cudaError_t.
int fused_pcg_barrier_probe(int clusters, int cluster, int threads,
                            long long smem_bytes, int iters, int kind,
                            void* stream) {
  if (clusters < 1 || cluster < 1 || cluster > kMaxCluster || kind < 0 || kind > 2)
    return (int)cudaErrorInvalidValue;
  const void* fn = (const void*)barrier_probe_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed,
                             cluster > 8 ? 1 : 0);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, barrier_probe_kernel, iters, kind);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
