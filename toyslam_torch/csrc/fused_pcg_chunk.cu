// One chunk of preconditioned conjugate gradients on the damped reduced pose
// system S = T - V V^T, on one thread-block cluster.
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
// Design: one launch is one cluster of C thread blocks (C = 16, the
// non-portable maximum, chosen over the portable 8 because at C = 16 the
// 150-pose U slice fits in shared memory beside the vectors: 0.22 against
// 0.39 ms per chunk, both timed by chip_smoke.py).  Block b owns the
// columns [b*cp, (b+1)*cp) of U, cp = ceil(Mw / C):
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
//     thread, which loads its PCR planes four levels ahead (one at DP = 6).
// A launch the card refuses (the cluster does not fit) returns its error;
// there is no smaller cluster and no one-block fallback.
//
// Instantiated for DP = 3 (SE(2) poses) and DP = 6 (SE(3) bundle
// adjustment); the C entry points dispatch on dp.  At DP = 6 the BA graphs
// have Np = 64 (384 elements, one per thread, U slice in shared memory) or
// Np = 128 (768 elements: every per-element loop strides by the block, and
// the 295 KB U slice is read from L2).
//
// Determinism: no atomics; every sum has a fixed order (block_sum2, the
// partials in block order).  Runs repeat bit for bit at one cluster size.
//
// Built with nvcc for sm_90a, WITHOUT --use_fast_math: the breakdown test
// needs isfinite() to see NaN/inf, and alpha/beta need IEEE division.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 576;   // one [3, 192] element per thread at 150 poses
constexpr int kWarps = kThreads / 32;
constexpr int kRedFloats = 2 * kWarps + 2;
constexpr int kMaxCluster = 16;
constexpr int kHeldLevels = 16;  // PCR levels of the unrolled, ring-loaded path
// Levels between loading a level's planes and using them.  The ring holds
// 2 (kAhead + 1) DP coefficients per thread, within the 96 registers ptxas
// gives a thread of a 576-thread block: 30 floats at DP=3 (depth 4; the
// depth changed nothing measurable there); at DP=6 depths 3, 2 and 1 spill
// 188, 108 and 4 bytes (ptxas, sm_90a), so DP=6 takes depth 1.
template <int DP>
__host__ __device__ constexpr int ahead_levels() { return DP == 3 ? 4 : 1; }

struct Params {
  int np, mw, nlevels, nc, chunk_iters, maxit, restart;
  int cp, resident;      // U columns per block; U slice in shared memory
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

// V^T v columns, the partial V urow, the cluster exchange, the
// preconditioner, the rest
constexpr int kTimers = 5;
enum { kTVtx = 0, kTVurow = 1, kTExchange = 2, kTPrecond = 3, kTOther = 4 };

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
  S.scratch = o; o += 4 * kThreads;
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
  S.red = o; o += kRedFloats;
  S.total = o * sizeof(float);
  return S;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of a and b over the block, returned to every thread.  Fixed order for
// a fixed block size, so repeated runs (and every block) agree bit for bit.
__device__ float2 block_sum2(float a, float b, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    red[warp] = a;
    red[kWarps + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    float ta = lane < kWarps ? red[lane] : 0.f;
    float tb = lane < kWarps ? red[kWarps + lane] : 0.f;
    ta = warp_sum(ta);
    tb = warp_sum(tb);
    if (lane == 0) {
      red[2 * kWarps] = ta;
      red[2 * kWarps + 1] = tb;
    }
  }
  __syncthreads();
  const float2 out = make_float2(red[2 * kWarps], red[2 * kWarps + 1]);
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

struct Block {
  float* ypart;     // this block's partial V urow (= ta)
  float* urow;      // [round4(cp)], zero past the block's columns
  float4* scratch;  // [kThreads]
  const float* us;  // resident U slice [DP*Np, cp] or null
  int rank, csize, j0, ncol;   // this block's columns [j0, j0 + ncol)
};

// out = S in = T in - V (V^T in), over the cluster.  `in` is complete in
// every block (barrier before); on return `out` is complete in every block.
template <int DP>
__device__ void matvec(const Params& P, cg::cluster_group& cluster,
                       const Block& B, const float* __restrict__ in,
                       float* __restrict__ out, Timer& tm) {
  const int n = P.np, N = DP * n, mw = P.mw, ncol = B.ncol;
  const int us_stride = slice_stride(P.cp);
  const int tid = threadIdx.x;
  tm.lap(kTOther);
  auto uval = [&](int e, int j) {
    return P.resident ? B.us[(size_t)e * us_stride + j]
                      : __ldg(P.u + (size_t)e * mw + B.j0 + j);
  };
  const int cq = (ncol + 3) / 4;   // the block's float4 column quads
  // float4 rows: the resident slice (zero-padded), or U itself where the
  // block's columns are whole, aligned quads
  const bool quads = P.resident || (mw % 4 == 0 && B.j0 % 4 == 0 && ncol % 4 == 0);
  if (quads && cq <= kThreads / 8) {
    // urow = U_b^T in: thread (quad q4, row group g of G) sums rows g,
    // g + G, ...; then 8 groups of the G, then the 8, each in a fixed order
    const int sq = P.resident ? us_stride / 4 : mw / 4, G = kThreads / cq;
    const int q4 = tid % cq, g = tid / cq;
    const float4* us4 = P.resident
        ? reinterpret_cast<const float4*>(B.us)
        : reinterpret_cast<const float4*>(P.u + B.j0);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g < G) {
      if (P.resident) {
        for (int e = g; e < N; e += G) acc = f4fma(in[e], us4[(size_t)e * sq + q4], acc);
      } else {
        for (int e = g; e < N; e += G) acc = f4fma(in[e], __ldg(us4 + (size_t)e * sq + q4), acc);
      }
    }
    B.scratch[tid] = acc;
    __syncthreads();
    float4 s8 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (tid < 8 * cq) {
      for (int h = tid / cq; h < G; h += 8) s8 = f4add(s8, B.scratch[h * cq + q4]);
    }
    __syncthreads();
    if (tid < 8 * cq) B.scratch[tid] = s8;
    __syncthreads();
    if (tid < cq) {
      float4 u4 = B.scratch[tid];
      for (int h = 1; h < 8; ++h) u4 = f4add(u4, B.scratch[h * cq + tid]);
      const int j = 4 * tid;   // zero past the block's columns
      B.urow[j] = j < ncol ? u4.x : 0.f;
      B.urow[j + 1] = j + 1 < ncol ? u4.y : 0.f;
      B.urow[j + 2] = j + 2 < ncol ? u4.z : 0.f;
      B.urow[j + 3] = j + 3 < ncol ? u4.w : 0.f;
    }
    __syncthreads();
    tm.lap(kTVtx);
    // the block's partial V urow: one thread per row, float4s of its row
    const float4* ur4 = reinterpret_cast<const float4*>(B.urow);
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
      B.ypart[e] = a0 + a1;
    }
    tm.lap(kTVurow);
  } else {
  // columns not in whole quads, or too many for the float4 path:
  // urow = U_b^T in: thread (column j, row group g of G), groups combined in
  // a fixed order
  float* scratch = reinterpret_cast<float*>(B.scratch);
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
      B.urow[j] = s;
    }
    __syncthreads();
  }
  tm.lap(kTVtx);
  // the block's partial V urow: one warp per row, lanes along its columns
  const int warp = tid >> 5, lane = tid & 31;
  for (int e = warp; e < N; e += kWarps) {
    float acc = 0.f;
    for (int j = lane; j < ncol; j += 32) acc = fmaf(uval(e, j), B.urow[j], acc);
    acc = warp_sum(acc);
    if (lane == 0) B.ypart[e] = acc;
  }
  tm.lap(kTVurow);
  }
  cluster.sync();
  // this block's share of the elements: the partials summed in block order
  // over distributed shared memory, T applied, the result sent to every block
  const int eb = (N + B.csize - 1) / B.csize;
  const int e1 = min(N, (B.rank + 1) * eb);
  for (int e = B.rank * eb + tid; e < e1; e += kThreads) {
    float s = 0.f;
    for (int b = 0; b < B.csize; ++b) s += cluster.map_shared_rank(B.ypart, b)[e];
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
  tm.lap(kTExchange);
}

// z = M^-1 r, replicated in every block.  r must be complete (barrier
// before the call); ta/tb are the PCR ping-pong buffers, rc/za the coarse
// scratch.  Ends with a barrier.
template <int DP>
__device__ void precond(const Params& P, const float* __restrict__ r,
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
  float cb[DP];   // binv of this thread's element, loaded up front
  if (one && e1 < N) {
    const int a = e1 / n, p = e1 - a * n;
#pragma unroll
    for (int b = 0; b < DP; ++b) cb[b] = __ldg(P.binv + (size_t)(a * DP + b) * n + p);
  }
  if (one && L <= kHeldLevels) {
    // one element per thread: its planes are loaded kAhead levels ahead
    // into a ring, so their latency hides behind that many levels
    constexpr int kAhead = ahead_levels<DP>();
    float ca[kAhead + 1][DP], cg[kAhead + 1][DP];
#pragma unroll
    for (int l = 0; l < kAhead; ++l)
      if (l < L && e1 < N) load_level(l, e1, ca[l], cg[l]);
    int sm = 1 % n;   // the shift 2^l mod Np
#pragma unroll
    for (int l = 0; l < kHeldLevels; ++l) {
      if (l < L) {
        if (l + kAhead < L && e1 < N)
          load_level(l + kAhead, e1, ca[(l + kAhead) % (kAhead + 1)],
                     cg[(l + kAhead) % (kAhead + 1)]);
        float* o = (l & 1) ? tb : ta;
        if (e1 < N) level(t, o, e1, sm, ca[l % (kAhead + 1)], cg[l % (kAhead + 1)]);
        __syncthreads();
        t = o;
        sm += sm;
        if (sm >= n) sm -= n;
      }
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
__global__ void __launch_bounds__(kThreads, 1) fused_pcg_chunk_kernel(Params P) {
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
  tm.on = P.timing != nullptr && cluster.block_rank() == 0 && threadIdx.x == 0;
  tm.t = tm.on ? clock64() : 0;
#pragma unroll
  for (int k = 0; k < kTimers; ++k) tm.acc[k] = 0;
  Block B;
  B.ypart = ta;
  B.urow = smem + L.urow;
  B.scratch = reinterpret_cast<float4*>(smem + L.scratch);
  B.rank = (int)cluster.block_rank();
  B.csize = (int)cluster.num_blocks();
  B.j0 = min(P.mw, B.rank * P.cp);
  B.ncol = min(P.mw - B.j0, P.cp);
  B.us = P.resident ? smem + L.us : nullptr;
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
  tm.lap(kTOther);
  precond<DP>(P, r, z, ta, tb, rc, za);
  tm.lap(kTPrecond);
  float sz = 0.f, sr = 0.f;
  for (int e = threadIdx.x; e < N; e += blockDim.x) {
    sz = fmaf(r[e], z[e], sz);
    sr = fmaf(r[e], r[e], sr);
    p[e] = restart ? z[e] : P.p_in[e];
  }
  float2 s2 = block_sum2(sz, sr, red);
  float rz = restart ? s2.x : *P.rz_in;
  float rr = s2.y;
  bool stop = *P.stop_in > 0;
  int it = *P.it_in;
  const float atol2 = *P.atol2;

  for (int k = 0; k < P.chunk_iters; ++k) {
    matvec<DP>(P, cluster, B, p, ap, tm);
    float part = 0.f;
    for (int e = threadIdx.x; e < N; e += blockDim.x) part = fmaf(p[e], ap[e], part);
    const float pap = block_sum2(part, 0.f, red).x;
    const bool breakdown = !(pap > 0.f) || !isfinite(pap);
    stop = stop || breakdown;
    const bool done = stop || (rr <= atol2) || (it >= P.maxit);
    const float alpha = done ? 0.f : rz / pap;
    for (int e = threadIdx.x; e < N; e += blockDim.x) {
      x[e] = x[e] + alpha * p[e];
      r[e] = r[e] - alpha * ap[e];
    }
    __syncthreads();
    tm.lap(kTOther);
    precond<DP>(P, r, z, ta, tb, rc, za);
    tm.lap(kTPrecond);
    sz = 0.f;
    sr = 0.f;
    for (int e = threadIdx.x; e < N; e += blockDim.x) {
      sz = fmaf(r[e], z[e], sz);
      sr = fmaf(r[e], r[e], sr);
    }
    s2 = block_sum2(sz, sr, red);
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
  tm.lap(kTOther);
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
  const float rr_true = block_sum2(sr, 0.f, red).x;
  if (B.rank == 0 && threadIdx.x == 0) {
    *P.it_out = it;
    *P.rz_out = rz;
    *P.stop_out = stop ? 1 : 0;
    *P.rr_out = rr_true;
  }
  if (tm.on) {
    tm.lap(kTOther);
    for (int k = 0; k < kTimers; ++k) P.timing[k] = tm.acc[k];
  }
}

int cols_per_block(int mw, int cluster) { return (mw + cluster - 1) / cluster; }

cudaLaunchConfig_t launch_config(int cluster, size_t bytes, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

using KernelFn = void (*)(Params);

// The instantiation for a pose block size (null for one that is not built).
KernelFn kernel_for(int dp) {
  if (dp == 3) return fused_pcg_chunk_kernel<3>;
  if (dp == 6) return fused_pcg_chunk_kernel<6>;
  return nullptr;
}

// Attributes are per instantiation: set on the one that will be queried or
// launched.
cudaError_t set_attributes(KernelFn kernel, int cluster, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                              cluster > 8 ? 1 : 0);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes.
long long fused_pcg_chunk_smem_bytes(int dp, int np, int mw, int nc, int cluster,
                                     int resident) {
  if (cluster < 1) return -1;
  return (long long)smem_layout(dp, np, cols_per_block(mw, cluster), nc, resident).total;
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

// How many clusters of `cluster` blocks of the dp instantiation at this
// layout can be resident at once (0: the card refuses the cluster).  Returns
// a cudaError_t.
int fused_pcg_chunk_max_clusters(int dp, int np, int mw, int nc, int cluster,
                                 int resident, int* count) {
  *count = 0;
  const KernelFn kernel = kernel_for(dp);
  if (kernel == nullptr || cluster < 1 || cluster > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  const size_t bytes =
      smem_layout(dp, np, cols_per_block(mw, cluster), nc, resident).total;
  cudaError_t err = set_attributes(kernel, cluster, bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(cluster, bytes, 0, attr);
  return (int)cudaOccupancyMaxActiveClusters(count, kernel, &cfg);
}

// Launch one chunk of the dp instantiation (3 or 6) on `stream` as one
// cluster of `cluster` blocks; with
// `timing`, block 0's clock64 cycles per phase kind land there.  Returns a
// cudaError_t (0 = launched).
int fused_pcg_chunk_launch(
    int dp, int np, int mw, int nlevels, int nc, int chunk_iters, int maxit,
    int restart, int cluster, int resident, const float* atol2,
    const int* it_in, const float* rz_in, const int* stop_in, const float* rhs,
    const float* x_in, const float* r_in, const float* p_in, const float* rt_in,
    const float* u, const float* td, const float* tu, const float* tl,
    const float* alphas, const float* gammas, const float* binv,
    const float* cinv, const float* rmat, float* x_out, float* r_out,
    float* p_out, float* rt_out, int* it_out, float* rz_out, int* stop_out,
    float* rr_out, long long* timing, void* stream) {
  const KernelFn kernel = kernel_for(dp);
  if (kernel == nullptr || np < 1 || mw < 1 || nlevels < 0 || chunk_iters < 0 ||
      cluster < 1 || cluster > kMaxCluster ||
      (cinv == nullptr) != (rmat == nullptr) || (cinv != nullptr && nc < 1))
    return (int)cudaErrorInvalidValue;
  if (cinv == nullptr) nc = 0;
  const int cp = cols_per_block(mw, cluster);
  Params P{np,     mw,     nlevels, nc,     chunk_iters, maxit,  restart,
           cp,     resident != 0 ? 1 : 0,  atol2,       it_in,  rz_in,
           stop_in, rhs,   x_in,    r_in,   p_in,        rt_in,  u,
           td,     tu,     tl,      alphas, gammas,      binv,   cinv,
           rmat,   x_out,  r_out,   p_out,  rt_out,      it_out, rz_out,
           stop_out, rr_out, timing};
  const size_t bytes = smem_layout(dp, np, cp, nc, P.resident).total;
  cudaError_t err = set_attributes(kernel, cluster, bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(cluster, bytes, (cudaStream_t)stream, attr);
  err = cudaLaunchKernelEx(&cfg, kernel, P);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
