// One matvec with the landmark fill factor V held as a pose-banded slab:
// out = V (V^T x), SE(2) shapes (DP = 3 pose components, DL = 2 landmark
// components).
//
// Replaces scripts/exp_band_kernel.py::band_matvec_kernel (the slab-streamed
// band matvec Pallas prototype, launched by make_fn).  The contract:
//
//   x [3, Np] f32, slab [n_chunks, W, 6, B] f32 (row a*DL + b), out [3, Np];
//   landmark l = c*B + p (chunk c, lane p) has base pose l and window poses
//   l .. l+W-1; x is zero past Np and what lands past Np is dropped;
//     t[b, l]      = sum_{w,a} slab[c, w, a*DL+b, p] * x[a, l+w]
//     out[a, l+w] += sum_b     slab[c, w, a*DL+b, p] * t[b, l].
//
// What bounds it on an H100: reading the slab, 4*6*W bytes per landmark
// (15.7 MB at W=64, 141.6 MB at W=576 and Np=10240) against 24*W flops per
// landmark -- 1 flop per byte, far below the card's 20 f32 flops per byte.
// Tensor cores (wgmma) cannot move a kernel bound by bytes, so there is
// none here.  At W >= 320 the slab is larger than the 50 MB L2.
//
// The design reads each slab element from device memory once per matvec.
// A landmark's t needs its whole window, and its window is also where its
// t lands, so the slab values that give t[:, l] are the ones that spread
// t[:, l] over its poses; they stay on chip, in registers, between the two
// uses:
//   * a tile is TL = 32 consecutive landmarks of one chunk, a warp's lanes
//     (each slab row is read as 128 contiguous bytes; a chunk whose B is
//     not a multiple of 32 ends in a shorter tile);
//   * the tile's window is split over a thread-block cluster of CS blocks
//     (CS <= 8, from the host's plan): block r holds window rows
//     [r*Wb, (r+1)*Wb), warp g of it NW consecutive rows of those, lane i
//     landmark i's 6 values at each row, all loaded before the first use;
//   * each block sums its partial t[2, 32] (warps in order); after a
//     cluster barrier every block adds the CS partials in rank order
//     through distributed shared memory, so each holds the same t bits;
//   * from the same registers each warp forms its terms of w and sums them
//     along the diagonals without touching memory: at step k lane i adds
//     its term at row k, which lands on pose k + i; lane 0's sum is then
//     complete and leaves, and every sum moves one lane down (a shuffle);
//   * the block adds its warps' sums in warp order into its own partial row
//     part[tile, r, 3, Wb + 31] (zero where nothing lands);
//   * a second, small launch sums the partials of each output pose q < Np
//     in a fixed order (for each rank, its tiles ascending; then the ranks
//     in order) and writes it once.  The partials (2.9 MB at W=576, 2 % of
//     the slab's bytes) stay in L2 between the launches.
// The chunk's slice that the Pallas kernel keeps in VMEM (up to 7 MB) does
// not fit on one SM; a tile's cluster holds its share of it (74 KB a block
// at W=576, CS=6, half of an SM's registers at two blocks an SM).  The
// register file and not shared memory holds it: the loads need no staging
// copy, and the diagonal sums run on shuffles instead of shared-memory
// traffic.  Determinism: no atomics, every sum in a fixed order, so a rerun
// gives the same bits.
//
// Built with nvcc for sm_90a.  Plain C interface; launched on the caller's
// stream, allocates nothing.  A launch the card refuses (the cluster does
// not fit) returns its cudaError_t; there is no other path.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr int DP = 3;
constexpr int DL = 2;
constexpr int ROWS = DP * DL;
constexpr int TL = 32;                // landmarks per tile: a warp's lanes
constexpr int MAX_CLUSTER = 8;        // the portable cluster size
constexpr int MAX_NW = 8;             // window rows a warp holds, at most

struct Plan {
  int np, nl, W, B;
  int cs;        // blocks per cluster (one cluster per tile)
  int warps;     // warps per block: 8 or 16
  int wb;        // window rows per block
  int nw;        // window rows per warp: ceil(wb / warps)
  int sp;        // poses per block's span: wb + TL - 1
  int tpc;       // tiles per chunk
  int n_tiles;
};

// The plan of a launch, or false when (W, B, cs, warps) is not one: cs in
// 1..8, every rank of the cluster holding at least one window row, 8 or 16
// warps a block, and at most MAX_NW rows a warp.
bool make_plan(int np, int n_chunks, int W, int B, int cs, int warps,
               Plan* P) {
  if (np < 1 || n_chunks < 0 || W < 1 || B < 1 || cs < 1 ||
      cs > MAX_CLUSTER || (warps != 8 && warps != 16) ||
      (long long)n_chunks * B > np)
    return false;
  const int wb = (W + cs - 1) / cs;
  if ((W + wb - 1) / wb != cs) return false;
  const int nw = (wb + warps - 1) / warps;
  if (nw > MAX_NW) return false;
  P->np = np;
  P->nl = n_chunks * B;
  P->W = W;
  P->B = B;
  P->cs = cs;
  P->warps = warps;
  P->wb = wb;
  P->nw = nw;
  P->sp = wb + TL - 1;
  P->tpc = (B + TL - 1) / TL;
  P->n_tiles = n_chunks * P->tpc;
  return true;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// A 4-byte asynchronous copy that reads `bytes` (4 or 0) and zero-fills
// the rest.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::: "memory");
}

// The two halves of a cluster barrier: a block arrives once it has read
// the other blocks' shared memory and waits before it exits, so that no
// block's shared memory goes away while another still reads it.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// One cluster per tile of TL landmarks; block r of the cluster holds window
// rows [r*wb, r*wb + wr) of them, warp g rows [g*NW, g*NW + n) of those,
// lane i landmark i's 6 values at each row, in registers.  Three blocks an
// SM at 8 warps (85 registers a thread), two at 16 (64), and one at 16 x 8
// rows, whose 48 slab values a thread spill at 64 registers.
template <int WARPS, int NW>
__global__ void __launch_bounds__(TL * WARPS,
                                  WARPS == 8 ? 3 : (NW < MAX_NW ? 2 : 1))
slab_tile(Plan P, const float* __restrict__ x, const float* __restrict__ slab,
          float* __restrict__ part) {
  constexpr int THREADS = TL * WARPS;
  constexpr int OW = NW + TL - 1;           // poses a warp's rows reach
  constexpr int XS = WARPS * NW + TL - 1;   // poses a block's rows reach
  __shared__ float xs[DP][XS];
  __shared__ float red[WARPS][DL][TL];
  __shared__ float tp[DL][TL];
  __shared__ float t[DL][TL];
  __shared__ float ow[WARPS][DP][OW];
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const int tile = blockIdx.x / P.cs;
  const int c = tile / P.tpc, p0 = (tile - c * P.tpc) * TL;
  const int tl = min(TL, P.B - p0);          // landmarks of this tile
  const int tid = threadIdx.x, warp = tid / TL, lane = tid % TL;
  const int w0 = r * P.wb;
  const int wr = min(P.wb, P.W - w0);        // window rows of this block
  const int n = max(0, min(NW, wr - warp * NW));   // rows of this warp
  const int base = c * P.B + p0 + w0;        // the block's first pose
  const bool live = lane < tl;

  // 1. every load issued before the first use: the warp's rows into
  //    registers (a warp reads 128 contiguous bytes of each slab row),
  //    the x values the block's rows meet into shared memory (zero past Np)
  const float* src = slab + ((size_t)c * P.W + w0 + warp * NW) * ROWS * P.B +
                     p0 + lane;
  float v[NW][ROWS];
#pragma unroll
  for (int k = 0; k < NW; ++k)
#pragma unroll
    for (int e = 0; e < ROWS; ++e)
      v[k][e] = live && k < n ? __ldcs(src + (size_t)(k * ROWS + e) * P.B)
                              : 0.f;
  for (int i = tid; i < DP * P.sp; i += THREADS) {
    const int a = i / P.sp, m = i - a * P.sp, q = base + m;
    const bool in = q < P.np;
    cp_async4(&xs[a][m], in ? x + (size_t)a * P.np + q : x, in ? 4 : 0);
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. the block's partial t: each warp over its rows in order, then the
  //    warps' sums in warp order
  float t0 = 0.f, t1 = 0.f;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    if (k < n) {
      const int m = warp * NW + k + lane;
      const float x0 = xs[0][m], x1 = xs[1][m], x2 = xs[2][m];
      t0 += v[k][0] * x0 + v[k][2] * x1 + v[k][4] * x2;
      t1 += v[k][1] * x0 + v[k][3] * x1 + v[k][5] * x2;
    }
  }
  red[warp][0][lane] = t0;
  red[warp][1][lane] = t1;
  __syncthreads();
  if (tid < DL * TL) {
    float s = 0.f;
    for (int g = 0; g < WARPS; ++g) s += red[g][tid / TL][tid % TL];
    tp[tid / TL][tid % TL] = s;
  }

  // 3. the tile's t: the cluster's partials added in rank order
  cluster.sync();
  if (tid < DL * TL) {
    float pt[MAX_CLUSTER];   // every rank's partial asked for at once
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q)
      pt[q] = q < P.cs ? cluster.map_shared_rank(&tp[0][0], q)[tid] : 0.f;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q) s += pt[q];
    t[tid / TL][tid % TL] = s;
  }
  cluster_arrive();
  __syncthreads();

  // 4. the warp's terms of w, summed along the diagonals without a second
  //    read: at step k lane i adds its term at row k, which lands on pose
  //    k + i of the warp's span; lane 0's sum is then complete and leaves,
  //    and every sum moves one lane down
  const float tv0 = t[0][lane], tv1 = t[1][lane];
  float o0 = 0.f, o1 = 0.f, o2 = 0.f;
  float* out_w = &ow[warp][0][0];
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    if (k < n) {
      o0 = fmaf(v[k][1], tv1, fmaf(v[k][0], tv0, o0));
      o1 = fmaf(v[k][3], tv1, fmaf(v[k][2], tv0, o1));
      o2 = fmaf(v[k][5], tv1, fmaf(v[k][4], tv0, o2));
      if (lane == 0) {
        out_w[k] = o0;
        out_w[OW + k] = o1;
        out_w[2 * OW + k] = o2;
      }
      if (k + 1 < n) {
        o0 = __shfl_down_sync(0xffffffffu, o0, 1);
        o1 = __shfl_down_sync(0xffffffffu, o1, 1);
        o2 = __shfl_down_sync(0xffffffffu, o2, 1);
        if (lane == TL - 1) o0 = o1 = o2 = 0.f;
      }
    }
  }
  if (n > 0 && lane > 0) {
    out_w[n - 1 + lane] = o0;
    out_w[OW + n - 1 + lane] = o1;
    out_w[2 * OW + n - 1 + lane] = o2;
  }
  __syncthreads();

  // 5. the block's partial row: thread (a, j) adds the warps' sums at span
  //    pose j in warp order (zero where none lands)
  float* dst = part + ((size_t)tile * P.cs + r) * DP * P.sp;
  for (int u = tid; u < DP * P.sp; u += THREADS) {
    const int a = u / P.sp, j = u - a * P.sp;
    float s = 0.f;
    for (int g = j < OW ? 0 : (j - OW) / NW + 1; g <= min(WARPS - 1, j / NW);
         ++g) {
      const int ng = min(NW, wr - g * NW);
      if (ng > 0 && j - g * NW < ng + TL - 1) s += ow[g][a][j - g * NW];
    }
    dst[u] = s;
  }
  cluster_wait();
}

__device__ __forceinline__ int tile_of(const Plan& P, int l) {
  const int c = l / P.B;
  return c * P.tpc + (l - c * P.B) / TL;
}

// out[:, q] for TL poses q per block: thread (q, r) adds rank r's partials
// of the tiles whose span covers q, tiles ascending (loaded four at a
// time); then the ranks' sums are added in rank order and written once.
__global__ void __launch_bounds__(TL * MAX_CLUSTER)
slab_sum(Plan P, const float* __restrict__ part, float* __restrict__ out) {
  __shared__ float red[MAX_CLUSTER][DP][TL];
  const int lane = threadIdx.x, r = threadIdx.y, sp = P.sp;
  const int q = blockIdx.x * TL + lane;
  const int m = q - r * P.wb;        // q's offset from rank r's first row
  float o[DP] = {0.f, 0.f, 0.f};
  const int lo = max(0, m - sp + 1), hi = min(m, P.nl - 1);
  if (q < P.np && lo <= hi) {
    const int T1 = tile_of(P, hi);
    for (int T = tile_of(P, lo); T <= T1; T += 4) {
      float v[4][DP];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = (T + u) / P.tpc;
        const int j = m - (c * P.B + (T + u - c * P.tpc) * TL);
        // the first tile may start before lo
        const bool in = T + u <= T1 && j < sp;
        const float* s = part + ((size_t)(T + u) * P.cs + r) * DP * sp + j;
#pragma unroll
        for (int a = 0; a < DP; ++a) v[u][a] = in ? s[a * sp] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int a = 0; a < DP; ++a) o[a] += v[u][a];
    }
  }
  for (int a = 0; a < DP; ++a) red[r][a][lane] = o[a];
  __syncthreads();
  if (r == 0 && q < P.np) {
    for (int a = 0; a < DP; ++a) {
      float s = 0.f;
      for (int k = 0; k < P.cs; ++k) s += red[k][a][lane];
      out[(size_t)a * P.np + q] = s;
    }
  }
}

cudaLaunchConfig_t tile_config(const Plan& P, int tiles, cudaStream_t s,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * P.cs);
  cfg.blockDim = dim3(TL * P.warps);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

using TileFn = void (*)(Plan, const float*, const float*, float*);

template <int WARPS>
TileFn tile_kernel_for(int nw) {
  switch (nw) {
    case 1: return slab_tile<WARPS, 1>;
    case 2: return slab_tile<WARPS, 2>;
    case 3: return slab_tile<WARPS, 3>;
    case 4: return slab_tile<WARPS, 4>;
    case 5: return slab_tile<WARPS, 5>;
    case 6: return slab_tile<WARPS, 6>;
    case 7: return slab_tile<WARPS, 7>;
    case 8: return slab_tile<WARPS, 8>;
  }
  return nullptr;
}

// The instantiation of the plan's warps a block and rows a warp.
TileFn tile_kernel(const Plan& P) {
  return P.warps == 8 ? tile_kernel_for<8>(P.nw) : tile_kernel_for<16>(P.nw);
}

// Enqueue the tile launch (none when there is no landmark) and the sum.
cudaError_t enqueue(const Plan& P, const float* x, const float* slab,
                    float* part, float* out, cudaStream_t s,
                    cudaEvent_t between) {
  if (P.n_tiles > 0) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = tile_config(P, P.n_tiles, s, attr);
    const cudaError_t err =
        cudaLaunchKernelEx(&cfg, tile_kernel(P), P, x, slab, part);
    if (err != cudaSuccess) return err;
  }
  if (between != nullptr) cudaEventRecord(between, s);
  slab_sum<<<(P.np + TL - 1) / TL, dim3(TL, P.cs), 0, s>>>(P, part, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The tile kernel of `warps` warps a block and `nw` rows a warp as the card
// compiled it: out[0] its static shared memory a block, out[1] its local
// memory a thread (spilled registers), out[2] its registers a thread.
// Returns a cudaError_t.
int slab_band_matvec_attrs(int warps, int nw, long long* out) {
  if ((warps != 8 && warps != 16) || nw < 1 || nw > MAX_NW)
    return (int)cudaErrorInvalidValue;
  Plan P = {};
  P.warps = warps;
  P.nw = nw;
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, tile_kernel(P));
  if (err != cudaSuccess) return (int)err;
  out[0] = (long long)fa.sharedSizeBytes;
  out[1] = (long long)fa.localSizeBytes;
  out[2] = (long long)fa.numRegs;
  return 0;
}

// out = V (V^T x) for x [3, np], slab [n_chunks, W, 6, B], with clusters of
// `cs` blocks and `part` [n_chunks * ceil(B/32), cs, 3, ceil(W/cs) + 31] as
// scratch; all f32, contiguous, on one device.  Enqueues both launches on
// `stream` and returns the first refused one's cudaError_t (0 when both
// were accepted).
int slab_band_matvec_launch(int np, int n_chunks, int W, int B, int cs,
                            int warps, const float* x, const float* slab,
                            float* part, float* out, void* stream) {
  Plan P;
  if (!make_plan(np, n_chunks, W, B, cs, warps, &P))
    return (int)cudaErrorInvalidValue;
  return (int)enqueue(P, x, slab, part, out, (cudaStream_t)stream, nullptr);
}

// The device ms of each launch, averaged over `reps` matvecs launched back
// to back on `stream`, from CUDA events recorded before, between and after
// the two launches of every matvec: ms[0] the tile launch, ms[1] the sum.
// For measurement only (no path calls it); waits for the stream.  Returns a
// cudaError_t.
int slab_band_matvec_pass_ms(int np, int n_chunks, int W, int B, int cs,
                             int warps, const float* x, const float* slab,
                             float* part, float* out, int reps, float* ms,
                             void* stream) {
  Plan P;
  if (!make_plan(np, n_chunks, W, B, cs, warps, &P) || reps < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaEvent_t* ev = new cudaEvent_t[3 * reps];
  int made = 0;
  cudaError_t err = cudaSuccess;
  for (; made < 3 * reps && err == cudaSuccess; ++made)
    err = cudaEventCreate(&ev[made]);
  if (err != cudaSuccess) --made;   // the failed one was not created
  for (int r = 0; r < reps && err == cudaSuccess; ++r) {
    cudaEventRecord(ev[3 * r], s);
    err = enqueue(P, x, slab, part, out, s, ev[3 * r + 1]);
    cudaEventRecord(ev[3 * r + 2], s);
  }
  if (err == cudaSuccess) err = cudaEventSynchronize(ev[3 * reps - 1]);
  float sum[2] = {0.f, 0.f};
  for (int r = 0; r < reps && err == cudaSuccess; ++r) {
    for (int k = 0; k < 2 && err == cudaSuccess; ++k) {
      float e = 0.f;
      err = cudaEventElapsedTime(&e, ev[3 * r + k], ev[3 * r + k + 1]);
      sum[k] += e;
    }
  }
  for (int i = 0; i < made; ++i) cudaEventDestroy(ev[i]);
  delete[] ev;
  ms[0] = sum[0] / reps;
  ms[1] = sum[1] / reps;
  return (int)err;
}

}  // extern "C"
