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
//     t-pass  t[b, l]      = sum_{w,a} slab[c, w, a*DL+b, p] * x[a, l+w]
//     w-pass  out[a, l+w] += sum_b     slab[c, w, a*DL+b, p] * t[b, l].
//
// What bounds it on an H100: reading the slab, 4*6*W bytes per landmark
// (15.7 MB at W=64, 141.6 MB at W=576 and Np=10240) against 24*W flops per
// landmark -- 1 flop per byte, far below the card's 20 flops per byte in
// f32.  At W >= 320 the slab is larger than the 50 MB L2.
//
// The design, two launches on one stream with t [2, n_chunks*B] between
// them (the t -> w dependency is grid-wide: every output pose needs the t
// of W landmarks):
//   1. t-pass: a block takes 32 consecutive landmarks (one warp's lanes,
//      so each slab row is read as 128 contiguous bytes) and splits the
//      window w over SPLIT warps; the warps' partial sums meet in shared
//      memory and are added in warp order.
//   2. w-pass, a gather: a block takes 32 consecutive output poses q and
//      splits w over SPLIT warps; lane q at window w reads landmark q - w,
//      slab[(q-w)/B, w, :, (q-w)%B], contiguous across the warp except at
//      a chunk boundary.  Each output is written once, by one thread.
// So the slab is read twice per matvec (the Pallas kernel keeps a chunk's
// slice in VMEM for both passes; here a chunk's slice, up to 7 MB, would
// not fit in shared memory).  Determinism: no atomics, every sum in a
// fixed order, so a rerun gives the same bits.
//
// Built with nvcc for sm_90a.  Plain C interface; launched on the caller's
// stream, allocates nothing.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int DP = 3;
constexpr int DL = 2;
constexpr int ROWS = DP * DL;
constexpr int LANES = 32;   // landmarks (t-pass) or poses (w-pass) per block
constexpr int SPLIT = 16;   // warps per block, each a share of the window

__global__ void __launch_bounds__(LANES * SPLIT)
slab_tpass(int np, int nl, int W, int B, const float* __restrict__ x,
           const float* __restrict__ slab, float* __restrict__ t) {
  __shared__ float part[SPLIT][DL][LANES];
  const int lane = threadIdx.x, wy = threadIdx.y;
  const int l = blockIdx.x * LANES + lane;
  float acc0 = 0.f, acc1 = 0.f;
  if (l < nl) {
    const int c = l / B, p = l - c * B;
    const size_t row = (size_t)B;
    const float* s = slab + (size_t)c * W * ROWS * row + p;
#pragma unroll 4
    for (int w = wy; w < W; w += SPLIT) {
      const float* sw = s + (size_t)w * ROWS * row;
      const int q = l + w;
      float x0 = 0.f, x1 = 0.f, x2 = 0.f;
      if (q < np) {
        x0 = x[q];
        x1 = x[np + q];
        x2 = x[2 * np + q];
      }
      acc0 += sw[0] * x0 + sw[2 * row] * x1 + sw[4 * row] * x2;
      acc1 += sw[row] * x0 + sw[3 * row] * x1 + sw[5 * row] * x2;
    }
  }
  part[wy][0][lane] = acc0;
  part[wy][1][lane] = acc1;
  __syncthreads();
  if (wy < DL && l < nl) {
    float sum = 0.f;
    for (int k = 0; k < SPLIT; ++k) sum += part[k][wy][lane];
    t[(size_t)wy * nl + l] = sum;
  }
}

__global__ void __launch_bounds__(LANES * SPLIT)
slab_wpass(int np, int nl, int W, int B, const float* __restrict__ slab,
           const float* __restrict__ t, float* __restrict__ out) {
  __shared__ float part[SPLIT][DP][LANES];
  const int lane = threadIdx.x, wy = threadIdx.y;
  const int q = blockIdx.x * LANES + lane;
  float o0 = 0.f, o1 = 0.f, o2 = 0.f;
  if (q < np) {
    const size_t row = (size_t)B;
#pragma unroll 4
    for (int w = wy; w < W; w += SPLIT) {
      const int l = q - w;   // the landmark whose window puts it at q
      if (l < 0) break;      // and it only decreases with w
      if (l >= nl) continue;
      const int c = l / B, p = l - c * B;
      const float* sw = slab + ((size_t)c * W + w) * ROWS * row + p;
      const float t0 = t[l], t1 = t[nl + l];
      o0 += sw[0] * t0 + sw[row] * t1;
      o1 += sw[2 * row] * t0 + sw[3 * row] * t1;
      o2 += sw[4 * row] * t0 + sw[5 * row] * t1;
    }
  }
  part[wy][0][lane] = o0;
  part[wy][1][lane] = o1;
  part[wy][2][lane] = o2;
  __syncthreads();
  if (wy < DP && q < np) {
    float sum = 0.f;
    for (int k = 0; k < SPLIT; ++k) sum += part[k][wy][lane];
    out[(size_t)wy * np + q] = sum;
  }
}

}  // namespace

extern "C" {

// out = V (V^T x) for x [3, np], slab [n_chunks, W, 6, B], with t
// [2, n_chunks*B] as scratch; all f32, contiguous, on one device.  Enqueues
// both passes on `stream` and returns the first launch's cudaError_t (0 when
// both were accepted).
int slab_band_matvec_launch(int np, int n_chunks, int W, int B,
                            const float* x, const float* slab, float* t,
                            float* out, void* stream) {
  if (np < 1 || n_chunks < 0 || W < 1 || B < 1 || n_chunks * B > np)
    return (int)cudaErrorInvalidValue;
  const int nl = n_chunks * B;
  const dim3 block(LANES, SPLIT);
  cudaStream_t s = (cudaStream_t)stream;
  if (nl > 0) {
    slab_tpass<<<(nl + LANES - 1) / LANES, block, 0, s>>>(np, nl, W, B, x,
                                                         slab, t);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  slab_wpass<<<(np + LANES - 1) / LANES, block, 0, s>>>(np, nl, W, B, slab,
                                                       t, out);
  return (int)cudaGetLastError();
}

// The device ms of each pass, averaged over `reps` matvecs launched back to
// back on `stream`, from CUDA events recorded before, between and after the
// two passes of every matvec: ms[0] the t-pass, ms[1] the w-pass.  For
// measurement only (no path calls it); waits for the stream.  Returns a
// cudaError_t.
int slab_band_matvec_pass_ms(int np, int n_chunks, int W, int B,
                             const float* x, const float* slab, float* t,
                             float* out, int reps, float* ms, void* stream) {
  if (np < 1 || n_chunks < 1 || W < 1 || B < 1 || n_chunks * B > np ||
      reps < 1)
    return (int)cudaErrorInvalidValue;
  const int nl = n_chunks * B;
  const dim3 block(LANES, SPLIT);
  cudaStream_t s = (cudaStream_t)stream;
  cudaEvent_t* ev = new cudaEvent_t[3 * reps];
  int made = 0;
  cudaError_t err = cudaSuccess;
  for (; made < 3 * reps && err == cudaSuccess; ++made)
    err = cudaEventCreate(&ev[made]);
  if (err != cudaSuccess) --made;   // the failed one was not created
  for (int r = 0; r < reps && err == cudaSuccess; ++r) {
    cudaEventRecord(ev[3 * r], s);
    slab_tpass<<<(nl + LANES - 1) / LANES, block, 0, s>>>(np, nl, W, B, x,
                                                         slab, t);
    cudaEventRecord(ev[3 * r + 1], s);
    slab_wpass<<<(np + LANES - 1) / LANES, block, 0, s>>>(np, nl, W, B,
                                                         slab, t, out);
    cudaEventRecord(ev[3 * r + 2], s);
    err = cudaGetLastError();
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
