// PCR (parallel cyclic reduction) factorization of the block-tridiagonal
// preconditioner M = tridiag(upper[v-1]^T, diag[v], upper[v]), every level
// in one launch.
//
// Replaces no TPU kernel: the JAX package builds the factors with jnp code
// that XLA fuses (toyslam_tpu/ops/schur.py::build_tridiag_planes).  The
// port's plain PyTorch version (toyslam_torch/ops/schur.py::
// build_tridiag_planes_ref) issues ~66 small launches a level at dp=3, ~570
// a build at 150 poses, each some us of host time for ns of device work;
// this kernel is that build in one launch.
//
// The contract (D = dp, 3 or 6; n poses; L = max(1, ceil(log2 n)) levels,
// from the host):
//   diag, upper [n, D, D] f32, block layout (upper[v] the (v, v+1) block;
//   what the callers hold, read without a copy);
//   alphas, gammas [L, D, D, n], binv [D, D, n] f32, component planes (what
//   kernels B1 and B2 read).
// Level l (s = 2^l), for every pose v at once, with a_v, b_v, c_v the blocks
// of v's row (a_v = upper[v-1]^T, b_v = diag[v], c_v = upper[v] before level
// 0) and every block past either end zero:
//   alpha_v = -a_v inv(b_{v-s}),  gamma_v = -c_v inv(b_{v+s}),
//   b_v <- b_v + alpha_v c_{v-s} + gamma_v a_{v+s},
//   a_v <- alpha_v a_{v-s},       c_v <- gamma_v c_{v+s};
// binv = inv(b) after the last level.  The inverse: the adjugate closed form
// at D=3 (schur._adjugate3), Gauss-Jordan with partial pivoting at D=6
// (where the plain version calls torch.linalg.inv).  Block products sum
// over the inner index in order, as the plain version's _pl_mm.
//
// What bounds it on an H100: none of the card's rates.  At n=192, D=3 it
// moves 0.13 MB and does 0.6 MFLOP (0.04 us at 3.35 TB/s); at n=10k 11 MB
// (3.3 us).  What sets its time is the recurrence: 2L barriers, and between
// two of them one pose's chain of dependent loads and 3x3 products.  The
// design keeps both short:
//   * one cooperative grid of at most a pose a thread and no more blocks
//     than the card holds at once (one block up to 256 poses at D=3, 128 at
//     D=6), a grid-stride loop where the grid has fewer threads;
//   * the state a, c (double-buffered), b and inv(b) lies in a global
//     workspace the wrapper allocates (2.2 MB at n=10k, D=3: it stays in
//     the 50 MB L2), in component planes, X[e * n + v], so a warp's loads of
//     one entry at v or v +- s are consecutive floats;
//   * a level is two phases, a grid barrier after each: (1) alpha and gamma
//     out, the new a and c into the other buffer, b in place (no other pose
//     reads it); (2) inv(b) in place; nothing is read while it is rewritten.
// No atomics, every sum in a fixed order: a rerun gives the same bits.
//
// Built with nvcc for sm_90a.  Plain C interface; launched on the caller's
// stream, allocates nothing.  A launch the card refuses returns its
// cudaError_t; there is no other path.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

// threads a block
__host__ __device__ constexpr int block_threads(int d) { return d == 3 ? 256 : 128; }
// blocks of state a pose: a and c twice, b, inv(b)
constexpr int state_blocks = 6;

template <int D>
__device__ __forceinline__ void load(const float* p, int n, int v, float (&m)[D * D]) {
#pragma unroll
  for (int e = 0; e < D * D; ++e) m[e] = p[e * n + v];
}

template <int D>
__device__ __forceinline__ void store(float* p, int n, int v, const float (&m)[D * D]) {
#pragma unroll
  for (int e = 0; e < D * D; ++e) p[e * n + v] = m[e];
}

template <int D>
__device__ __forceinline__ void store_zero(float* p, int n, int v) {
#pragma unroll
  for (int e = 0; e < D * D; ++e) p[e * n + v] = 0.f;
}

// out = x y
template <int D>
__device__ __forceinline__ void mm(const float (&x)[D * D], const float (&y)[D * D],
                                   float (&out)[D * D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float acc = x[i * D] * y[j];
#pragma unroll
      for (int k = 1; k < D; ++k) acc += x[i * D + k] * y[k * D + j];
      out[i * D + j] = acc;
    }
  }
}

// out = inv(m): the adjugate over the determinant (schur._adjugate3)
__device__ __forceinline__ void inverse(const float (&m)[9], float (&out)[9]) {
  const float c00 = m[4] * m[8] - m[5] * m[7];
  const float c01 = m[5] * m[6] - m[3] * m[8];
  const float c02 = m[3] * m[7] - m[4] * m[6];
  const float c10 = m[2] * m[7] - m[1] * m[8];
  const float c11 = m[0] * m[8] - m[2] * m[6];
  const float c12 = m[1] * m[6] - m[0] * m[7];
  const float c20 = m[1] * m[5] - m[2] * m[4];
  const float c21 = m[2] * m[3] - m[0] * m[5];
  const float c22 = m[0] * m[4] - m[1] * m[3];
  const float inv_det = 1.0f / (m[0] * c00 + m[1] * c01 + m[2] * c02);
  out[0] = c00 * inv_det;
  out[1] = c10 * inv_det;
  out[2] = c20 * inv_det;
  out[3] = c01 * inv_det;
  out[4] = c11 * inv_det;
  out[5] = c21 * inv_det;
  out[6] = c02 * inv_det;
  out[7] = c12 * inv_det;
  out[8] = c22 * inv_det;
}

// out = inv(m): Gauss-Jordan with partial pivoting, every index a constant
// so both matrices stay in registers (a row swap is a select per entry)
__device__ __forceinline__ void inverse(const float (&m_in)[36], float (&out)[36]) {
  constexpr int D = 6;
  float m[D * D];
#pragma unroll
  for (int e = 0; e < D * D; ++e) {
    m[e] = m_in[e];
    out[e] = (e / D == e % D) ? 1.f : 0.f;
  }
#pragma unroll
  for (int k = 0; k < D; ++k) {
    int p = k;
    float best = fabsf(m[k * D + k]);
#pragma unroll
    for (int i = k + 1; i < D; ++i) {
      const float a = fabsf(m[i * D + k]);
      if (a > best) {
        best = a;
        p = i;
      }
    }
#pragma unroll
    for (int i = k + 1; i < D; ++i) {
      const bool swap = p == i;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const float mk = m[k * D + j], mi = m[i * D + j];
        m[k * D + j] = swap ? mi : mk;
        m[i * D + j] = swap ? mk : mi;
        const float rk = out[k * D + j], ri = out[i * D + j];
        out[k * D + j] = swap ? ri : rk;
        out[i * D + j] = swap ? rk : ri;
      }
    }
    const float piv = 1.0f / m[k * D + k];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      m[k * D + j] *= piv;
      out[k * D + j] *= piv;
    }
#pragma unroll
    for (int i = 0; i < D; ++i) {
      if (i == k) continue;
      const float f = m[i * D + k];
#pragma unroll
      for (int j = 0; j < D; ++j) {
        m[i * D + j] -= f * m[k * D + j];
        out[i * D + j] -= f * out[k * D + j];
      }
    }
  }
}

// The whole factorization; `work` is the state (6 D^2 n floats).  Not
// restrict: the state is written and read across the barriers.
template <int D>
__global__ void __launch_bounds__(block_threads(D))
    pcr_factor_kernel(const float* __restrict__ diag, const float* __restrict__ upper,
                      int n, int levels, float* alphas, float* gammas, float* binv,
                      float* work) {
  constexpr int DD = D * D;
  cg::grid_group grid = cg::this_grid();
  const size_t plane = (size_t)DD * n;
  float* const a0 = work;
  float* const a1 = work + plane;
  float* const c0 = work + 2 * plane;
  float* const c1 = work + 3 * plane;
  float* const b = work + 4 * plane;
  float* const bi = work + 5 * plane;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int step = gridDim.x * blockDim.x;

  for (int v = first; v < n; v += step) {
    float m[DD], r[DD];
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j)
        m[i * D + j] = v > 0 ? upper[(size_t)(v - 1) * DD + j * D + i] : 0.f;
    }
    store<D>(a0, n, v, m);
#pragma unroll
    for (int e = 0; e < DD; ++e) m[e] = upper[(size_t)v * DD + e];
    store<D>(c0, n, v, m);
#pragma unroll
    for (int e = 0; e < DD; ++e) m[e] = diag[(size_t)v * DD + e];
    store<D>(b, n, v, m);
    inverse(m, r);
    store<D>(bi, n, v, r);
  }
  grid.sync();

  int s = 1;
  for (int l = 0; l < levels; ++l, s *= 2) {
    const bool odd = l & 1;
    const float* const ac = odd ? a1 : a0;
    const float* const cc = odd ? c1 : c0;
    float* const an = odd ? a0 : a1;
    float* const cn = odd ? c0 : c1;
    float* const al = alphas + (size_t)l * plane;
    float* const ga = gammas + (size_t)l * plane;
    for (int v = first; v < n; v += step) {
      float bn[DD], f[DD], t[DD], p[DD];
      load<D>(b, n, v, bn);
      if (v - s >= 0) {
        const int lo = v - s;
        load<D>(ac, n, v, t);
        load<D>(bi, n, lo, p);
        mm<D>(t, p, f);
#pragma unroll
        for (int e = 0; e < DD; ++e) f[e] = -f[e];   // alpha
        store<D>(al, n, v, f);
        load<D>(cc, n, lo, t);
        mm<D>(f, t, p);
#pragma unroll
        for (int e = 0; e < DD; ++e) bn[e] += p[e];
        load<D>(ac, n, lo, t);
        mm<D>(f, t, p);
        store<D>(an, n, v, p);
      } else {
        store_zero<D>(al, n, v);
        store_zero<D>(an, n, v);
      }
      if (v + s < n) {
        const int hi = v + s;
        load<D>(cc, n, v, t);
        load<D>(bi, n, hi, p);
        mm<D>(t, p, f);
#pragma unroll
        for (int e = 0; e < DD; ++e) f[e] = -f[e];   // gamma
        store<D>(ga, n, v, f);
        load<D>(ac, n, hi, t);
        mm<D>(f, t, p);
#pragma unroll
        for (int e = 0; e < DD; ++e) bn[e] += p[e];
        load<D>(cc, n, hi, t);
        mm<D>(f, t, p);
        store<D>(cn, n, v, p);
      } else {
        store_zero<D>(ga, n, v);
        store_zero<D>(cn, n, v);
      }
      store<D>(b, n, v, bn);
    }
    grid.sync();
    float* const dst = l + 1 < levels ? bi : binv;
    for (int v = first; v < n; v += step) {
      float m[DD], r[DD];
      load<D>(b, n, v, m);
      inverse(m, r);
      store<D>(dst, n, v, r);
    }
    if (l + 1 < levels) grid.sync();
  }
}

using KernelFn = void (*)(const float*, const float*, int, int, float*, float*, float*,
                          float*);

KernelFn kernel_for(int dp) {
  if (dp == 3) return pcr_factor_kernel<3>;
  if (dp == 6) return pcr_factor_kernel<6>;
  return nullptr;
}

int threads_of(int dp) { return dp == 3 ? block_threads(3) : block_threads(6); }

}  // namespace

extern "C" {

// Threads a block, and the state's floats a pose (the workspace the launch
// takes is that times n), for dp; -1 for a dp the kernel is not built for.
int pcr_factor_layout(int dp, int* threads, int* state_floats) {
  if (kernel_for(dp) == nullptr) return -1;
  *threads = threads_of(dp);
  *state_floats = state_blocks * dp * dp;
  return 0;
}

// Blocks of the instantiation for dp that the card runs at once (the
// largest cooperative grid), or 0 where the device cannot launch
// cooperatively.  Returns a cudaError_t.
int pcr_factor_grid_fit(int dp, int device, int* blocks) {
  *blocks = 0;
  const KernelFn kernel = kernel_for(dp);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  int sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess || !coop) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads_of(dp), 0);
  if (err != cudaSuccess) return (int)err;
  *blocks = per_sm * sms;
  return 0;
}

// The instantiation for dp as the card compiled it: out[0] its registers a
// thread, out[1] its local memory a thread (spilled registers).  Returns a
// cudaError_t.
int pcr_factor_attrs(int dp, long long* out) {
  const KernelFn kernel = kernel_for(dp);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = (long long)fa.numRegs;
  out[1] = (long long)fa.localSizeBytes;
  return 0;
}

// Factor the n-pose chain of dp blocks in `levels` levels on `stream`: a
// cooperative grid of `blocks` blocks with `work` (state_floats * n f32) as
// its state.  Returns the launch's cudaError_t.
int pcr_factor_launch(int dp, int n, int levels, int blocks, const float* diag,
                      const float* upper, float* alphas, float* gammas, float* binv,
                      float* work, void* stream) {
  const KernelFn kernel = kernel_for(dp);
  if (kernel == nullptr || n < 1 || levels < 1 || blocks < 1 || work == nullptr)
    return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&diag,   (void*)&upper,  (void*)&n,    (void*)&levels,
                  (void*)&alphas, (void*)&gammas, (void*)&binv, (void*)&work};
  return (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                          dim3(threads_of(dp)), args, 0,
                                          (cudaStream_t)stream);
}

}  // extern "C"
