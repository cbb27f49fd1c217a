// One chunk of preconditioned conjugate gradients on the damped reduced pose
// system S = T - V V^T, in one thread block.
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
// Layout: state vectors component-major [DP, Np] in dynamic shared memory;
// the V slabs U[a] = [Np, Mw] stay in global memory (at the 150-pose graph
// they are 1.77 MB and live in L2).  The scalars stay in device memory, so a
// chunk never syncs with the host.
//
// What bounds it on an H100: one SM streams U twice per matvec
// (2 * DP * Np * Mw * 4 bytes) through its own L2 bandwidth, plus the launch
// latency of one kernel per chunk.  Measured at Np=192, Mw=768: 0.795 ms per
// 16-iteration chunk, about 76 GB/s of U reads (H100 80GB HBM3, 700 W).  A
// later design spreads the matvec over a cluster or a cooperative grid, or
// moves the outer loop on the device.
//
// Built with nvcc for sm_90a, WITHOUT --use_fast_math: the breakdown test
// needs isfinite() to see NaN/inf, and alpha/beta need IEEE division.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kRedFloats = 2 * kWarps + 2;

struct Params {
  int np, mw, nlevels, nc, chunk_iters, maxit, restart;
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
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of a and b over the block, returned to every thread.  Fixed order for
// a fixed block size, so repeated runs agree bit for bit.
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

// out = S in = T in - V (V^T in).  `in` and `out` are distinct [DP, Np]
// shared-memory vectors; urow is Mw floats of shared scratch.  Ends with a
// barrier.
template <int DP>
__device__ void matvec(const Params& P, const float* __restrict__ in,
                       float* __restrict__ out, float* __restrict__ urow) {
  const int n = P.np, mw = P.mw;
  // urow = V^T in: thread owns columns j, loads coalesced along Mw
  for (int j = threadIdx.x; j < mw; j += blockDim.x) {
    float acc = 0.f;
#pragma unroll
    for (int a = 0; a < DP; ++a) {
      const float* ua = P.u + (size_t)a * n * mw + j;
      const float* xa = in + a * n;
#pragma unroll 8
      for (int p = 0; p < n; ++p) acc = fmaf(xa[p], __ldg(ua + (size_t)p * mw), acc);
    }
    urow[j] = acc;
  }
  // T in, neighbours at p + 1 and p - 1 mod Np
  for (int e = threadIdx.x; e < DP * n; e += blockDim.x) {
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
    out[e] = yd + yu + yl;
  }
  __syncthreads();
  // out -= V urow: one warp per row (a, p), lanes along Mw
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int row = warp; row < DP * n; row += nwarps) {
    const float* ur = P.u + (size_t)row * mw;
    float acc = 0.f;
    for (int j = lane; j < mw; j += 32) acc = fmaf(__ldg(ur + j), urow[j], acc);
    acc = warp_sum(acc);
    if (lane == 0) out[row] -= acc;
  }
  __syncthreads();
}

// z = M^-1 r.  r must be complete (barrier before the call); ta/tb are the
// PCR ping-pong buffers, rc/za the coarse scratch.  Ends with a barrier.
template <int DP>
__device__ void precond(const Params& P, const float* __restrict__ r,
                        float* __restrict__ z, float* ta, float* tb,
                        float* rc, float* za) {
  const int n = P.np;
  const float* t = r;
  int s = 1;
  for (int l = 0; l < P.nlevels; ++l) {
    float* o = (l & 1) ? tb : ta;
    const float* al = P.alphas + (size_t)l * DP * DP * n;
    const float* ga = P.gammas + (size_t)l * DP * DP * n;
    const int sm = s % n;
    for (int e = threadIdx.x; e < DP * n; e += blockDim.x) {
      const int a = e / n, p = e - a * n;
      int pd = p - sm;            // t[p - s mod Np]
      if (pd < 0) pd += n;
      int pu = p + sm;            // t[p + s mod Np]
      if (pu >= n) pu -= n;
      float sa = 0.f, sg = 0.f;
#pragma unroll
      for (int b = 0; b < DP; ++b) {
        const size_t c = (size_t)(a * DP + b) * n + p;
        sa = fmaf(__ldg(al + c), t[b * n + pd], sa);
        sg = fmaf(__ldg(ga + c), t[b * n + pu], sg);
      }
      o[e] = t[e] + sa + sg;
    }
    __syncthreads();
    t = o;
    s *= 2;
  }
  for (int e = threadIdx.x; e < DP * n; e += blockDim.x) {
    const int a = e / n, p = e - a * n;
    float acc = 0.f;
#pragma unroll
    for (int b = 0; b < DP; ++b)
      acc = fmaf(__ldg(P.binv + (size_t)(a * DP + b) * n + p), t[b * n + p], acc);
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
__global__ void __launch_bounds__(kThreads) fused_pcg_chunk_kernel(Params P) {
  extern __shared__ float smem[];
  const int n = P.np, N = DP * n;
  float* x = smem;
  float* r = x + N;
  float* p = r + N;
  float* ap = p + N;
  float* z = ap + N;
  float* ta = z + N;
  float* tb = ta + N;
  float* urow = tb + N;
  float* rc = urow + P.mw;
  float* za = rc + DP * P.nc;
  float* red = za + DP * P.nc;

  // chunk entry: restart replaces the recurrence residual with the carried
  // true residual and resets the search direction
  const bool restart = P.restart != 0;
  for (int e = threadIdx.x; e < N; e += blockDim.x) {
    x[e] = P.x_in[e];
    r[e] = restart ? P.rt_in[e] : P.r_in[e];
  }
  __syncthreads();
  precond<DP>(P, r, z, ta, tb, rc, za);
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
    matvec<DP>(P, p, ap, urow);
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
    precond<DP>(P, r, z, ta, tb, rc, za);
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

  // chunk exit: the true residual rhs - S x and its squared norm
  matvec<DP>(P, x, ap, urow);
  sr = 0.f;
  for (int e = threadIdx.x; e < N; e += blockDim.x) {
    const float rt = P.rhs[e] - ap[e];
    P.rt_out[e] = rt;
    P.x_out[e] = x[e];
    P.r_out[e] = r[e];
    P.p_out[e] = p[e];
    sr = fmaf(rt, rt, sr);
  }
  const float rr_true = block_sum2(sr, 0.f, red).x;
  if (threadIdx.x == 0) {
    *P.it_out = it;
    *P.rz_out = rz;
    *P.stop_out = stop ? 1 : 0;
    *P.rr_out = rr_true;
  }
}

size_t smem_bytes(int dp, int np, int mw, int nc) {
  return sizeof(float) *
         ((size_t)7 * dp * np + (size_t)mw + (size_t)2 * dp * nc + kRedFloats);
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs, in bytes.
long long fused_pcg_chunk_smem_bytes(int dp, int np, int mw, int nc) {
  return (long long)smem_bytes(dp, np, mw, nc);
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

// Launch one chunk on `stream`.  Returns a cudaError_t (0 = launched).
int fused_pcg_chunk_launch(
    int dp, int np, int mw, int nlevels, int nc, int chunk_iters, int maxit,
    int restart, const float* atol2, const int* it_in, const float* rz_in,
    const int* stop_in, const float* rhs, const float* x_in, const float* r_in,
    const float* p_in, const float* rt_in, const float* u, const float* td,
    const float* tu, const float* tl, const float* alphas, const float* gammas,
    const float* binv, const float* cinv, const float* rmat, float* x_out,
    float* r_out, float* p_out, float* rt_out, int* it_out, float* rz_out,
    int* stop_out, float* rr_out, void* stream) {
  if (dp != 3 || np < 1 || mw < 1 || nlevels < 0 || chunk_iters < 0 ||
      (cinv == nullptr) != (rmat == nullptr) || (cinv != nullptr && nc < 1))
    return (int)cudaErrorInvalidValue;
  if (cinv == nullptr) nc = 0;
  Params P{np,     mw,    nlevels, nc,     chunk_iters, maxit, restart,
           atol2,  it_in, rz_in,   stop_in, rhs,        x_in,  r_in,
           p_in,   rt_in, u,       td,     tu,          tl,    alphas,
           gammas, binv,  cinv,    rmat,   x_out,       r_out, p_out,
           rt_out, it_out, rz_out, stop_out, rr_out};
  const size_t bytes = smem_bytes(dp, np, mw, nc);
  cudaError_t err = cudaFuncSetAttribute(
      fused_pcg_chunk_kernel<3>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  fused_pcg_chunk_kernel<3><<<1, kThreads, bytes, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

}  // extern "C"
