// The SE(3) edges of bundle adjustment, one thread an edge: residuals,
// Huber weights and, for the assembly, the per-edge normal-equation blocks,
// in one launch an edge kind.
//
// Replaces no TPU kernel: the JAX package evaluates the edges with jnp code
// and jax.jacfwd that XLA fuses (toyslam_tpu/ops/residuals3d.py,
// edge_blocks3d.py, schur3d.py).  The port's plain version is the batched
// PyTorch of toyslam_torch/ops/residuals3d.py (eval_odom3d_edges,
// eval_reproj_edges) and ops/edge_blocks3d.py (odom3d_edge_blocks,
// reproj_edge_blocks): about 1,450 small ops an assembly at 512 cameras,
// most of them torch.func.jacfwd's under vmap, and 227 a chi^2, each some
// us of host time for ns of device work.  This file is that work in two
// launches.
//
// Relative-pose edges (odom3d_kernel), [E] of them:
//   r = log(meas^-1 . (T_i^-1 . T_j)) in the decoupled (t, log R) chart
//   (se3.log: the translation, then log_so3 of the rotation);
//   chi2 = r^T info r * mask; robust_err, w: Huber (residuals.huber_weights)
//   of chi2, both times mask.  Mode kBlocksExact adds the Jacobians JA =
//   dr/d eps_i, JB = dr/d eps_j at eps = 0 (eps the tangent of
//   se3.retract: t + dt, R exp(omega^)) in forward mode: the tangents of
//   the same expressions, one direction at a time, through the branches
//   the plain version takes (at eps = 0 exp_so3 is on its series, whose
//   tangent is hat(d omega); log_so3's clamp of cos passes a tangent only
//   inside [-1 + 1e-7, 1], its near_zero series below 1e-6 from 1, else
//   theta / sin(theta) of arccos).  kBlocksFixed takes A = -I, B = I (the
//   plain version's exact=False).  From them, with W' = w * info:
//   w_aa = JA^T W' JA, w_bb = JB^T W' JB, w_ab = JA^T W' JB,
//   b_a = JA^T W' r, b_b = JB^T W' r.
// Reprojection edges (reproj_kernel), [E] of them: x_c = R^T (X - t),
//   the pinhole projection with the depth clamped at the near plane (the
//   fifth intrinsic where there is one, else 1e-6), r = proj - meas, the
//   analytic 2x6 / 2x3 Jacobians (no depth column below a given near
//   plane), Huber, and w_ata [6,6], w_btb [3,3], w_hpl [6,3], bp_c [6],
//   bl_c [3], as ops/edge_blocks3d.py's ReprojBlocks.
// Residuals-only modes write robust_err alone (the step rejection's chi^2;
// its relative-pose edges take no Jacobians there, as the plain version).
//
// Layout: every tensor as the graph holds it, per-edge rows ([E, 12]
// measurements, [E, 6, 6] information, int64 indices), outputs [E, ...]
// row-major, what gather_plan.table_sum and the Schur solve read.  An
// index outside its table gives NaN outputs for that edge, not a read
// out of bounds.
//
// What bounds it on an H100: none of the card's rates.  At 512 relative-
// pose edges and 12,288 reprojection edges it reads ~0.75 MB and writes
// ~3.9 MB (1.4 us at 3.35 TB/s) and does ~6.7 M f32 operations (0.1 us at
// 67 TFLOP/s): its time is one thread's chain of dependent arithmetic
// (~3,500 operations a relative-pose edge, whose 512 fill 4 blocks) and
// the launch.  The design keeps that chain in registers: a
// thread an edge, 128 a block; the 12 tangent directions are unrolled,
// each a few 3x3 products, and each Jacobian column lands in registers;
// the blocks are formed a column at a time (W' J[:, e], then J^T of it)
// and stored as they are made.
// No atomics, no shared memory, every sum in a fixed order: a rerun gives
// the same bits.  The per-vertex sums and the scalar chi^2 stay in the
// caller (the gather tables' fixed order, torch's .sum()).
//
// Built with nvcc for sm_90a, without --use_fast_math (IEEE division and
// square root, as the plain version).  Plain C interface; launched on the
// caller's stream, allocates nothing.  A launch the card refuses returns
// its cudaError_t; there is no other path.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;

// odom3d_kernel's modes
constexpr int kResiduals = 0;     // robust_err only
constexpr int kBlocksFixed = 1;   // blocks with A = -I, B = I
constexpr int kBlocksExact = 2;   // blocks with the forward-mode Jacobians

__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;   // torch.clamp(min=): NaN stays NaN
}

// The residuals and the chi^2 take their products and sums rounded one at
// a time (__fmul_rn, __fadd_rn: never fused into an FMA), so that they come
// out bit for bit the same in every instantiation: the LM step rejection
// compares the chi^2 of the assembly's launch with that of the residuals-
// only launch, and a state evaluated twice has to read the same.

// a0 b0 + a1 b1 + a2 b2, left to right
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1, float a2,
                                      float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)), __fmul_rn(a2, b2));
}

// residuals.huber_weights: (robust_err, w) of chi2
__device__ __forceinline__ void huber(float chi2, float delta, float delta_sq,
                                      float& err, float& w) {
  const float sqrt_e = sqrtf(clamp_min(chi2, 1e-30f));
  const bool inlier = chi2 <= delta_sq;
  err = inlier ? chi2 : __fsub_rn(__fmul_rn(__fmul_rn(2.0f, sqrt_e), delta), delta_sq);
  w = inlier ? 1.0f : __fmul_rn(1.0f / sqrt_e, delta);
}

// A^T x for a row-major 3x3 A
__device__ __forceinline__ void mtv3(const float* A, const float* x, float* y) {
#pragma unroll
  for (int r = 0; r < 3; ++r) y[r] = dot3(A[r], x[0], A[3 + r], x[1], A[6 + r], x[2]);
}

// A^T B for row-major 3x3 A, B
__device__ __forceinline__ void mtm3(const float* A, const float* B, float* C) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      C[3 * r + c] = dot3(A[r], B[c], A[3 + r], B[3 + c], A[6 + r], B[6 + c]);
}

// A hat(e_q): the tangent of A exp(eps e_q) at eps = 0 (se3.exp_so3's
// series branch there has the tangent hat(d omega))
__device__ __forceinline__ void times_hat(const float* A, int q, float* D) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float a0 = A[3 * r], a1 = A[3 * r + 1], a2 = A[3 * r + 2];
    if (q == 0) { D[3 * r] = 0.f; D[3 * r + 1] = a2; D[3 * r + 2] = -a1; }
    if (q == 1) { D[3 * r] = -a2; D[3 * r + 1] = 0.f; D[3 * r + 2] = a0; }
    if (q == 2) { D[3 * r] = a1; D[3 * r + 1] = -a0; D[3 * r + 2] = 0.f; }
  }
}

// se3.log_so3 at R, and what its tangent needs
struct LogSO3 {
  float w[3];       // the axis half-differences
  float scale;      // theta / sin(theta), or its series
  bool pass;        // cos inside the clamp: the tangent passes
  bool near_zero;
  float theta, sin_t, cos_th, dacos;

  __device__ __forceinline__ explicit LogSO3(const float* R) {
    const float trace = R[0] + R[4] + R[8];
    const float x = (trace - 1.0f) * 0.5f;
    const float lo = (float)(-1.0 + 1e-7), hi = 1.0f;
    pass = x >= lo && x <= hi;
    const float c = x < lo ? lo : (x > hi ? hi : x);
    w[0] = 0.5f * (R[7] - R[5]);
    w[1] = 0.5f * (R[2] - R[6]);
    w[2] = 0.5f * (R[3] - R[1]);
    near_zero = c > (float)(1.0 - 1e-6);
    // the untaken branch at a safe argument, as the plain version.
    // sin(arccos c) = sqrt((1 - c)(1 + c)) and cos(arccos c) = c: forms
    // that need no argument reduction (sinf's and cosf's for large
    // arguments keeps a table in local memory)
    const float safe = near_zero ? 0.0f : c;
    theta = acosf(safe);
    sin_t = sqrtf(__fmul_rn(__fsub_rn(1.0f, safe), __fadd_rn(1.0f, safe)));
    cos_th = safe;
    dacos = -rsqrtf(-safe * safe + 1.0f);
    scale = near_zero ? 1.0f + (1.0f - c) / 3.0f : theta / sin_t;
  }

  __device__ __forceinline__ void value(float* out) const {
#pragma unroll
    for (int k = 0; k < 3; ++k) out[k] = w[k] * scale;
  }

  // the tangent of log_so3 along dR
  __device__ __forceinline__ void tangent(const float* dR, float* out) const {
    const float dcos = pass ? (dR[0] + dR[4] + dR[8]) * 0.5f : 0.0f;
    float dscale;
    if (near_zero) {
      dscale = -dcos / 3.0f;
    } else {
      const float dtheta = dcos * dacos;
      dscale = dtheta / sin_t - (cos_th * dtheta) * (scale / sin_t);
    }
    const float dw[3] = {0.5f * (dR[7] - dR[5]), 0.5f * (dR[2] - dR[6]),
                         0.5f * (dR[3] - dR[1])};
#pragma unroll
    for (int k = 0; k < 3; ++k) out[k] = dw[k] * scale + w[k] * dscale;
  }
};

__device__ __forceinline__ void load(const float* p, int n, float* v) {
#pragma unroll
  for (int k = 0; k < n; ++k) v[k] = __ldg(p + k);
}

// The relative-pose residual and, with kJac, its Jacobians JA, JB [6, 6]
// (row: residual entry, column: tangent direction (dt, omega)).
template <bool kJac>
__device__ __forceinline__ void odom_eval(const float* pa, const float* pb,
                                          const float* pm, float* r, float* JA,
                                          float* JB) {
  float Ra[9], ta[3], Rb[9], tb[3], Rm[9], tm[3];
  load(pa, 9, Ra); load(pa + 9, 3, ta);
  load(pb, 9, Rb); load(pb + 9, 3, tb);
  load(pm, 9, Rm); load(pm + 9, 3, tm);
  // inverse(a) = (Ra^T, -Ra^T ta); rel = inverse(a) . b
  float tai[3], Rrel[9], trel[3], u[3];
  mtv3(Ra, ta, tai);
#pragma unroll
  for (int k = 0; k < 3; ++k) tai[k] = -tai[k];
  mtm3(Ra, Rb, Rrel);
  mtv3(Ra, tb, u);
#pragma unroll
  for (int k = 0; k < 3; ++k) trel[k] = tai[k] + u[k];
  // inverse(meas) . rel
  float tmi[3], R[9];
  mtv3(Rm, tm, tmi);
  mtm3(Rm, Rrel, R);
  mtv3(Rm, trel, u);
#pragma unroll
  for (int k = 0; k < 3; ++k) r[k] = -tmi[k] + u[k];
  const LogSO3 lg(R);
  lg.value(r + 3);
  if (!kJac) return;

  float dR[9], dRrel[9], dtrel[3], dt[3], dl[3], D[9];
  // tb - ta: d trel along eps_a's omega is -dRa^T ta + dRa^T tb, taken as
  // dRa^T (tb - ta), which does not lose the cameras' distance from the
  // origin to float32 cancellation
  const float tba[3] = {tb[0] - ta[0], tb[1] - ta[1], tb[2] - ta[2]};
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    // eps_a's dt_q: d tai = -Ra^T e_q; no rotation moves
    dtrel[0] = -Ra[3 * q]; dtrel[1] = -Ra[3 * q + 1]; dtrel[2] = -Ra[3 * q + 2];
    mtv3(Rm, dtrel, dt);
    // eps_b's dt_q: d trel = Ra^T e_q
    float db[3] = {Ra[3 * q], Ra[3 * q + 1], Ra[3 * q + 2]};
    float dtb[3];
    mtv3(Rm, db, dtb);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      JA[6 * k + q] = dt[k];
      JA[6 * (k + 3) + q] = 0.f;
      JB[6 * k + q] = dtb[k];
      JB[6 * (k + 3) + q] = 0.f;
    }
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    // eps_a's omega_q: dRa = Ra hat(e_q); d inverse(a) = (dRa^T, -dRa^T ta)
    times_hat(Ra, q, D);
    mtm3(D, Rb, dRrel);
    mtv3(D, tba, dtrel);
    mtm3(Rm, dRrel, dR);
    mtv3(Rm, dtrel, dt);
    lg.tangent(dR, dl);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      JA[6 * k + 3 + q] = dt[k];
      JA[6 * (k + 3) + 3 + q] = dl[k];
    }
    // eps_b's omega_q: dRb = Rb hat(e_q); d rel = (Ra^T dRb, 0)
    times_hat(Rb, q, D);
    mtm3(Ra, D, dRrel);
    mtm3(Rm, dRrel, dR);
    lg.tangent(dR, dl);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      JB[6 * k + 3 + q] = 0.f;
      JB[6 * (k + 3) + 3 + q] = dl[k];
    }
  }
}

// J^T W' J, J^T W' K, a column at a time into out (row-major, stride n),
// for J [rows, nj] and K [rows, nk]; W' [rows, rows] symmetric or not,
// applied as W' x.
template <int ROWS, int NJ, int NK>
__device__ __forceinline__ void quad_cols(const float* W, const float* J,
                                          const float* K, float* out_jk,
                                          float* out_kk) {
#pragma unroll
  for (int e = 0; e < NK; ++e) {
    float v[ROWS];
#pragma unroll
    for (int a = 0; a < ROWS; ++a) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < ROWS; ++c) s += W[ROWS * a + c] * K[NK * c + e];
      v[a] = s;
    }
    if (out_jk != nullptr) {
#pragma unroll
      for (int d = 0; d < NJ; ++d) {
        float s = 0.f;
#pragma unroll
        for (int a = 0; a < ROWS; ++a) s += J[NJ * a + d] * v[a];
        out_jk[NK * d + e] = s;
      }
    }
    if (out_kk != nullptr) {
#pragma unroll
      for (int d = 0; d < NK; ++d) {
        float s = 0.f;
#pragma unroll
        for (int a = 0; a < ROWS; ++a) s += K[NK * a + d] * v[a];
        out_kk[NK * d + e] = s;
      }
    }
  }
}

// J^T v for J [rows, n]
template <int ROWS, int N>
__device__ __forceinline__ void jtv(const float* J, const float* v, float* out) {
#pragma unroll
  for (int d = 0; d < N; ++d) {
    float s = 0.f;
#pragma unroll
    for (int a = 0; a < ROWS; ++a) s += J[N * a + d] * v[a];
    out[d] = s;
  }
}

// r^T W r for W [n, n], rounded a step at a time (above)
template <int N>
__device__ __forceinline__ float vwv(const float* r, const float* W) {
  float s = 0.f;
#pragma unroll
  for (int a = 0; a < N; ++a) {
    float t = 0.f;
#pragma unroll
    for (int c = 0; c < N; ++c) t = __fadd_rn(t, __fmul_rn(W[N * a + c], r[c]));
    s = __fadd_rn(s, __fmul_rn(r[a], t));
  }
  return s;
}

__device__ __forceinline__ bool in_table(long long v, int n) { return v >= 0 && v < n; }

template <int MODE>
__global__ void __launch_bounds__(kThreads)
odom3d_kernel(const float* __restrict__ poses, const long long* __restrict__ ei,
              const long long* __restrict__ ej, const float* __restrict__ meas,
              const float* __restrict__ info, const float* __restrict__ mask,
              int n_poses, int n_edges, float delta, float delta_sq,
              float* __restrict__ robust_err, float* __restrict__ w_aa,
              float* __restrict__ w_bb, float* __restrict__ w_ab,
              float* __restrict__ b_a, float* __restrict__ b_b,
              float* __restrict__ ja, float* __restrict__ jb) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n_edges) return;
  const long long e64 = e;   // every output offset in 64 bits
  const long long i = ei[e], j = ej[e];
  constexpr bool kJac = MODE == kBlocksExact;
  float r[6], JA[kJac ? 36 : 1], JB[kJac ? 36 : 1];
  if (!in_table(i, n_poses) || !in_table(j, n_poses)) {
    const float nan = __int_as_float(0x7fffffff);
    robust_err[e] = nan;
    if (MODE != kResiduals) {
      for (int k = 0; k < 36; ++k) w_aa[36 * e64 + k] = w_bb[36 * e64 + k] = w_ab[36 * e64 + k] = nan;
      for (int k = 0; k < 6; ++k) b_a[6 * e64 + k] = b_b[6 * e64 + k] = nan;
    }
    if (ja != nullptr)
      for (int k = 0; k < 36; ++k) ja[36 * e64 + k] = jb[36 * e64 + k] = nan;
    return;
  }
  odom_eval<kJac>(poses + 12 * i, poses + 12 * j, meas + 12 * e64, r, JA, JB);
  float W[36];
  load(info + 36 * e64, 36, W);
  const float m = __ldg(mask + e);
  const float chi2 = vwv<6>(r, W) * m;
  float err, w;
  huber(chi2, delta, delta_sq, err, w);
  robust_err[e] = err * m;
  if (MODE == kResiduals) return;
  const float wm = w * m;
#pragma unroll
  for (int k = 0; k < 36; ++k) W[k] = wm * W[k];
  float wr[6], b[6];
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < 6; ++c) s += W[6 * a + c] * r[c];
    wr[a] = s;
  }
  float* aa = w_aa + 36 * e64;
  float* bb = w_bb + 36 * e64;
  float* ab = w_ab + 36 * e64;
  if (kJac) {
    if (ja != nullptr) {
#pragma unroll
      for (int k = 0; k < 36; ++k) { ja[36 * e64 + k] = JA[k]; jb[36 * e64 + k] = JB[k]; }
    }
    quad_cols<6, 6, 6>(W, JA, JA, nullptr, aa);
    quad_cols<6, 6, 6>(W, JA, JB, ab, bb);
    jtv<6, 6>(JA, wr, b);
#pragma unroll
    for (int k = 0; k < 6; ++k) b_a[6 * e64 + k] = b[k];
    jtv<6, 6>(JB, wr, b);
#pragma unroll
    for (int k = 0; k < 6; ++k) b_b[6 * e64 + k] = b[k];
  } else {
    // A = -I, B = I: W', W', -W', -W' r, W' r
#pragma unroll
    for (int k = 0; k < 36; ++k) { aa[k] = W[k]; bb[k] = W[k]; ab[k] = -W[k]; }
#pragma unroll
    for (int k = 0; k < 6; ++k) { b_a[6 * e64 + k] = -wr[k]; b_b[6 * e64 + k] = wr[k]; }
  }
}

template <bool kBlocks>
__global__ void __launch_bounds__(kThreads)
reproj_kernel(const float* __restrict__ poses, const float* __restrict__ landmarks,
              const float* __restrict__ intrinsics, int n_intrinsics,
              const long long* __restrict__ ep, const long long* __restrict__ el,
              const float* __restrict__ meas, const float* __restrict__ info,
              const float* __restrict__ mask, int n_poses, int n_landmarks,
              int n_edges, float delta, float delta_sq,
              float* __restrict__ robust_err, float* __restrict__ chi2_out,
              float* __restrict__ w_ata, float* __restrict__ w_btb,
              float* __restrict__ w_hpl, float* __restrict__ bp_c,
              float* __restrict__ bl_c) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n_edges) return;
  const long long e64 = e;   // every output offset in 64 bits
  const long long p = ep[e], l = el[e];
  if (!in_table(p, n_poses) || !in_table(l, n_landmarks)) {
    const float nan = __int_as_float(0x7fffffff);
    robust_err[e] = nan;
    if (kBlocks) {
      chi2_out[e] = nan;
      for (int k = 0; k < 36; ++k) w_ata[36 * e64 + k] = nan;
      for (int k = 0; k < 9; ++k) w_btb[9 * e64 + k] = nan;
      for (int k = 0; k < 18; ++k) w_hpl[18 * e64 + k] = nan;
      for (int k = 0; k < 6; ++k) bp_c[6 * e64 + k] = nan;
      for (int k = 0; k < 3; ++k) bl_c[3 * e64 + k] = nan;
    }
    return;
  }
  float R[9], t[3], X[3];
  load(poses + 12 * p, 9, R);
  load(poses + 12 * p + 9, 3, t);
  load(landmarks + 3 * l, 3, X);
  const float fx = __ldg(intrinsics), fy = __ldg(intrinsics + 1);
  const float cx = __ldg(intrinsics + 2), cy = __ldg(intrinsics + 3);
  const bool given = n_intrinsics > 4;
  const float near = given ? __ldg(intrinsics + 4) : 1e-6f;
  // x_c = R^T (X - t)
  const float d[3] = {X[0] - t[0], X[1] - t[1], X[2] - t[2]};
  float xc[3];
  mtv3(R, d, xc);
  const float z = clamp_min(xc[2], near);
  float r[2];
  r[0] = fx * xc[0] / z + cx - __ldg(meas + 2 * e64);
  r[1] = fy * xc[1] / z + cy - __ldg(meas + 2 * e64 + 1);
  float W[4];
  load(info + 4 * e64, 4, W);
  const float m = __ldg(mask + e);
  const float chi2 = vwv<2>(r, W) * m;
  float err, w;
  huber(chi2, delta, delta_sq, err, w);
  robust_err[e] = err * m;
  if (!kBlocks) return;
  chi2_out[e] = chi2;

  const float inv_z = 1.0f / z;
  const float x_z = xc[0] * inv_z, y_z = xc[1] * inv_z;
  // the depth column, none below a given near plane
  const float dz = given && !(xc[2] > near) ? 0.0f : inv_z;
  const float jp[6] = {fx * inv_z, 0.f, -fx * x_z * dz,
                       0.f, fy * inv_z, -fy * y_z * dz};
  // JA = [J_proj (-R^T) | J_proj hat(x_c)] [2, 6], JB = J_proj R^T [2, 3]
  float JA[12], JB[6];
  const float H[9] = {0.f, -xc[2], xc[1], xc[2], 0.f, -xc[0], -xc[1], xc[0], 0.f};
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      // (R^T)[k][c] = R[c][k]
      const float rt = jp[3 * a] * R[3 * c] + jp[3 * a + 1] * R[3 * c + 1] +
                       jp[3 * a + 2] * R[3 * c + 2];
      JB[3 * a + c] = rt;
      JA[6 * a + c] = -rt;
      JA[6 * a + 3 + c] = jp[3 * a] * H[c] + jp[3 * a + 1] * H[3 + c] +
                          jp[3 * a + 2] * H[6 + c];
    }
  }
  const float wm = w * m;
#pragma unroll
  for (int k = 0; k < 4; ++k) W[k] = wm * W[k];
  float wr[2] = {W[0] * r[0] + W[1] * r[1], W[2] * r[0] + W[3] * r[1]};
  quad_cols<2, 6, 6>(W, JA, JA, nullptr, w_ata + 36 * e64);
  quad_cols<2, 6, 3>(W, JA, JB, w_hpl + 18 * e64, w_btb + 9 * e64);
  float b[6];
  jtv<2, 6>(JA, wr, b);
#pragma unroll
  for (int k = 0; k < 6; ++k) bp_c[6 * e64 + k] = b[k];
  jtv<2, 3>(JB, wr, b);
#pragma unroll
  for (int k = 0; k < 3; ++k) bl_c[3 * e64 + k] = b[k];
}

int grid(int n) { return (n + kThreads - 1) / kThreads; }

// the instantiations, as edges3d_attrs numbers them
const void* const kKernels[] = {
    (const void*)odom3d_kernel<kResiduals>, (const void*)odom3d_kernel<kBlocksFixed>,
    (const void*)odom3d_kernel<kBlocksExact>, (const void*)reproj_kernel<false>,
    (const void*)reproj_kernel<true>};

}  // namespace

extern "C" {

// Instantiation k (0-2: the relative-pose kernel in residuals-only,
// A = -I / B = I and exact-Jacobian modes; 3-4: the reprojection kernel
// without and with blocks) as the card compiled it: out[0] its registers a
// thread, out[1] its local memory a thread (spilled registers).  Returns a
// cudaError_t.
int edges3d_attrs(int k, long long* out) {
  if (k < 0 || k >= (int)(sizeof(kKernels) / sizeof(kKernels[0])))
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, kKernels[k]);
  if (err != cudaSuccess) return (int)err;
  out[0] = (long long)fa.numRegs;
  out[1] = (long long)fa.localSizeBytes;
  return 0;
}

// The relative-pose edges on `stream`: mode 0 writes robust_err alone
// (w_aa ... b_b may be null), 1 the blocks with A = -I, B = I, 2 the blocks
// with the exact Jacobians, and with ja and jb not null the Jacobians
// themselves ([E, 6, 6] each).  Returns the launch's cudaError_t.
int edges3d_odom_launch(int mode, int n_poses, int n_edges, const float* poses,
                        const long long* i, const long long* j, const float* meas,
                        const float* info, const float* mask, double delta,
                        float* robust_err, float* w_aa, float* w_bb, float* w_ab,
                        float* b_a, float* b_b, float* ja, float* jb, void* stream) {
  if (n_edges < 1 || mode < kResiduals || mode > kBlocksExact ||
      (mode != kResiduals &&
       (w_aa == nullptr || w_bb == nullptr || w_ab == nullptr || b_a == nullptr ||
        b_b == nullptr)) ||
      ((ja == nullptr) != (jb == nullptr)) || (ja != nullptr && mode != kBlocksExact))
    return (int)cudaErrorInvalidValue;
  const float d = (float)delta, dsq = (float)(delta * delta);
  const cudaStream_t s = (cudaStream_t)stream;
  if (mode == kResiduals)
    odom3d_kernel<kResiduals><<<grid(n_edges), kThreads, 0, s>>>(
        poses, i, j, meas, info, mask, n_poses, n_edges, d, dsq, robust_err, w_aa,
        w_bb, w_ab, b_a, b_b, ja, jb);
  else if (mode == kBlocksFixed)
    odom3d_kernel<kBlocksFixed><<<grid(n_edges), kThreads, 0, s>>>(
        poses, i, j, meas, info, mask, n_poses, n_edges, d, dsq, robust_err, w_aa,
        w_bb, w_ab, b_a, b_b, ja, jb);
  else
    odom3d_kernel<kBlocksExact><<<grid(n_edges), kThreads, 0, s>>>(
        poses, i, j, meas, info, mask, n_poses, n_edges, d, dsq, robust_err, w_aa,
        w_bb, w_ab, b_a, b_b, ja, jb);
  return (int)cudaGetLastError();
}

// The reprojection edges on `stream`: with `blocks` 0 robust_err alone (the
// other outputs may be null), else chi2 and the blocks too.  Returns the
// launch's cudaError_t.
int edges3d_reproj_launch(int blocks, int n_poses, int n_landmarks,
                          int n_intrinsics, int n_edges, const float* poses,
                          const float* landmarks, const float* intrinsics,
                          const long long* pose, const long long* lm,
                          const float* meas, const float* info, const float* mask,
                          double delta, float* robust_err, float* chi2,
                          float* w_ata, float* w_btb, float* w_hpl, float* bp_c,
                          float* bl_c, void* stream) {
  if (n_edges < 1 || (n_intrinsics != 4 && n_intrinsics != 5) ||
      (blocks && (chi2 == nullptr || w_ata == nullptr || w_btb == nullptr ||
                  w_hpl == nullptr || bp_c == nullptr || bl_c == nullptr)))
    return (int)cudaErrorInvalidValue;
  const float d = (float)delta, dsq = (float)(delta * delta);
  const cudaStream_t s = (cudaStream_t)stream;
  if (blocks)
    reproj_kernel<true><<<grid(n_edges), kThreads, 0, s>>>(
        poses, landmarks, intrinsics, n_intrinsics, pose, lm, meas, info, mask,
        n_poses, n_landmarks, n_edges, d, dsq, robust_err, chi2, w_ata, w_btb, w_hpl,
        bp_c, bl_c);
  else
    reproj_kernel<false><<<grid(n_edges), kThreads, 0, s>>>(
        poses, landmarks, intrinsics, n_intrinsics, pose, lm, meas, info, mask,
        n_poses, n_landmarks, n_edges, d, dsq, robust_err, chi2, w_ata, w_btb, w_hpl,
        bp_c, bl_c);
  return (int)cudaGetLastError();
}

}  // extern "C"
