// RANSAC-PnP (ops/pnp.py::ransac_pnp) as three kernels, one launch each per
// call for every sequence of a batch: hypotheses, scores, polish.
//
// It replaces no TPU kernel. The JAX package writes PnP as dense XLA
// (stereo_visual_odometry_tpu/ops/pnp.py), and XLA fuses its unrolled 6x6 and
// 12x12 solves over the hypotheses into a few fusions. The port's plain
// version (ransac_pnp_reference) is the same chain of torch ops, one launch
// per scalar step of the unrolled factorizations: ~7,060 launches per call,
// each a node of ~1.3 us in the step's CUDA graph and a few hundred bytes of
// work.
//
// What bounds it on Hopper: launches and the latency of dependent scalar
// arithmetic, not bytes or flops. A call reads N points (N = 1024 for LK,
// 2048 for ORB: <= 60 KB per sequence) and does ~10 MFLOP; the plain version
// spends ~9 ms of node overhead on it. The design:
//   * one launch per stage over every sequence (gridDim.y = B), so a vmapped
//     step at S = 11 costs the same three nodes as S = 1;
//   * hypotheses (pnp_hypotheses_kernel): one thread per hypothesis, its
//     12x12 (DLT) or 6x6 (Gauss-Newton) system in registers, every loop
//     unrolled over the static sizes; the DLT and GN hypotheses fall in
//     different warps (min(64, H) DLT first), so a warp does not diverge. The
//     block first compacts the valid mask into shared memory with a block
//     scan, so a sample's index is the pos-th valid index, as the plain
//     version's stable argsort gives it;
//   * scores (pnp_score_kernel): one warp per hypothesis over the N points,
//     lane-strided (coalesced), a shuffle reduction in a fixed pattern;
//   * polish (pnp_polish_kernel): one block per sequence runs the argmin
//     and both rounds of (Huber-weighted Gauss-Newton -> recount): each step
//     is one block reduction of the 21 + 6 sums of J^T W J and J^T W r, one
//     thread solves the 6x6 system and updates the pose in shared memory.
// Every reduction runs in a fixed order (no float atomics): a call repeats
// bit for bit, eagerly and replayed from a CUDA graph. The reprojection error
// that gates inliers is pinned with rounding intrinsics, so the scores and
// the polish's counts see the same bits for the same pose.
//
// Contract (ops/pnp.py::ransac_pnp_reference, float32): B sequences, each
// pts (N, 3), px (N, 2), valid (N,) bool bytes, weights (N,) or null (ones),
// T_init (4, 4) rigid (bottom row 0 0 0 1) or null, u (H, 6) uniforms in
// [0, 1); the intrinsics fx, fy, cx, cy, one float each for all sequences
// (one rig). Writes the samples (B, H, 6)
// int32, their duplicate flags (B, H), the H' = H + (T_init given)
// hypotheses (B, H', 12: R row-major, then t), their MSAC scores (B, H'), the
// chosen hypothesis (B,) int32, and the results: T (B, 4, 4), inliers (B, N)
// bool bytes, num_inliers (B,) int64, inlier_ratio (B,) and ok (B,) bool
// bytes. Launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "patch_common.cuh"

namespace {

constexpr int kSample = 6;            // pnp.MIN_SAMPLE points per hypothesis
constexpr int kMaxDlt = 64;           // the first min(64, H) hypotheses are DLT
constexpr int kHypThreads = 64;       // hypotheses per block of the first stage
constexpr int kScoreWarps = 8;        // hypotheses per block of the scores
constexpr int kPolishThreads = 256;
constexpr int kPolishWarps = kPolishThreads / 32;
constexpr int kSums = 27;             // J^T W J (21, packed lower) and J^T W r (6)
constexpr int kMaxSmem = 227 * 1024;  // Hopper's opt-in shared memory per block

struct Cam {
  float fx, fy, cx, cy;
};

struct CamPtrs {
  const float *fx, *fy, *cx, *cy;

  __device__ Cam load() const { return {*fx, *fy, *cx, *cy}; }
};

// Packed lower-triangular index.
__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// torch.clamp(x, min=lo) / (max=hi): a NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_max(float x, float hi) { return x > hi ? hi : x; }

// Squared reprojection error of point (X, Y, Z) at pixel (pu, pv) under the
// pose T (12 floats), inf behind the camera (pnp._reproj_err2).
__device__ __forceinline__ float reproj_err2(const float* T, const Cam& c, float X, float Y,
                                             float Z, float pu, float pv) {
  const float x = __fadd_rn(__fmaf_rn(T[2], Z, __fmaf_rn(T[1], Y, __fmul_rn(T[0], X))), T[9]);
  const float y = __fadd_rn(__fmaf_rn(T[5], Z, __fmaf_rn(T[4], Y, __fmul_rn(T[3], X))), T[10]);
  const float z = __fadd_rn(__fmaf_rn(T[8], Z, __fmaf_rn(T[7], Y, __fmul_rn(T[6], X))), T[11]);
  const float sz = fabsf(z) < 1e-9f ? 1e-9f : z;
  const float du = __fsub_rn(__fadd_rn(__fdiv_rn(__fmul_rn(c.fx, x), sz), c.cx), pu);
  const float dv = __fsub_rn(__fadd_rn(__fdiv_rn(__fmul_rn(c.fy, y), sz), c.cy), pv);
  const float e2 = __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv));
  return z <= 1e-6f ? INFINITY : e2;
}

// Cholesky of the packed SPD matrix A (kN x kN) in place (linalg_small._chol):
// a non-positive pivot is floored at 1e-20 and makes the result false.
template <int kN>
__device__ __forceinline__ bool cholesky(float* A) {
  bool ok = true;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = A[tri(i, j)];
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - A[tri(i, k)] * A[tri(j, k)];
      if (i == j) {
        ok = ok && s > 0.0f;
        A[tri(i, i)] = sqrtf(clamp_min(s, 1e-20f));
      } else {
        A[tri(i, j)] = s / A[tri(j, j)];
      }
    }
  }
  return ok;
}

// x <- A^-1 x from the packed factor L (linalg_small.cho_solve_unrolled).
template <int kN>
__device__ __forceinline__ void cho_solve(const float* L, float* x) {
  float y[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    float s = x[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[tri(i, k)] * y[k];
    y[i] = s / L[tri(i, i)];
  }
#pragma unroll
  for (int i = kN - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < kN; ++k) s = s - L[tri(k, i)] * x[k];
    x[i] = s / L[tri(i, i)];
  }
}

// T <- se3_exp(d) @ T for the twist d = [v, w] (se3.se3_exp).
__device__ __forceinline__ void se3_exp_left(const float* d, float* T) {
  const float w0 = d[3], w1 = d[4], w2 = d[5];
  const float th2 = w0 * w0 + w1 * w1 + w2 * w2;
  const float th = sqrtf(th2 + 1e-16f);
  const bool small = th2 < 1e-8f;
  float s, c;
  sincosf(th, &s, &c);
  const float A = small ? 1.0f - th2 / 6.0f : s / th;
  const float B = small ? 0.5f - th2 / 24.0f : (1.0f - c) / th2;
  const float C = small ? 1.0f / 6.0f - th2 / 120.0f : (th - s) / (th2 * th);
  const float W[9] = {0.0f, -w2, w1, w2, 0.0f, -w0, -w1, w0, 0.0f};
  float WW[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      WW[3 * i + j] = W[3 * i] * W[j] + W[3 * i + 1] * W[3 + j] + W[3 * i + 2] * W[6 + j];
  float Re[9], V[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    const float eye = (e % 4 == 0) ? 1.0f : 0.0f;
    Re[e] = eye + A * W[e] + B * WW[e];
    V[e] = eye + B * W[e] + C * WW[e];
  }
  float out[12];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[3 * i + j] = Re[3 * i] * T[j] + Re[3 * i + 1] * T[3 + j] + Re[3 * i + 2] * T[6 + j];
    const float te = V[3 * i] * d[0] + V[3 * i + 1] * d[1] + V[3 * i + 2] * d[2];
    out[9 + i] = Re[3 * i] * T[9] + Re[3 * i + 1] * T[10] + Re[3 * i + 2] * T[11] + te;
  }
#pragma unroll
  for (int e = 0; e < 12; ++e) T[e] = out[e];
}

// One point's terms of a Gauss-Newton step (pnp.gauss_newton_pose): adds its
// Huber-weighted J^T W J (packed, sums[0..20]) and J^T W r (sums[21..26]).
__device__ __forceinline__ void gn_accumulate(const float* T, const Cam& c, float X, float Y,
                                              float Z, float pu, float pv, float w,
                                              float huber, float* sums) {
  const float x = T[0] * X + T[1] * Y + T[2] * Z + T[9];
  const float y = T[3] * X + T[4] * Y + T[5] * Z + T[10];
  const float z = T[6] * X + T[7] * Y + T[8] * Z + T[11];
  const float iz = 1.0f / clamp_min(z, 1e-6f);
  const float r0 = c.fx * x * iz + c.cx - pu;
  const float r1 = c.fy * y * iz + c.cy - pv;
  const float rn = sqrtf(r0 * r0 + r1 * r1 + 1e-12f);
  float wh = (rn <= huber ? 1.0f : huber / rn) * w;
  wh = wh * (z > 1e-6f ? 1.0f : 0.0f);
  const float iz2 = iz * iz;
  const float J0[6] = {c.fx * iz, 0.0f, -c.fx * x * iz2, -c.fx * x * y * iz2,
                       c.fx * (1.0f + x * x * iz2), -c.fx * y * iz};
  const float J1[6] = {0.0f, c.fy * iz, -c.fy * y * iz2, -c.fy * (1.0f + y * y * iz2),
                       c.fy * x * y * iz2, c.fy * x * iz};
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const float a0 = J0[j] * wh, a1 = J1[j] * wh;
#pragma unroll
    for (int k = 0; k <= j; ++k) sums[tri(j, k)] += a0 * J0[k] + a1 * J1[k];
    sums[21 + j] += a0 * r0 + a1 * r1;
  }
}

// Closes a Gauss-Newton step from its sums: T <- se3_exp(delta) @ T unless the
// normal matrix is not SPD or delta is not finite.
__device__ __forceinline__ void gn_update(float* sums, float* T) {
#pragma unroll
  for (int i = 0; i < 6; ++i) sums[tri(i, i)] += 1e-6f;
  const bool spd = cholesky<6>(sums);
  float d[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) d[i] = -sums[21 + i];
  cho_solve<6>(sums, d);
  bool finite = true;
#pragma unroll
  for (int i = 0; i < 6; ++i) finite = finite && isfinite(d[i]);
  if (spd && finite) se3_exp_left(d, T);
}

// The linear pose of 6 points and their normalized pixels (pnp._dlt_pose):
// shifted inverse iteration on A^T A, scale and sign, then R onto SO(3).
__device__ __forceinline__ void dlt_pose(const float (*X)[3], const float* nu, const float* nv,
                                         const float* w, float* T) {
  float M[78];
#pragma unroll
  for (int e = 0; e < 78; ++e) M[e] = 0.0f;
#pragma unroll
  for (int s = 0; s < kSample; ++s) {
    const float xh[4] = {X[s][0], X[s][1], X[s][2], 1.0f};
    float ru[12], rv[12];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ru[k] = xh[k] * w[s];
      ru[4 + k] = 0.0f * w[s];
      ru[8 + k] = (-nu[s] * xh[k]) * w[s];
      rv[k] = 0.0f * w[s];
      rv[4 + k] = xh[k] * w[s];
      rv[8 + k] = (-nv[s] * xh[k]) * w[s];
    }
#pragma unroll
    for (int i = 0; i < 12; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) M[tri(i, j)] += ru[i] * ru[j] + rv[i] * rv[j];
  }
  float trace = 0.0f;
#pragma unroll
  for (int i = 0; i < 12; ++i) trace += M[tri(i, i)];
  const float jitter = 1e-9f * trace + 1e-12f;
#pragma unroll
  for (int i = 0; i < 12; ++i) M[tri(i, i)] += jitter;
  cholesky<12>(M);
  float p[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) p[i] = 0.28867513459481287f;  // 1 / sqrt(12)
#pragma unroll
  for (int it = 0; it < 3; ++it) {
    cho_solve<12>(M, p);
    float nn = 0.0f;
#pragma unroll
    for (int i = 0; i < 12; ++i) nn += p[i] * p[i];
    const float norm = clamp_min(sqrtf(nn), 1e-30f);
#pragma unroll
    for (int i = 0; i < 12; ++i) p[i] = p[i] / norm;
  }
  // P = p as 3 x 4 rows; det of its left 3 x 3, each product rounded as the
  // plain version's (a contracted fma leaves a residual where it reads 0).
  const float m0 = __fsub_rn(__fmul_rn(p[5], p[10]), __fmul_rn(p[6], p[9]));
  const float m1 = __fsub_rn(__fmul_rn(p[4], p[10]), __fmul_rn(p[6], p[8]));
  const float m2 = __fsub_rn(__fmul_rn(p[4], p[9]), __fmul_rn(p[5], p[8]));
  const float det =
      __fadd_rn(__fsub_rn(__fmul_rn(p[0], m0), __fmul_rn(p[1], m1)), __fmul_rn(p[2], m2));
  float scale = powf(fabsf(det), 1.0f / 3.0f);
  scale = scale < 1e-12f ? 1.0f : scale;
#pragma unroll
  for (int i = 0; i < 12; ++i) p[i] = p[i] / scale;
  float wsum = 0.0f, cen[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int s = 0; s < kSample; ++s) {
    wsum += w[s];
#pragma unroll
    for (int k = 0; k < 3; ++k) cen[k] += X[s][k] * w[s];
  }
  wsum = clamp_min(wsum, 1.0f);
  const float zc =
      p[8] * (cen[0] / wsum) + p[9] * (cen[1] / wsum) + p[10] * (cen[2] / wsum) + p[11];
  const float sign = zc < 0.0f ? -1.0f : 1.0f;
#pragma unroll
  for (int i = 0; i < 12; ++i) p[i] = p[i] * sign;
  // se3.orthonormalize_newton: 4 Newton-Schulz steps after a Frobenius
  // normalization.
  float R[9];
  float fro = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      R[3 * i + j] = p[4 * i + j];
      fro += R[3 * i + j] * R[3 * i + j];
    }
  fro = clamp_min(sqrtf(fro / 3.0f), 1e-12f);
#pragma unroll
  for (int e = 0; e < 9; ++e) R[e] = R[e] / fro;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    float G[9], N[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        G[3 * i + j] =
            R[3 * i] * R[3 * j] + R[3 * i + 1] * R[3 * j + 1] + R[3 * i + 2] * R[3 * j + 2];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        N[3 * i + j] = 1.5f * R[3 * i + j] -
                       0.5f * (G[3 * i] * R[j] + G[3 * i + 1] * R[3 + j] + G[3 * i + 2] * R[6 + j]);
#pragma unroll
    for (int e = 0; e < 9; ++e) R[e] = N[e];
  }
#pragma unroll
  for (int e = 0; e < 9; ++e) T[e] = R[e];
#pragma unroll
  for (int i = 0; i < 3; ++i) T[9 + i] = p[4 * i + 3];
}

// Stage 1: the samples, their duplicate flags and the H' hypotheses.
__global__ void __launch_bounds__(kHypThreads)
pnp_hypotheses_kernel(const float* __restrict__ pts, const float* __restrict__ px,
                      const uint8_t* __restrict__ valid, const float* __restrict__ T_init,
                      const float* __restrict__ u, CamPtrs cams, int n, int h, int hp,
                      int n_dlt, int32_t* __restrict__ samp, uint8_t* __restrict__ dup,
                      float* __restrict__ hyp) {
  extern __shared__ int32_t order[];  // the valid indices, ascending
  __shared__ int counts[kHypThreads];
  const int b = blockIdx.y;
  pts += static_cast<size_t>(b) * n * 3;
  px += static_cast<size_t>(b) * n * 2;
  valid += static_cast<size_t>(b) * n;
  u += static_cast<size_t>(b) * h * kSample;
  samp += static_cast<size_t>(b) * h * kSample;
  dup += static_cast<size_t>(b) * h;
  hyp += static_cast<size_t>(b) * hp * 12;
  // Compaction: thread t owns the contiguous chunk t of the mask.
  const int chunk = (n + kHypThreads - 1) / kHypThreads;
  const int lo = min(n, static_cast<int>(threadIdx.x) * chunk), hi = min(n, lo + chunk);
  int mine = 0;
  for (int i = lo; i < hi; ++i) mine += valid[i] != 0;
  counts[threadIdx.x] = mine;
  __syncthreads();
  int offset = 0, total = 0;
  for (int t = 0; t < kHypThreads; ++t) {
    offset += t < static_cast<int>(threadIdx.x) ? counts[t] : 0;
    total += counts[t];
  }
  for (int i = lo; i < hi; ++i)
    if (valid[i]) order[offset++] = i;
  __syncthreads();

  const int k = blockIdx.x * kHypThreads + threadIdx.x;
  if (k >= hp) return;
  float* T = hyp + static_cast<size_t>(k) * 12;
  if (k >= h) {  // T_init, scored as one more hypothesis
    const float* Ti = T_init + static_cast<size_t>(b) * 16;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) T[3 * i + j] = Ti[4 * i + j];
      T[9 + i] = Ti[4 * i + 3];
    }
    return;
  }
  // Positions over the valid prefix, with replacement; pos = min(trunc(u *
  // n_valid), n_valid - 1) in float32, n_valid at least 1. With no valid
  // point the stable argsort's first index is 0.
  const int nv = max(total, 1);
  const float nvf = static_cast<float>(nv);
  int pos[kSample], idx[kSample];
#pragma unroll
  for (int j = 0; j < kSample; ++j) {
    pos[j] = min(static_cast<int>(__fmul_rn(u[k * kSample + j], nvf)), nv - 1);
    idx[j] = total > 0 ? order[pos[j]] : 0;
    samp[k * kSample + j] = idx[j];
  }
  bool twice = false;
#pragma unroll
  for (int i = 0; i < kSample; ++i)
#pragma unroll
    for (int j = i + 1; j < kSample; ++j) twice = twice || pos[i] == pos[j];
  dup[k] = twice;

  const Cam c = cams.load();
  float X[kSample][3], pu[kSample], pv[kSample], w[kSample];
#pragma unroll
  for (int s = 0; s < kSample; ++s) {
    const int i = idx[s];
#pragma unroll
    for (int j = 0; j < 3; ++j) X[s][j] = pts[3 * i + j];
    pu[s] = px[2 * i];
    pv[s] = px[2 * i + 1];
    w[s] = valid[i] ? 1.0f : 0.0f;
  }
  float P[12];
  if (k < n_dlt) {
    float nu[kSample], nw[kSample];
#pragma unroll
    for (int s = 0; s < kSample; ++s) {
      nu[s] = (pu[s] - c.cx) / c.fx;
      nw[s] = (pv[s] - c.cy) / c.fy;
    }
    dlt_pose(X, nu, nw, w, P);
  } else {  // four Gauss-Newton steps from T_init (or I), Huber 1e6
#pragma unroll
    for (int e = 0; e < 12; ++e) P[e] = (e == 0 || e == 4 || e == 8) ? 1.0f : 0.0f;
    if (T_init != nullptr) {
      const float* Ti = T_init + static_cast<size_t>(b) * 16;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) P[3 * i + j] = Ti[4 * i + j];
        P[9 + i] = Ti[4 * i + 3];
      }
    }
    for (int it = 0; it < 4; ++it) {
      float sums[kSums];
#pragma unroll
      for (int e = 0; e < kSums; ++e) sums[e] = 0.0f;
#pragma unroll
      for (int s = 0; s < kSample; ++s)
        gn_accumulate(P, c, X[s][0], X[s][1], X[s][2], pu[s], pv[s], w[s], 1e6f, sums);
      gn_update(sums, P);
    }
  }
#pragma unroll
  for (int e = 0; e < 12; ++e) T[e] = P[e];
}

// Stage 2: the MSAC score of every hypothesis, one warp each; inf where the
// sum is NaN or the samples repeat a point.
__global__ void __launch_bounds__(kScoreWarps * 32)
pnp_score_kernel(const float* __restrict__ pts, const float* __restrict__ px,
                 const uint8_t* __restrict__ valid, const float* __restrict__ weights,
                 const float* __restrict__ hyp, const uint8_t* __restrict__ dup, CamPtrs cams,
                 int n, int h, int hp, float thr2, float* __restrict__ msac) {
  const int b = blockIdx.y;
  const int k = blockIdx.x * kScoreWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (k >= hp) return;
  pts += static_cast<size_t>(b) * n * 3;
  px += static_cast<size_t>(b) * n * 2;
  valid += static_cast<size_t>(b) * n;
  if (weights != nullptr) weights += static_cast<size_t>(b) * n;
  const Cam c = cams.load();
  float T[12];
#pragma unroll
  for (int e = 0; e < 12; ++e) T[e] = hyp[(static_cast<size_t>(b) * hp + k) * 12 + e];
  float sum = 0.0f;
  for (int i = lane; i < n; i += 32) {
    const float e2 = reproj_err2(T, c, pts[3 * i], pts[3 * i + 1], pts[3 * i + 2], px[2 * i],
                                 px[2 * i + 1]);
    const float wi = weights != nullptr ? weights[i] : 1.0f;
    sum += (valid[i] ? clamp_max(e2, thr2) : 0.0f) * wi;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    const bool twice = k < h && dup[static_cast<size_t>(b) * h + k];
    msac[static_cast<size_t>(b) * hp + k] = (isnan(sum) || twice) ? INFINITY : sum;
  }
}

// Integer sums over the block (order-free), returned to every thread.
__device__ __forceinline__ int2 block_sum2(int2 v, int2* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, off);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, off);
  }
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // scratch is free
  if ((threadIdx.x & 31) == 0) scratch[warp] = v;
  __syncthreads();
  int2 total = make_int2(0, 0);
#pragma unroll
  for (int w = 0; w < kPolishWarps; ++w) {
    total.x += scratch[w].x;
    total.y += scratch[w].y;
  }
  return total;
}

// The inlier count of pose T over this thread's points; with `write`, also
// the flags.
__device__ __forceinline__ int count_inliers(const float* T, const Cam& c, const float* pts,
                                             const float* px, const uint8_t* valid, int n,
                                             float thr2, uint8_t* inliers, bool write) {
  int cnt = 0;
  for (int i = threadIdx.x; i < n; i += kPolishThreads) {
    const bool in = valid[i] && reproj_err2(T, c, pts[3 * i], pts[3 * i + 1], pts[3 * i + 2],
                                            px[2 * i], px[2 * i + 1]) <= thr2;
    cnt += in;
    if (write) inliers[i] = in;
  }
  return cnt;
}

// Stage 3: the first-lowest argmin, then two rounds of (polish -> recount
// -> keep if no fewer inliers), one block per sequence.
__global__ void __launch_bounds__(kPolishThreads)
pnp_polish_kernel(const float* __restrict__ pts, const float* __restrict__ px,
                  const uint8_t* __restrict__ valid, const float* __restrict__ weights,
                  const float* __restrict__ hyp, const float* __restrict__ msac, CamPtrs cams,
                  int n, int hp, float huber, float thr2, int refine_iters,
                  int32_t* __restrict__ best, float* __restrict__ T_out,
                  uint8_t* __restrict__ inliers,
                  int64_t* __restrict__ num_inliers, float* __restrict__ ratio,
                  uint8_t* __restrict__ ok) {
  __shared__ float red[kPolishWarps][kSums];
  __shared__ float best_v[kPolishWarps];
  __shared__ int best_i[kPolishWarps];
  __shared__ int2 isum[kPolishWarps];
  __shared__ float pose[12], ref[12];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  pts += static_cast<size_t>(b) * n * 3;
  px += static_cast<size_t>(b) * n * 2;
  valid += static_cast<size_t>(b) * n;
  inliers += static_cast<size_t>(b) * n;
  if (weights != nullptr) weights += static_cast<size_t>(b) * n;
  hyp += static_cast<size_t>(b) * hp * 12;
  msac += static_cast<size_t>(b) * hp;
  const Cam c = cams.load();

  // argmin, ties to the lowest index (torch.argmin); no score is NaN.
  float bv = INFINITY;
  int bi = hp;
  for (int k = tid; k < hp; k += kPolishThreads) {
    const float v = msac[k];
    if (v < bv || (v == bv && k < bi)) bv = v, bi = k;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (ov < bv || (ov == bv && oi < bi)) bv = ov, bi = oi;
  }
  if (lane == 0) best_v[warp] = bv, best_i[warp] = bi;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kPolishWarps; ++w)
      if (best_v[w] < bv || (best_v[w] == bv && best_i[w] < bi)) bv = best_v[w], bi = best_i[w];
    bi = min(bi, hp - 1);
    best[b] = bi;
#pragma unroll
    for (int e = 0; e < 12; ++e) pose[e] = hyp[static_cast<size_t>(bi) * 12 + e];
  }
  __syncthreads();

  int mine_valid = 0;
  for (int i = tid; i < n; i += kPolishThreads) mine_valid += valid[i] != 0;
  const int2 first = block_sum2(
      make_int2(count_inliers(pose, c, pts, px, valid, n, thr2, inliers, true), mine_valid),
      isum);
  int cnt_out = first.x;
  const int n_valid = first.y;

  for (int round = 0; round < 2; ++round) {
    if (tid < 12) ref[tid] = pose[tid];
    __syncthreads();
    for (int it = 0; it < refine_iters; ++it) {
      float sums[kSums];
#pragma unroll
      for (int e = 0; e < kSums; ++e) sums[e] = 0.0f;
      float T[12];
#pragma unroll
      for (int e = 0; e < 12; ++e) T[e] = ref[e];
      for (int i = tid; i < n; i += kPolishThreads) {
        const float wi = (inliers[i] ? 1.0f : 0.0f) * (weights != nullptr ? weights[i] : 1.0f);
        gn_accumulate(T, c, pts[3 * i], pts[3 * i + 1], pts[3 * i + 2], px[2 * i],
                      px[2 * i + 1], wi, huber, sums);
      }
#pragma unroll
      for (int e = 0; e < kSums; ++e) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sums[e] += __shfl_xor_sync(0xffffffffu, sums[e], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int e = 0; e < kSums; ++e) red[warp][e] = sums[e];
      }
      __syncthreads();
      if (tid == 0) {
        float total[kSums];
#pragma unroll
        for (int e = 0; e < kSums; ++e) {
          float s = red[0][e];
#pragma unroll
          for (int w = 1; w < kPolishWarps; ++w) s += red[w][e];
          total[e] = s;
        }
        gn_update(total, T);
#pragma unroll
        for (int e = 0; e < 12; ++e) ref[e] = T[e];
      }
      __syncthreads();
    }
    const int cnt_ref =
        block_sum2(make_int2(count_inliers(ref, c, pts, px, valid, n, thr2, inliers, false), 0),
                   isum).x;
    if (cnt_ref >= cnt_out) {  // the same on every thread
      count_inliers(ref, c, pts, px, valid, n, thr2, inliers, true);
      cnt_out = cnt_ref;
      __syncthreads();
      if (tid < 12) pose[tid] = ref[tid];
    }
    __syncthreads();
  }

  if (tid < 16) {
    const int i = tid >> 2, j = tid & 3;
    float v;
    if (i == 3) v = j == 3 ? 1.0f : 0.0f;
    else v = j == 3 ? pose[9 + i] : pose[3 * i + j];
    T_out[static_cast<size_t>(b) * 16 + tid] = v;
  }
  if (tid == 0) {
    num_inliers[b] = cnt_out;
    ratio[b] = static_cast<float>(cnt_out) / static_cast<float>(max(n_valid, 1));
    ok[b] = cnt_out >= kSample;
  }
}

}  // namespace

extern "C" int svo_ransac_pnp_batched(const float* pts, const float* px, const uint8_t* valid,
                                      const float* weights, const float* T_init,
                                      const float* u, const float* fx, const float* fy,
                                      const float* cx, const float* cy, int n, int h,
                                      int batch, float huber, float thr2,
                                      int refine_iters, int32_t* samp, uint8_t* dup,
                                      float* hyp, float* msac, int32_t* best, float* T_out,
                                      uint8_t* inliers, int64_t* num_inliers, float* ratio,
                                      uint8_t* ok, int device, void* stream) {
  if (batch == 0) return 0;
  const size_t smem = static_cast<size_t>(n) * sizeof(int32_t);
  if (n < 1 || h < 1 || batch < 0 || batch > 65535 || refine_iters < 0 ||
      smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  svo::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const int hp = h + (T_init != nullptr ? 1 : 0);
  const CamPtrs cams{fx, fy, cx, cy};
  const auto s = static_cast<cudaStream_t>(stream);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pnp_hypotheses_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  pnp_hypotheses_kernel<<<dim3((hp + kHypThreads - 1) / kHypThreads, batch), kHypThreads, smem,
                          s>>>(pts, px, valid, T_init, u, cams, n, h, hp, min(kMaxDlt, h), samp,
                               dup, hyp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pnp_score_kernel<<<dim3((hp + kScoreWarps - 1) / kScoreWarps, batch), kScoreWarps * 32, 0,
                     s>>>(pts, px, valid, weights, hyp, dup, cams, n, h, hp, thr2, msac);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pnp_polish_kernel<<<batch, kPolishThreads, 0, s>>>(pts, px, valid, weights, hyp, msac, cams, n,
                                                     hp, huber, thr2, refine_iters, best,
                                                     T_out, inliers, num_inliers, ratio, ok);
  return static_cast<int>(cudaGetLastError());
}
