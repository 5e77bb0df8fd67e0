// K3 and K4: one pyramid level of Lucas-Kanade for N points on edge-padded
// (Hp, Wp) float32 level images, one CTA per point.
//
// Replace the TPU kernels
//   K3  lk_pallas_cell._make_kernel (stereo_visual_odometry_tpu/ops/
//       lk_pallas_cell.py:48-198, pallas_call at :223), entry svo_lk_level_cell;
//   K4  lk_pallas._make_kernel (stereo_visual_odometry_tpu/ops/lk_pallas.py:
//       46-157, pallas_call at :195), entry svo_lk_level_v1.
// Both compute, per active point: the template T and its central-difference
// gradients Ix, Iy from a (win+3)^2 window of `prev` blended at the point's
// fraction, the 2x2 normal matrix, the min-eigenvalue gate and its inverse;
// then iterate the flow delta from the incoming guess until |delta| <= eps or
// `iters` iterations. K4 reloads and re-blends a (win+1)^2 window of `next`
// on every iteration and takes 2 dot products. K3 reloads only when the
// point enters another pixel cell: with the integer corner fixed, the
// right-hand side is bilinear in the fraction, so 8 dots per cell (the four
// corner sub-patches a..d against Ix and Iy) feed a scalar inner loop. The
// output is the delta (vx, vy), the gate as 0/1, and per point the
// iterations and the window reloads taken.
//
// What bounds it on Hopper: neither bytes nor flops. At N=1024 on a
// 384x1280 level a call moves ~3 MB of distinct pixels (~1 us at 3.35 TB/s)
// and does ~50 MFLOP; the cost is the serial chain of each point's
// iterations (block reductions and barriers), so the design spreads the
// points over the SMs, one 128-thread CTA each, with the windows and the
// template in shared memory:
//   * every block reduction ends with all threads holding the same totals
//     (summed over the warps in one fixed order), so each loop decision is
//     the same in every thread and every __syncthreads() is reached by the
//     whole CTA;
//   * K3's inner iteration is ~20 scalar ops, computed redundantly by every
//     thread from those shared totals, with no barrier;
//   * the Mosaic shapes of the TPU kernels (aligned (8, 128) block loads plus
//     two rolls, BLK=8 points per program, the stacked-image batch rule) are
//     not the op and are dropped: callers clip every corner in bounds, so a
//     window is a plain strided read.
// IEEE floorf/sqrtf/division (no fast math): the gates compare against
// thresholds. Contract as the JAX kernels: corners clipped against the padded
// extents; inactive points (active <= 0) return flow 0, ok 0 at once. No
// convergence gate: a point still iterating after `iters` keeps its ok.
// Launches on the caller's stream, allocates nothing, does not synchronise,
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSums = 8;

// Sum K per-thread values over the CTA. Every thread returns with the same
// totals: lane 0 of each warp publishes its warp's sum, and every thread adds
// the warps' sums in the same order.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float x = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    if (lane == 0) red[warp * kMaxSums + k] = x;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = red[k];
    for (int w = 1; w < kWarps; ++w) s += red[w * kMaxSums + k];
    v[k] = s;
  }
  __syncthreads();  // red is free again
}

__device__ __forceinline__ int floor_clip(float x, int hi) {
  return min(max(__float2int_rd(x), 0), hi);
}

__device__ __forceinline__ void load_window(const float* __restrict__ img, int wp,
                                            int r0, int c0, int side, float* dst) {
  for (int e = threadIdx.x; e < side * side; e += kThreads) {
    const int i = e / side;
    const int j = e - i * side;
    dst[e] = __ldg(img + static_cast<size_t>(r0 + i) * wp + (c0 + j));
  }
}

// The 4-tap blend of a window at (i, j), in the JAX kernels' order.
__device__ __forceinline__ float blend(const float* w, int side, int i, int j,
                                       float fy, float fx) {
  const float a = w[i * side + j], b = w[i * side + j + 1];
  const float c = w[(i + 1) * side + j], d = w[(i + 1) * side + j + 1];
  return a * (1.0f - fy) * (1.0f - fx) + b * (1.0f - fy) * fx +
         c * fy * (1.0f - fx) + d * fy * fx;
}

template <bool kCell>
__global__ void __launch_bounds__(kThreads)
lk_level_kernel(const float* __restrict__ prev, const float* __restrict__ next,
                int hp, int wp, const float* __restrict__ pts,
                const float* __restrict__ guess, const float* __restrict__ active,
                int win, int iters, float eps2, float min_eig, int pad,
                float* __restrict__ flow, float* __restrict__ ok_out,
                int32_t* __restrict__ stats) {
  extern __shared__ float smem[];
  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  if (!(active[k] > 0.0f)) {
    if (tid == 0) {
      flow[2 * k] = 0.0f;
      flow[2 * k + 1] = 0.0f;
      ok_out[k] = 0.0f;
      stats[2 * k] = 0;
      stats[2 * k + 1] = 0;
    }
    return;
  }
  const int r = (win - 1) / 2;
  const float rf = static_cast<float>(r);
  const int s3 = win + 3, s2 = win + 2, s1 = win + 1, ww = win * win;
  float* buf = smem;              // (win+3)^2: template window, then next windows
  float* field = buf + s3 * s3;   // (win+2)^2 blended template field
  float* T = field + s2 * s2;     // win^2 each
  float* Ix = T + ww;
  float* Iy = Ix + ww;
  float* red = Iy + ww;           // kWarps * kMaxSums

  // ---- template phase ------------------------------------------------- //
  const float py = pts[2 * k + 1] + static_cast<float>(pad);
  const float px = pts[2 * k] + static_cast<float>(pad);
  const float tbr = py - rf - 1.0f;
  const float tbc = px - rf - 1.0f;
  const int tr0 = floor_clip(tbr, hp - win - 3);
  const int tc0 = floor_clip(tbc, wp - win - 3);
  const float tfy = tbr - static_cast<float>(tr0);
  const float tfx = tbc - static_cast<float>(tc0);
  load_window(prev, wp, tr0, tc0, s3, buf);
  __syncthreads();
  for (int e = tid; e < s2 * s2; e += kThreads) {
    const int i = e / s2;
    field[e] = blend(buf, s3, i, e - i * s2, tfy, tfx);
  }
  __syncthreads();
  float g[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // g00 g01 g11 tIx tIy
  for (int e = tid; e < ww; e += kThreads) {
    const int i = e / win;
    const int j = e - i * win;
    const float t = field[(i + 1) * s2 + j + 1];
    const float gx = (field[(i + 1) * s2 + j + 2] - field[(i + 1) * s2 + j]) * 0.5f;
    const float gy = (field[(i + 2) * s2 + j + 1] - field[i * s2 + j + 1]) * 0.5f;
    T[e] = t;
    Ix[e] = gx;
    Iy[e] = gy;
    g[0] += gx * gx;
    g[1] += gx * gy;
    g[2] += gy * gy;
    g[3] += t * gx;
    g[4] += t * gy;
  }
  block_sum<5>(g, red);  // its barriers also publish T, Ix, Iy
  const float g00 = g[0], g01 = g[1], g11 = g[2], tIx = g[3], tIy = g[4];
  const float det = g00 * g11 - g01 * g01;
  const float trc = g00 + g11;
  const float mev = (trc - sqrtf(fmaxf(trc * trc - 4.0f * det, 0.0f))) * 0.5f /
                    static_cast<float>(ww);
  const bool ok = mev > min_eig;
  const float safe_det = fabsf(det) < 1e-12f ? 1.0f : det;
  const float inv00 = g11 / safe_det;
  const float inv01 = -g01 / safe_det;
  const float inv11 = g00 / safe_det;

  // ---- iterations ----------------------------------------------------- //
  const float gy0 = guess[2 * k + 1];
  const float gx0 = guess[2 * k];
  float vy = 0.0f, vx = 0.0f;
  bool running = ok;
  int it = 0, reloads = 0;
  while (running && it < iters) {
    const float br = py + gy0 + vy - rf;
    const float bc = px + gx0 + vx - rf;
    const int iy = floor_clip(br, hp - win - 1);
    const int ix = floor_clip(bc, wp - win - 1);
    load_window(next, wp, iy, ix, s1, buf);  // the last reads of buf were
    __syncthreads();                         // before block_sum's barriers
    ++reloads;
    if (kCell) {
      float s[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int e = tid; e < ww; e += kThreads) {
        const int i = e / win;
        const int j = e - i * win;
        const float a = buf[i * s1 + j], b = buf[i * s1 + j + 1];
        const float c = buf[(i + 1) * s1 + j], d = buf[(i + 1) * s1 + j + 1];
        const float gx = Ix[e], gy = Iy[e];
        s[0] += a * gx;
        s[1] += b * gx;
        s[2] += c * gx;
        s[3] += d * gx;
        s[4] += a * gy;
        s[5] += b * gy;
        s[6] += c * gy;
        s[7] += d * gy;
      }
      block_sum<8>(s, red);
      const float iyf = static_cast<float>(iy), ixf = static_cast<float>(ix);
      bool stay = true;
      while (running && it < iters && stay) {  // uniform: shared totals only
        const float fy = (py + gy0 + vy - rf) - iyf;
        const float fx = (px + gx0 + vx - rf) - ixf;
        const float wy0 = 1.0f - fy, wx0 = 1.0f - fx;
        const float wIx = wy0 * wx0 * s[0] + wy0 * fx * s[1] + fy * wx0 * s[2] +
                          fy * fx * s[3];
        const float wIy = wy0 * wx0 * s[4] + wy0 * fx * s[5] + fy * wx0 * s[6] +
                          fy * fx * s[7];
        const float b0 = tIx - wIx, b1 = tIy - wIy;
        const float dx = inv00 * b0 + inv01 * b1;
        const float dy = inv01 * b0 + inv11 * b1;
        vx += dx;
        vy += dy;
        running = dx * dx + dy * dy > eps2;
        stay = floor_clip(py + gy0 + vy - rf, hp - win - 1) == iy &&
               floor_clip(px + gx0 + vx - rf, wp - win - 1) == ix;
        ++it;
      }
    } else {
      const float fy = br - static_cast<float>(iy);
      const float fx = bc - static_cast<float>(ix);
      float s[2] = {0.0f, 0.0f};
      for (int e = tid; e < ww; e += kThreads) {
        const int i = e / win;
        const float rd = T[e] - blend(buf, s1, i, e - i * win, fy, fx);
        s[0] += rd * Ix[e];
        s[1] += rd * Iy[e];
      }
      block_sum<2>(s, red);
      const float dx = inv00 * s[0] + inv01 * s[1];
      const float dy = inv01 * s[0] + inv11 * s[1];
      vx += dx;
      vy += dy;
      running = dx * dx + dy * dy > eps2;
      ++it;
    }
  }
  if (tid == 0) {
    flow[2 * k] = vx;
    flow[2 * k + 1] = vy;
    ok_out[k] = ok ? 1.0f : 0.0f;
    stats[2 * k] = it;
    stats[2 * k + 1] = reloads;
  }
}

template <bool kCell>
int launch(const float* prev, const float* next, int hp, int wp, const float* pts,
           const float* guess, const float* active, int n, int win, int iters,
           float eps2, float min_eig, int pad, float* flow, float* ok,
           int32_t* stats, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const size_t floats = static_cast<size_t>((win + 3) * (win + 3) + (win + 2) * (win + 2) +
                                            3 * win * win + kWarps * kMaxSums);
  const size_t smem = floats * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(lk_level_kernel<kCell>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lk_level_kernel<kCell><<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      prev, next, hp, wp, pts, guess, active, win, iters, eps2, min_eig, pad, flow, ok,
      stats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int svo_lk_level_cell(const float* prev, const float* next, int hp, int wp,
                                 const float* pts, const float* guess,
                                 const float* active, int n, int win, int iters,
                                 float eps2, float min_eig, int pad, float* flow,
                                 float* ok, int32_t* stats, int device, void* stream) {
  return launch<true>(prev, next, hp, wp, pts, guess, active, n, win, iters, eps2,
                      min_eig, pad, flow, ok, stats, device, stream);
}

extern "C" int svo_lk_level_v1(const float* prev, const float* next, int hp, int wp,
                               const float* pts, const float* guess,
                               const float* active, int n, int win, int iters,
                               float eps2, float min_eig, int pad, float* flow,
                               float* ok, int32_t* stats, int device, void* stream) {
  return launch<false>(prev, next, hp, wp, pts, guess, active, n, win, iters, eps2,
                       min_eig, pad, flow, ok, stats, device, stream);
}
