// K5, K6 and K8: one pyramid level of Lucas-Kanade for N points on edge-padded
// (Hp, Wp) float32 level images, one warp per point.
//
// Replace the TPU kernels (archived variants and probes under scripts/)
//   K5  lk_pallas_block._make_kernel (scripts/lk_pallas_block.py:58-242,
//       pallas_call at :269), entry svo_lk_level_block: K3's function (cell
//       blend, 8 dots per pixel cell, scalar inner iterations);
//   K6  lk_pallas_v2._make_kernel (scripts/lk_pallas_v2.py:43-175,
//       pallas_call at :201), entry svo_lk_level_v2: K4's function (reload
//       and re-blend the (win+1)^2 window on every iteration, 2 dots);
//   K8  probe_lk_breakdown.variant_kernel (scripts/probe_lk_breakdown.py:
//       42-104, pallas_call at :111), entry svo_lk_block_split: K5 split into
//       `tmpl` (template phase only), `reload` (template, then `rounds`
//       forced window reloads with their 8 dots at corner
//       floor(p - r + round), no iterations) and `full` (= K5).
// The arithmetic per point is csrc/lk_level.cu's (K3/K4): the template T and
// its central-difference gradients from a (win+3)^2 window of `prev` blended
// at the point's fraction, the 2x2 normal matrix, the min-eigenvalue gate and
// its inverse; then the flow delta from the incoming guess until
// |delta|^2 <= eps2 or `iters` iterations. The JAX kernels advance BLK = 8
// points together as (8, 1) vectors; per point that is the same sequence of
// iterations, which is what is kept here. K8's `tmpl`/`reload` outputs are
// checksums: flow = (acc [+ the last round's first dot], acc), ok = acc, with
// acc = g00 + g01 + g11 + tIx + tIy, and every round's 8 dots go to `dots`
// (N, rounds, 8) so that no round can be dropped as dead code.
//
// What bounds it on Hopper: neither bytes nor flops (a level call at N=1024
// moves ~3 MB of distinct pixels and does ~50 MFLOP); the cost is each
// point's serial chain of reductions. K3/K4 spend two CTA barriers and a
// shared-memory round trip on every reduction of their 128-thread CTA. Here a
// warp owns a point, so:
//   * every reduction is a __shfl_xor_sync butterfly, after which every lane
//     holds bit-identical totals; each loop condition is then uniform within
//     the warp, and there is no __syncthreads() anywhere;
//   * __syncwarp() orders a warp's phases on its own slice of shared memory
//     (window buffer, template field, T, Ix, Iy: (win+3)^2 + (win+2)^2 +
//     3 win^2 floats, 9.7 KB at win = 21);
//   * the price: a lane handles ceil(441/32) = 14 window elements per
//     reduction, against 4 for K3/K4's 128 threads;
//   * kPointsPerCta = 4: 39 KB of shared memory per CTA (no opt-in above
//     48 KB at win = 21), and N = 1024 points make 256 CTAs that spread over
//     all 132 SMs at once (8 points would make 128 CTAs and leave 4 SMs
//     idle); a CTA holding a slow point keeps only 4 slices resident.
// The Mosaic shapes of the TPU kernels (aligned (8, 128) block loads plus two
// rolls, the (BLK*P, 128) scratch with iota masks, the SMEM scalar round
// trips, the N % 8 pad) are not the op and are dropped: callers' clips keep
// every window in bounds, so a window is a plain strided read, and any N
// works. IEEE floorf/sqrtf/division (no fast math). Clip bounds against the
// padded extents as in JAX: template hp-win-3 / wp-win-3, reload hp-win-1 /
// wp-win-1. Inactive points (active <= 0; K5 and K8 `full` only) return flow
// 0, ok 0, no iterations. Launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPointsPerCta = 4;
constexpr int kThreads = 32 * kPointsPerCta;
constexpr unsigned kWarp = 0xffffffffu;

// kCell: K5 (and K8 `full`); kIter: K6; kTmpl / kReload: K8's split variants.
enum Mode { kCell, kIter, kTmpl, kReload };

// Butterfly sums over the warp: every lane ends with the same totals (each
// step adds the same two values in either order).
template <int K>
__device__ __forceinline__ void warp_sum(float (&v)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_xor_sync(kWarp, v[k], off);
  }
}

__device__ __forceinline__ int floor_clip(float x, int hi) {
  return min(max(__float2int_rd(x), 0), hi);
}

__device__ __forceinline__ void load_window(const float* __restrict__ img, int wp,
                                            int r0, int c0, int side, float* dst,
                                            int lane) {
  for (int e = lane; e < side * side; e += 32) {
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

// The 8 dots of a (win+1)^2 window against the template gradients: its four
// corner sub-patches a..d against Ix, then against Iy.
__device__ __forceinline__ void cell_dots(const float* buf, const float* Ix,
                                          const float* Iy, int win, int lane,
                                          float (&s)[8]) {
  const int s1 = win + 1;
#pragma unroll
  for (int q = 0; q < 8; ++q) s[q] = 0.0f;
  for (int e = lane; e < win * win; e += 32) {
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
  warp_sum<8>(s);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
lk_block_kernel(const float* __restrict__ prev, const float* __restrict__ next,
                int hp, int wp, const float* __restrict__ pts,
                const float* __restrict__ guess, const float* __restrict__ active,
                int n, int win, int iters, float eps2, float min_eig, int pad,
                int rounds, float* __restrict__ flow, float* __restrict__ ok_out,
                int32_t* __restrict__ stats, float* __restrict__ dots) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = blockIdx.x * kPointsPerCta + warp;
  if (k >= n) return;  // the whole warp: nothing waits on it
  constexpr bool kTracks = kMode == kCell || kMode == kIter;
  if (kTracks && !(active[k] > 0.0f)) {
    if (lane == 0) {
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
  float* buf = smem + static_cast<size_t>(warp) * (s3 * s3 + s2 * s2 + 3 * ww);
  float* field = buf + s3 * s3;   // (win+2)^2 blended template field
  float* T = field + s2 * s2;     // win^2 each
  float* Ix = T + ww;
  float* Iy = Ix + ww;

  // ---- template phase ------------------------------------------------- //
  const float py = pts[2 * k + 1] + static_cast<float>(pad);
  const float px = pts[2 * k] + static_cast<float>(pad);
  const float tbr = py - rf - 1.0f;
  const float tbc = px - rf - 1.0f;
  const int tr0 = floor_clip(tbr, hp - win - 3);
  const int tc0 = floor_clip(tbc, wp - win - 3);
  const float tfy = tbr - static_cast<float>(tr0);
  const float tfx = tbc - static_cast<float>(tc0);
  load_window(prev, wp, tr0, tc0, s3, buf, lane);
  __syncwarp();
  for (int e = lane; e < s2 * s2; e += 32) {
    const int i = e / s2;
    field[e] = blend(buf, s3, i, e - i * s2, tfy, tfx);
  }
  __syncwarp();
  float g[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // g00 g01 g11 tIx tIy
  for (int e = lane; e < ww; e += 32) {
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
  warp_sum<5>(g);
  __syncwarp();  // T, Ix, Iy visible to the whole warp; buf free again
  const float g00 = g[0], g01 = g[1], g11 = g[2], tIx = g[3], tIy = g[4];

  if constexpr (kMode == kTmpl || kMode == kReload) {
    const float acc = g00 + g01 + g11 + tIx + tIy;
    float extra = 0.0f;
    if constexpr (kMode == kReload) {
      for (int rd = 0; rd < rounds; ++rd) {
        const int iy = floor_clip(py - rf + static_cast<float>(rd), hp - win - 1);
        const int ix = floor_clip(px - rf + static_cast<float>(rd), wp - win - 1);
        __syncwarp();  // the last round's reads of buf are done
        load_window(next, wp, iy, ix, s1, buf, lane);
        __syncwarp();
        float s[8];
        cell_dots(buf, Ix, Iy, win, lane, s);
        if (lane == 0) {
#pragma unroll
          for (int q = 0; q < 8; ++q) dots[(static_cast<size_t>(k) * rounds + rd) * 8 + q] = s[q];
        }
        extra = s[0];
      }
    }
    if (lane == 0) {
      flow[2 * k] = acc + extra;
      flow[2 * k + 1] = acc;
      ok_out[k] = acc;
    }
    return;
  }

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
  while (running && it < iters) {  // uniform: warp totals only
    const float br = py + gy0 + vy - rf;
    const float bc = px + gx0 + vx - rf;
    const int iy = floor_clip(br, hp - win - 1);
    const int ix = floor_clip(bc, wp - win - 1);
    __syncwarp();  // the last reads of buf are done
    load_window(next, wp, iy, ix, s1, buf, lane);
    __syncwarp();
    ++reloads;
    if constexpr (kMode == kCell) {
      float s[8];
      cell_dots(buf, Ix, Iy, win, lane, s);
      const float iyf = static_cast<float>(iy), ixf = static_cast<float>(ix);
      bool stay = true;
      while (running && it < iters && stay) {
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
      for (int e = lane; e < ww; e += 32) {
        const int i = e / win;
        const float rd = T[e] - blend(buf, s1, i, e - i * win, fy, fx);
        s[0] += rd * Ix[e];
        s[1] += rd * Iy[e];
      }
      warp_sum<2>(s);
      const float dx = inv00 * s[0] + inv01 * s[1];
      const float dy = inv01 * s[0] + inv11 * s[1];
      vx += dx;
      vy += dy;
      running = dx * dx + dy * dy > eps2;
      ++it;
    }
  }
  if (lane == 0) {
    flow[2 * k] = vx;
    flow[2 * k + 1] = vy;
    ok_out[k] = ok ? 1.0f : 0.0f;
    stats[2 * k] = it;
    stats[2 * k + 1] = reloads;
  }
}

template <int kMode>
int launch(const float* prev, const float* next, int hp, int wp, const float* pts,
           const float* guess, const float* active, int n, int win, int iters,
           float eps2, float min_eig, int pad, int rounds, float* flow, float* ok,
           int32_t* stats, float* dots, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const size_t per_point = static_cast<size_t>((win + 3) * (win + 3) +
                                               (win + 2) * (win + 2) + 3 * win * win);
  const size_t smem = kPointsPerCta * per_point * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(lk_block_kernel<kMode>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n + kPointsPerCta - 1) / kPointsPerCta;
  lk_block_kernel<kMode><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      prev, next, hp, wp, pts, guess, active, n, win, iters, eps2, min_eig, pad, rounds,
      flow, ok, stats, dots);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int svo_lk_level_block(const float* prev, const float* next, int hp, int wp,
                                  const float* pts, const float* guess,
                                  const float* active, int n, int win, int iters,
                                  float eps2, float min_eig, int pad, float* flow,
                                  float* ok, int32_t* stats, int device, void* stream) {
  return launch<kCell>(prev, next, hp, wp, pts, guess, active, n, win, iters, eps2,
                       min_eig, pad, 0, flow, ok, stats, nullptr, device, stream);
}

extern "C" int svo_lk_level_v2(const float* prev, const float* next, int hp, int wp,
                               const float* pts, const float* guess,
                               const float* active, int n, int win, int iters,
                               float eps2, float min_eig, int pad, float* flow,
                               float* ok, int32_t* stats, int device, void* stream) {
  return launch<kIter>(prev, next, hp, wp, pts, guess, active, n, win, iters, eps2,
                       min_eig, pad, 0, flow, ok, stats, nullptr, device, stream);
}

// mode: 0 `full` (K5 on these inputs), 1 `tmpl`, 2 `reload` (rounds >= 1).
extern "C" int svo_lk_block_split(const float* prev, const float* next, int hp, int wp,
                                  const float* pts, const float* guess,
                                  const float* active, int n, int win, int iters,
                                  float eps2, float min_eig, int pad, float* flow,
                                  float* ok, int32_t* stats, int mode, int rounds,
                                  float* dots, int device, void* stream) {
  switch (mode) {
    case 0:
      return launch<kCell>(prev, next, hp, wp, pts, guess, active, n, win, iters, eps2,
                           min_eig, pad, 0, flow, ok, stats, nullptr, device, stream);
    case 1:
      return launch<kTmpl>(prev, next, hp, wp, pts, guess, active, n, win, iters, eps2,
                           min_eig, pad, 0, flow, ok, stats, nullptr, device, stream);
    case 2:
      if (rounds < 1) return static_cast<int>(cudaErrorInvalidValue);
      return launch<kReload>(prev, next, hp, wp, pts, guess, active, n, win, iters,
                             eps2, min_eig, pad, rounds, flow, ok, stats, dots, device,
                             stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
