// K5, K6 and K8: one pyramid level of Lucas-Kanade for N points on edge-padded
// (Hp, Wp) float32 level images, one warp per point, in one kernel with staged
// regions (lk_block_cell_kernel).
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
//       `tmpl` (the template phase only), `reload` (the template, then
//       `rounds` forced window reloads with their 8 dots at corner
//       floor(p - r + round), no iterations) and `full`, which the TPU probe
//       builds with K5's own factory (probe_lk_breakdown.py:44-46): here K5's
//       kernel with the raw tail below.
// The arithmetic per point is csrc/lk_level.cu's (K3/K4): the template and
// its central-difference gradients from a (win+3)^2 window of `prev` blended
// at the point's fraction, the 2x2 normal matrix, the min-eigenvalue gate and
// its inverse; then the flow delta from the incoming guess until
// |delta|^2 <= eps2 or `iters` iterations. The JAX kernels advance BLK = 8
// points together as (8, 1) vectors; per point that is the same sequence of
// iterations, which is what is kept here.
//
// What bounds it on Hopper: neither bytes nor flops (a level call at N=1024
// moves ~3 MB of distinct pixels and does ~50 MFLOP); the 1024 points fit
// the 132 SMs in one wave, so a call lasts as long as its slowest point's
// serial chain of window reads and reductions. A warp owns a point, so every
// reduction is a __shfl_xor_sync butterfly after which every lane holds
// bit-identical totals (each step adds the same two values in either order):
// each loop condition is uniform within the warp, there is no
// __syncthreads() anywhere, and __syncwarp() orders a warp's phases on its
// own slice of shared memory. The price: a lane handles ceil(441/32) = 14
// window elements per reduction, against 7 for K3/K4's two warps.
//
// What the design does about the chain (K3's, csrc/lk_level.cu):
//   * staged regions: each warp issues one round of 4-byte cp.async copies
//     for the (win+3)^2 template window of `prev` and a region of `next` of
//     (win+1+2*kMargin)^2 pixels around the window at the guess (K3's
//     kMargin = 7: 36^2 at win 21), so the two device-memory latencies
//     overlap and are paid once. A later window inside the region is read in
//     place; one that leaves it is read from device memory into the
//     template's buffer, each lane's loads issued together (read_window), so
//     that a reload off the region costs one device-memory latency. The
//     pixels are the same either way, so are the values;
//   * per point the gradients as float2 (one 8-byte read per element and
//     reload), the (win+3)^2 window buffer, the region and the (win+2)^2
//     template field: 13.1 KB at win 21. K6 also keeps the template T
//     (win^2 floats, 14.9 KB at win 21): its residual T - blend(w) needs T
//     at every iteration, where K5 sums T's dots once in the template phase
//     (T, Ix, Iy as one float4 measured 14% slower on the bench frames' level
//     calls). 2 points per CTA for both (K5: 2 beat 4 by ~7% there; K6: 2 and
//     1 within 1%, 4 ~20% slower; PERF.md), with the opt-in above 48 KB for
//     larger windows;
//   * element loops walk their (i, j) with svo::Walk, no division per
//     element; the dot loops are unrolled (K5's by 4, K6's by 8: 3-4% off
//     K6's level calls) so that a lane's shared-memory reads overlap. What
//     is left of a long chain is instruction count: a lane's 14 elements of ~25
//     instructions each per reload, twice K4's 7 per thread, so K6 loses to
//     K4 where a call's slowest point runs 30 iterations (PERF.md);
//   * the tail of the JAX wrappers in the kernel, as K3's: flow = guess +
//     delta, ok = gate && |delta| <= search_radius on both axes, `active` read
//     as the caller's bool bytes (null: all active), the statistics written
//     only when `stats` is not null. A level call of K5 or K6 is one node.
// The bodies (Body, a template parameter) share the staging, the template
// phase and one loop of window reads: K5's cell iterations (kCell), K4's
// per-iteration step (kIter: the blend and the two sums in K4's order of
// operations), and K8's `tmpl` (no loop) and `reload`, whose `rounds` are the
// loop's iterations, each K5's window read and 8-dot pass at the forced
// corner (with zero guesses these lie in the staged region, as 94% of K5's
// reloads do on the bench frames). K8 launches with the raw tail: `full`
// writes flow = delta and ok = the gate as 0/1 float32 for every point;
// `tmpl`/`reload` write checksums, flow = (acc [+ the last round's first
// dot], acc) and ok = acc with acc = g00 + g01 + g11 + tIx + tIy, and every
// round's 8 dots to `dots` (N, rounds, 8) so that no round can be dropped as
// dead code. A null `guess` means zero guesses.
//
// The Mosaic shapes of the TPU kernels (aligned (8, 128) block loads plus two
// rolls, the (BLK*P, 128) scratch with iota masks, the SMEM scalar round
// trips, the N % 8 pad) are not the op and are dropped: callers' clips keep
// every window in bounds, so a window is a plain strided read, and any N
// works. IEEE floorf/sqrtf/division (no fast math). Clip bounds against the
// padded extents as in JAX: template hp-win-3 / wp-win-3, reload hp-win-1 /
// wp-win-1. Inactive points return delta 0 (flow = guess), ok 0, no
// iterations. Launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "patch_common.cuh"

namespace {

constexpr unsigned kWarp = 0xffffffffu;
constexpr int kMargin = 7;  // px of `next` staged around the window at the guess
constexpr int kCellPointsPerCta = 2;
constexpr int kIterPointsPerCta = 2;

// What a launch computes after the staging and the template phase.
enum Body {
  kCell,    // K5 (and K8 `full`): K3's cell iterations
  kIter,    // K6: K4's per-iteration step
  kTmpl,    // K8 `tmpl`: the checksums of the template phase
  kReload,  // K8 `reload`: `rounds` forced reloads with their 8 dots
};

__host__ __device__ constexpr int points_per_cta(int body) {
  return body == kIter ? kIterPointsPerCta : kCellPointsPerCta;
}

// Floats of one point's slice: the win^2 gradients (Ix, Iy) as float2, K6's
// template T (win^2), the (win+3)^2 window buffer, the region of `next` and
// the (win+2)^2 template field, rounded up to keep every slice's float2s
// 8-byte aligned.
__host__ __device__ constexpr int slice_floats(int body, int win) {
  return ((body == kIter ? 3 : 2) * win * win + (win + 3) * (win + 3) +
          (win + 1 + 2 * kMargin) * (win + 1 + 2 * kMargin) + (win + 2) * (win + 2) + 1) &
         ~1;
}

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

// The 4-tap blend of a window (row stride `side`) at (i, j), in the JAX
// kernels' order.
__device__ __forceinline__ float blend(const float* w, int side, int i, int j,
                                       float fy, float fx) {
  const float a = w[i * side + j], b = w[i * side + j + 1];
  const float c = w[(i + 1) * side + j], d = w[(i + 1) * side + j + 1];
  return a * (1.0f - fy) * (1.0f - fx) + b * (1.0f - fy) * fx +
         c * fy * (1.0f - fx) + d * fy * fx;
}

__device__ __forceinline__ void copy_async4(float* smem_dst, const float* src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
}

// This lane's copies of img[r0:r0+rows, c0:c0+cols] into dst (row-major,
// `cols` wide); the caller commits and waits.
__device__ __forceinline__ void stage(const float* __restrict__ img, int wp, int r0, int c0,
                                      int rows, int cols, float* dst, int lane) {
  svo::Walk at(lane, 32, rows, cols);
  for (int e = lane; e < rows * cols; e += 32, at.advance())
    copy_async4(dst + e, img + static_cast<size_t>(r0 + at.i) * wp + (c0 + at.j));
}

// This lane's share of the (side)^2 window at (r0, c0) of img, plain loads,
// kReadBatch of them issued before any is stored: one device-memory latency
// per batch rather than per element (16 covers a lane's share of a 22^2
// window at win 21).
constexpr int kReadBatch = 16;
__device__ __forceinline__ void read_window(const float* __restrict__ img, int wp, int r0,
                                            int c0, int side, float* dst, int lane) {
  const int total = side * side;
  svo::Walk at(lane, 32, side, side);
  for (int e0 = lane; e0 < total; e0 += 32 * kReadBatch) {
    float v[kReadBatch];
#pragma unroll
    for (int u = 0; u < kReadBatch; ++u, at.advance())
      if (e0 + 32 * u < total)
        v[u] = __ldg(img + static_cast<size_t>(r0 + at.i) * wp + (c0 + at.j));
#pragma unroll
    for (int u = 0; u < kReadBatch; ++u)
      if (e0 + 32 * u < total) dst[e0 + 32 * u] = v[u];
  }
}

template <bool kFinish>
using OkOut = std::conditional_t<kFinish, bool, float>;

// kFinish: the JAX wrappers' tail (flow = guess + delta, ok as bool with the
// radius test); else K8's raw tail (see the note at the top).
template <int kBody, bool kFinish>
__global__ void __launch_bounds__(32 * points_per_cta(kBody))
lk_block_cell_kernel(const float* __restrict__ prev, const float* __restrict__ next,
                     int hp, int wp, const float* __restrict__ pts,
                     const float* __restrict__ guess, const uint8_t* __restrict__ active,
                     int n, int win, int iters, float eps2, float min_eig, int pad,
                     float radius, float* __restrict__ flow,
                     OkOut<kFinish>* __restrict__ ok_out, int32_t* __restrict__ stats,
                     float* __restrict__ dots) {
  constexpr bool kSplit = kBody == kTmpl || kBody == kReload;
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = blockIdx.x * points_per_cta(kBody) + warp;
  if (k >= n) return;  // the whole warp: nothing waits on it
  const float gy0 = guess == nullptr ? 0.0f : guess[2 * k + 1];
  const float gx0 = guess == nullptr ? 0.0f : guess[2 * k];
  float vy = 0.0f, vx = 0.0f;
  float acc = 0.0f, extra = 0.0f;  // K8 tmpl/reload: the checksums
  bool ok = false;
  int it = 0, reloads = 0;
  if (active == nullptr || active[k] != 0) {
    const int r = (win - 1) / 2;
    const float rf = static_cast<float>(r);
    const int s3 = win + 3, s2 = win + 2, s1 = win + 1, ww = win * win;
    const int side = s1 + 2 * kMargin;
    const int rh = min(side, hp), rw = min(side, wp);
    float* slice = smem + static_cast<size_t>(warp) * slice_floats(kBody, win);
    float2* grad = reinterpret_cast<float2*>(slice);  // win^2 (Ix, Iy)
    float* T = slice + 2 * ww;                          // win^2, K6 only
    float* buf = T + (kBody == kIter ? ww : 0);         // (win+3)^2
    float* region = buf + s3 * s3;        // rh x rw pixels of `next` around the guess
    float* field = region + side * side;  // (win+2)^2 blended template field

    // ---- staging: the template window and the region, one round -------- //
    const float py = pts[2 * k + 1] + static_cast<float>(pad);
    const float px = pts[2 * k] + static_cast<float>(pad);
    const float tbr = py - rf - 1.0f;
    const float tbc = px - rf - 1.0f;
    const int tr0 = floor_clip(tbr, hp - win - 3);
    const int tc0 = floor_clip(tbc, wp - win - 3);
    const float tfy = tbr - static_cast<float>(tr0);
    const float tfx = tbc - static_cast<float>(tc0);
    const int ry0 = min(max(floor_clip(py + gy0 - rf, hp - win - 1) - kMargin, 0), hp - rh);
    const int rx0 = min(max(floor_clip(px + gx0 - rf, wp - win - 1) - kMargin, 0), wp - rw);
    stage(prev, wp, tr0, tc0, s3, s3, buf, lane);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    stage(next, wp, ry0, rx0, rh, rw, region, lane);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // the template window
    __syncwarp();

    // ---- template phase ----------------------------------------------- //
    {
      svo::Walk at(lane, 32, s2, s2);
      for (int e = lane; e < s2 * s2; e += 32, at.advance())
        field[e] = blend(buf, s3, at.i, at.j, tfy, tfx);
    }
    __syncwarp();
    const svo::Walk w0(lane, 32, win, win);  // this lane's first (i, j)
    float g[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // g00 g01 g11 tIx tIy
    {
      svo::Walk at = w0;
      for (int e = lane; e < ww; e += 32, at.advance()) {
        const float* f = field + (at.i + 1) * s2 + at.j + 1;
        const float t = f[0];
        const float gx = (f[1] - f[-1]) * 0.5f;
        const float gy = (f[s2] - f[-s2]) * 0.5f;
        grad[e] = make_float2(gx, gy);
        if constexpr (kBody == kIter) T[e] = t;
        g[0] += gx * gx;
        g[1] += gx * gy;
        g[2] += gy * gy;
        g[3] += t * gx;
        g[4] += t * gy;
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // the region
    warp_sum<5>(g);
    __syncwarp();  // the gradients, T and the region visible to the whole warp
    const float g00 = g[0], g01 = g[1], g11 = g[2], tIx = g[3], tIy = g[4];

    const float det = g00 * g11 - g01 * g01;
    const float trc = g00 + g11;
    const float mev = (trc - sqrtf(fmaxf(trc * trc - 4.0f * det, 0.0f))) * 0.5f /
                      static_cast<float>(ww);
    ok = mev > min_eig;
    const float safe_det = fabsf(det) < 1e-12f ? 1.0f : det;
    const float inv00 = g11 / safe_det;
    const float inv01 = -g01 / safe_det;
    const float inv11 = g00 / safe_det;
    if constexpr (kSplit) acc = g00 + g01 + g11 + tIx + tIy;

    // ---- iterations (K8 `reload`: its rounds) ------------------------- //
    bool running = kBody == kReload || (kBody != kTmpl && ok);
    while (running && it < iters) {  // uniform: warp totals only
      // The window's corner before the clip: at the point's flow, or (a
      // forced round) at floor(p - r + round) whatever the flow.
      const float by = kBody == kReload ? py - rf + static_cast<float>(it) : py + gy0 + vy - rf;
      const float bx = kBody == kReload ? px - rf + static_cast<float>(it) : px + gx0 + vx - rf;
      const int iy = floor_clip(by, hp - win - 1);
      const int ix = floor_clip(bx, wp - win - 1);
      // The window: in place in the region, or read into buf.
      const float* w = buf;
      int ws = s1;
      if (iy >= ry0 && iy + s1 <= ry0 + rh && ix >= rx0 && ix + s1 <= rx0 + rw) {
        w = region + (iy - ry0) * rw + (ix - rx0);
        ws = rw;
      } else {
        __syncwarp();  // the last reads of buf are done
        read_window(next, wp, iy, ix, s1, buf, lane);
        __syncwarp();
      }
      ++reloads;
      if constexpr (kBody == kIter) {
        // K4's step: the residual T - blend(w) at the point's fraction
        // against Ix and Iy.
        const float fy = by - static_cast<float>(iy);
        const float fx = bx - static_cast<float>(ix);
        float s[2] = {0.0f, 0.0f};
        svo::Walk at = w0;
#pragma unroll 8
        for (int e = lane; e < ww; e += 32, at.advance()) {
          const float rd = T[e] - blend(w, ws, at.i, at.j, fy, fx);
          const float2 gr = grad[e];
          s[0] += rd * gr.x;
          s[1] += rd * gr.y;
        }
        warp_sum<2>(s);
        const float dx = inv00 * s[0] + inv01 * s[1];
        const float dy = inv01 * s[0] + inv11 * s[1];
        vx += dx;
        vy += dy;
        running = dx * dx + dy * dy > eps2;
        ++it;
      } else {
        // The 8 dots of the window: its four corner sub-patches a..d
        // against Ix, then against Iy.
        float s[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        {
          svo::Walk at = w0;
#pragma unroll 4
          for (int e = lane; e < ww; e += 32, at.advance()) {
            const float* q = w + at.i * ws + at.j;
            const float a = q[0], b = q[1], c = q[ws], d = q[ws + 1];
            const float2 gr = grad[e];
            const float gx = gr.x, gy = gr.y;
            s[0] += a * gx;
            s[1] += b * gx;
            s[2] += c * gx;
            s[3] += d * gx;
            s[4] += a * gy;
            s[5] += b * gy;
            s[6] += c * gy;
            s[7] += d * gy;
          }
        }
        warp_sum<8>(s);
        if constexpr (kBody == kReload) {
          if (lane == 0) {
#pragma unroll
            for (int q = 0; q < 8; ++q)
              dots[(static_cast<size_t>(k) * iters + it) * 8 + q] = s[q];
          }
          extra = s[0];
          ++it;
        } else {
          // K3's cell: the 8 dots serve every iteration that stays in it.
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
        }
      }
    }
  }
  if (lane == 0) {
    if constexpr (kSplit) {
      flow[2 * k] = acc + extra;
      flow[2 * k + 1] = acc;
      ok_out[k] = acc;
    } else if constexpr (kFinish) {
      flow[2 * k] = gx0 + vx;
      flow[2 * k + 1] = gy0 + vy;
      ok_out[k] = ok && fabsf(vx) <= radius && fabsf(vy) <= radius;
    } else {
      flow[2 * k] = vx;
      flow[2 * k + 1] = vy;
      ok_out[k] = ok ? 1.0f : 0.0f;
    }
    if (stats != nullptr) {
      stats[2 * k] = it;
      stats[2 * k + 1] = reloads;
    }
  }
}

template <int kBody, bool kFinish>
int launch_level(const float* prev, const float* next, int hp, int wp, const float* pts,
                 const float* guess, const uint8_t* active, int n, int win, int iters,
                 float eps2, float min_eig, int pad, float radius, float* flow,
                 OkOut<kFinish>* ok, int32_t* stats, float* dots, int device, void* stream) {
  if (n == 0) return 0;
  if (win < 1 || hp < win + 3 || wp < win + 3) return static_cast<int>(cudaErrorInvalidValue);
  svo::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  constexpr int points = points_per_cta(kBody);
  const size_t smem = static_cast<size_t>(points) * slice_floats(kBody, win) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lk_block_cell_kernel<kBody, kFinish>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n + points - 1) / points;
  lk_block_cell_kernel<kBody, kFinish><<<blocks, 32 * points, smem,
                                         static_cast<cudaStream_t>(stream)>>>(
      prev, next, hp, wp, pts, guess, active, n, win, iters, eps2, min_eig, pad, radius, flow,
      ok, stats, dots);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int svo_lk_level_block(const float* prev, const float* next, int hp, int wp,
                                  const float* pts, const float* guess,
                                  const uint8_t* active, int n, int win, int iters,
                                  float eps2, float min_eig, int pad, float radius,
                                  float* flow, bool* ok, int32_t* stats, int device,
                                  void* stream) {
  return launch_level<kCell, true>(prev, next, hp, wp, pts, guess, active, n, win, iters,
                                   eps2, min_eig, pad, radius, flow, ok, stats, nullptr,
                                   device, stream);
}

extern "C" int svo_lk_level_v2(const float* prev, const float* next, int hp, int wp,
                               const float* pts, const float* guess,
                               const uint8_t* active, int n, int win, int iters,
                               float eps2, float min_eig, int pad, float radius,
                               float* flow, bool* ok, int32_t* stats, int device,
                               void* stream) {
  return launch_level<kIter, true>(prev, next, hp, wp, pts, guess, active, n, win, iters,
                                   eps2, min_eig, pad, radius, flow, ok, stats, nullptr,
                                   device, stream);
}

// mode: 0 `full` (K5's body with the raw tail, every point tracked from
// `guess`, null: zero guesses), 1 `tmpl`, 2 `reload` (rounds >= 1, which the
// kernel runs as its iterations; neither reads `guess`). No mask, no
// statistics.
extern "C" int svo_lk_block_split(const float* prev, const float* next, int hp, int wp,
                                  const float* pts, const float* guess, int n, int win,
                                  int iters, float eps2, float min_eig, int pad,
                                  float* flow, float* ok, int mode, int rounds,
                                  float* dots, int device, void* stream) {
  switch (mode) {
    case 0:
      return launch_level<kCell, false>(prev, next, hp, wp, pts, guess, nullptr, n, win,
                                        iters, eps2, min_eig, pad, 0.0f, flow, ok, nullptr,
                                        nullptr, device, stream);
    case 1:
      return launch_level<kTmpl, false>(prev, next, hp, wp, pts, nullptr, nullptr, n, win,
                                        0, eps2, min_eig, pad, 0.0f, flow, ok, nullptr,
                                        nullptr, device, stream);
    case 2:
      if (rounds < 1) return static_cast<int>(cudaErrorInvalidValue);
      return launch_level<kReload, false>(prev, next, hp, wp, pts, nullptr, nullptr, n,
                                          win, rounds, eps2, min_eig, pad, 0.0f, flow, ok,
                                          nullptr, dots, device, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
