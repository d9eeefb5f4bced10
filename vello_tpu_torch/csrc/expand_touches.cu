// K2 touch expansion: lines -> (8, T) touch payload.
//
// Replaces vello_tpu/ops/pallas_kernels.py:911 expand_touches_pallas (body
// _expand_touch_kernel, :764): the path_count / path_tiling pair of the
// reference in one pass.
//
// What bounds it on the H100: memory. Each touch slot reads its line's 13
// fields (the lines are shared by ~1.3 neighbouring slots, so most of the
// reads hit L1/L2) and writes 32 bytes; ~200 flops of DDA stepping and tile
// clipping per slot do not come near the card's rate. On the 30k-path
// msaa16 frame (596404 touches of 468392 lines) that is 47 MB of traffic.
//
// Design: kPerThread touch slots per thread, a warp's 32 consecutive slots
// at a time. The TPU kernel DMA'd a 128-aligned line window per 1024-slot
// block and selected each slot's line with a one-hot MXU product; here
// each warp finds the lines owning its 32 slots (offs <= p < incl) with one
// 32-way search of the inclusive touch-count scan and a search over the
// lanes' registers (vt::warp_upper_bound: ~5 dependent loads where a
// binary search per thread waits on ~20), and each thread reads its line's
// column of the (16, N) pack. The staircase step i = p - offs recomputes
// the whole DDA from the line's endpoints, so no state passes between
// threads (a line has 1.3-1.4 touches on the frames measured: sharing its
// setup does not pay, PERF.md §6). Same f32 op order as
// _expand_touch_kernel, built with --fmad=false, so the tile ids and
// backdrop deltas agree with the JAX package bit for bit. Dead
// slots carry DUMP_TILE = 2^30 and the 1e9 y_edge.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr float kTile = 16.0f;
constexpr float kDumpTile = 1073741824.0f;  // 2^30

__device__ __forceinline__ float signf(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// the work shape (the fastest of a sweep, PERF.md §6): threads per CTA,
// and slots per thread, a warp's 32 consecutive slots at a time
constexpr int kThreads = 128;
constexpr int kPerThread = 2;

// touch slot p < n_touches, owned by line l when p < total
__device__ __forceinline__ void touch_slot(const float* __restrict__ lpack,
                                           int n_lines, int l,
                                           float* __restrict__ pay,
                                           int n_touches, int p, int total) {
  float r[14];
#pragma unroll
  for (int k = 0; k < 14; ++k) r[k] = 0.0f;
  if (p < total) {
#pragma unroll
    for (int k = 0; k < 14; ++k) r[k] = lpack[(size_t)k * n_lines + l];
  }
  const float qx0 = r[0], qy0 = r[1], qx1 = r[2], qy1 = r[3], down = r[4];
  const float live = r[7];
  const float tx0 = r[8], ty0 = r[9], tx1 = r[10], ty1 = r[11];
  const float stride = r[12], base = r[13];
  float pfr = (float)p;
  float i = pfr - r[5];

  // DDA staircase
  float sx0 = qx0 / kTile, sy0 = qy0 / kTile;
  float sx1 = qx1 / kTile, sy1 = qy1 / kTile;
  float span_x = fmaxf(ceilf(fmaxf(sx0, sx1)) - floorf(fminf(sx0, sx1)), 1.0f);
  float span_y = fmaxf(ceilf(fmaxf(sy0, sy1)) - floorf(fminf(sy0, sy1)), 1.0f);
  float count_x = span_x - 1.0f;
  float count = count_x + span_y;
  float dx = fabsf(sx1 - sx0);
  float dy = sy1 - sy0;
  float denom = dx + dy;
  float idxdy = 1.0f / (denom == 0.0f ? 1.0f : denom);
  float a = dx * idxdy;
  bool pos_slope = sx1 >= sx0;
  float sign_x = pos_slope ? 1.0f : -1.0f;
  float xt0 = floorf(sx0 * sign_x);
  float c = sx0 * sign_x - xt0;
  float y0i = floorf(sy0);
  float ytop = (sy0 == sy1) ? ceilf(sy0) : y0i + 1.0f;
  float b = fminf((dy * c + dx * (ytop - sy0)) * idxdy, (float)0.99999994);
  float err = floorf(a * (count - 1.0f) + b) - count_x;
  if (err != 0.0f) a = a - (float)2e-7 * signf(err);
  float x0i_f = xt0 * sign_x + (pos_slope ? 0.0f : -1.0f);

  float z = floorf(a * i + b);
  float x = vt::clampf(x0i_f + sign_x * z, tx0, tx1 - 1.0f);
  float y = vt::clampf(y0i + i - z, ty0, ty1 - 1.0f);
  bool tvalid = (pfr < (float)total) && (live > 0.0f);
  float ftile = tvalid ? base + (y - ty0) * stride + (x - tx0) : kDumpTile;

  // backdrop: a top-edge entry targets tile x+1
  float z_prev = floorf(a * (i - 1.0f) + b);
  bool top_edge = (i == 0.0f) ? (floorf(sy0) == sy0) : (z == z_prev);
  bool b_ok = tvalid && top_edge && (x + 1.0f < tx1);
  float backdrop = b_ok ? (down > 0.0f ? -1.0f : 1.0f) : 0.0f;

  // clip the segment to the tile (path_tiling rules)
  float tile_x = x * kTile;
  float tile_y = y * kTile;
  float tile_x1 = tile_x + kTile;
  float tile_y1 = tile_y + kTile;
  float dxl = qx1 - qx0;
  float dyl = qy1 - qy0;
  float inv_dyl = 1.0f / (dyl == 0.0f ? 1.0f : dyl);
  float inv_dxl = 1.0f / (dxl == 0.0f ? 1.0f : dxl);
  const float eps3 = (float)1e-3;

  bool z_same_prev = z == z_prev;
  float xt_top = vt::clampf(qx0 + dxl * (tile_y - qy0) * inv_dyl,
                            tile_x + eps3, tile_x1);
  float x_clip_e = pos_slope ? tile_x : tile_x1;
  float yt_side = vt::clampf(qy0 + dyl * (x_clip_e - qx0) * inv_dxl,
                             tile_y + eps3, tile_y1);
  float px0 = (i > 0.0f) ? (z_same_prev ? xt_top : x_clip_e) : qx0;
  float py0 = (i > 0.0f) ? (z_same_prev ? tile_y : yt_side) : qy0;

  bool z_same_next = z == floorf(a * (i + 1.0f) + b);
  float xt_bot = vt::clampf(qx0 + dxl * (tile_y1 - qy0) * inv_dyl,
                            tile_x + eps3, tile_x1);
  float x_clip_x = pos_slope ? tile_x1 : tile_x;
  float yt_side2 = vt::clampf(qy0 + dyl * (x_clip_x - qx0) * inv_dxl,
                              tile_y + eps3, tile_y1);
  bool last = i >= count - 1.0f;
  float px1 = last ? qx1 : (z_same_next ? xt_bot : x_clip_x);
  float py1 = last ? qy1 : (z_same_next ? tile_y1 : yt_side2);

  // tile-local coordinates + robustness rules (path_tiling.wgsl)
  float p0x = px0 - tile_x;
  float p0y = py0 - tile_y;
  float p1x = px1 - tile_x;
  float p1y = py1 - tile_y;
  const float eps = (float)1e-6;
  float y_edge = (float)1e9;
  bool both0 = (p0x == 0.0f) && (p1x == 0.0f);
  bool entire = both0 && (p0y == 0.0f);
  bool vanish = both0 && (p0y != 0.0f);
  bool p0_only = (p0x == 0.0f) && (p1x != 0.0f);
  if (p0_only && p0y != 0.0f) y_edge = p0y;
  if ((p1x == 0.0f) && !both0 && (p1y != 0.0f)) y_edge = p1y;
  if (both0 || (p0_only && p0y == 0.0f)) p0x = eps;
  p1x = entire ? eps : (vanish ? (float)2e-6 : p1x);
  p1y = entire ? kTile : (vanish ? p0y : p1y);
  if ((p1x == 0.0f) && (p1y == 0.0f) && !both0) p1x = eps;
  if ((p0x == floorf(p0x)) && (p0x != 0.0f)) p0x = p0x - eps;
  if ((p1x == floorf(p1x)) && (p1x != 0.0f)) p1x = p1x - eps;
  bool is_down = down > 0.0f;

  float o[8] = {tvalid ? (is_down ? p0x : p1x) : 0.0f,
                tvalid ? (is_down ? p0y : p1y) : 0.0f,
                tvalid ? (is_down ? p1x : p0x) : 0.0f,
                tvalid ? (is_down ? p1y : p0y) : 0.0f,
                tvalid ? y_edge : (float)1e9,
                backdrop, ftile, 0.0f};
#pragma unroll
  for (int k = 0; k < 8; ++k) pay[(size_t)k * n_touches + p] = o[k];
}

__global__ void __launch_bounds__(kThreads)
    expand_touches_kernel(const float* __restrict__ lpack,
                          const int* __restrict__ incl, int n_lines,
                          float* __restrict__ pay, int n_touches) {
  const int lane = threadIdx.x & 31;
  const int base = (blockIdx.x * kThreads + threadIdx.x - lane) * kPerThread;
  const int total = incl[n_lines - 1];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    int p0 = base + 32 * j;  // the same for the whole warp
    if (p0 >= n_touches) break;
    int p = p0 + lane;
    int l = vt::warp_upper_bound(incl, n_lines, p0, p, total);
    if (p < n_touches) touch_slot(lpack, n_lines, l, pay, n_touches, p, total);
  }
}

}  // namespace

extern "C" int vt_expand_touches(const float* lpack, const int* incl,
                                 int n_lines, float* pay, int n_touches,
                                 cudaStream_t stream) {
  const int per_cta = kThreads * kPerThread;
  int blocks = (n_touches + per_cta - 1) / per_cta;
  expand_touches_kernel<<<blocks, kThreads, 0, stream>>>(lpack, incl, n_lines,
                                                         pay, n_touches);
  return (int)cudaGetLastError();
}
