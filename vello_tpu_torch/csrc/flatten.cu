// K1 flatten: curves -> (16, L) line pack.
//
// Replaces vello_tpu/ops/pallas_kernels.py:711 flatten_pallas (body
// _flatten_kernel, :570): the fill rows and the stroke rows (device stroke
// expansion, :608-633).
//
// What bounds it on the H100: memory. Each line slot reads its segment's
// row (16 columns, or 21 with the stroke columns, shared by the segment's
// slots; plus a warp's few probes of the count scan, which stay in L1/L2)
// and writes 64 bytes; the ~180 flops of cubic evaluation, trim and clamp
// per slot are far below the card's rate. On the 30k-path msaa16 frame
// (468392 live slots of L = 491520) that is 40 MB moved.
//
// Design: kPerThread line slots per thread, a warp's 32 consecutive slots
// at a time. The TPU kernel found each slot's segment with a 128-aligned
// segment window and a one-hot MXU row select (exact only through a 3-pass
// bf16 split); here each warp finds the segments owning its 32 slots
// (offs <= p < incl) with one 32-way search of the inclusive count scan
// and a search over the lanes' registers (vt::warp_upper_bound: ~4
// dependent loads where a binary search per thread waits on ~17), and each
// thread loads its row directly.
// The output keeps the (16, L) row layout, so the 32 threads of a warp
// store each row as one 128-byte transaction. Every op follows the f32 op
// order of _flatten_kernel and is built with --fmad=false: the floors and
// ceils of the DDA count must agree with the JAX package and the host
// estimator bit for bit, or tiers come out too small.
//
// Stroke rows: a segment row of 21 columns carries [hw, jnx, jny, m, join]
// after the 16 fill columns. A slot of a stroked segment (m > 0) is line
// se = sub - 7 * si of centerline mini si = floor((sub + 0.5) / 7): the
// centerline is evaluated at si/m, (si+1)/m and (si+2)/m and the slot line
// taken from stroke_slot_line (ops/flatten.py), whose rsqrt is computed as
// 1.0f / sqrtf(x), both correctly rounded as XLA and the plain version
// round them (CUDA's rsqrtf is approximate). From the y trim on, a stroke
// line is a fill line. A thread of a stroked slot evaluates three points
// instead of two and selects among 7 candidate lines, ~80 more flops.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr float kTile = 16.0f;
constexpr float kEdgeEps = 0.0009765625f;  // 2^-10

constexpr float kStrokeSlots = 7.0f;
constexpr float kTiny = 1e-24f;

__device__ __forceinline__ float cubic(float t, float a, float b, float c,
                                       float d) {
  float mt = 1.0f - t;
  return mt * mt * mt * a + 3.0f * mt * mt * t * b + 3.0f * mt * t * t * c +
         t * t * t * d;
}

// 7-way select on an integer-valued float e in [0, 6] (flatten._sel7)
__device__ __forceinline__ float sel7(float e, float v0, float v1, float v2,
                                      float v3, float v4, float v5,
                                      float v6) {
  float lo = e < 0.5f ? v0 : (e < 1.5f ? v1 : (e < 2.5f ? v2 : v3));
  float hi = e < 4.5f ? v4 : (e < 5.5f ? v5 : v6);
  return e < 3.5f ? lo : hi;
}

// ops/flatten.stroke_slot_line for one slot: the endpoints of edge e of
// mini i (chord p0 -> p1, next chord p1 -> p2) of a stroke of half-width hw
__device__ void stroke_slot_line(float p0x, float p0y, float p1x, float p1y,
                                 float p2x, float p2y, float hw, float jnx,
                                 float jny, float join, float i, float e,
                                 float m, float* ax, float* ay, float* bx,
                                 float* by) {
  float dx = p1x - p0x;
  float dy = p1y - p0y;
  float l2 = dx * dx + dy * dy;
  float k = hw * (1.0f / sqrtf(fmaxf(l2, kTiny)));
  float nx = dy * k;
  float ny = -dx * k;
  float d2x = p2x - p1x;
  float d2y = p2y - p1y;
  float l2b = d2x * d2x + d2y * d2y;
  float kb = hw * (1.0f / sqrtf(fmaxf(l2b, kTiny)));
  bool inner = i < m - 0.5f;
  float n2x = inner ? d2y * kb : jnx;
  float n2y = inner ? -d2x * kb : jny;
  bool has_tri = (inner || join > 0.5f) && (l2 > kTiny);
  float s = (dx * n2x + dy * n2y >= 0.0f) ? 1.0f : -1.0f;
  float c1x = p1x + s * nx;
  float c1y = p1y + s * ny;
  float c2x = p1x + s * n2x;
  float c2y = p1y + s * n2y;
  bool pos = s > 0.0f;
  float t1x = has_tri ? (pos ? c1x : c2x) : p1x;
  float t1y = has_tri ? (pos ? c1y : c2y) : p1y;
  float t2x = has_tri ? (pos ? c2x : c1x) : p1x;
  float t2y = has_tri ? (pos ? c2y : c1y) : p1y;
  if (l2 <= kTiny) {  // zero-length mini: the whole slot group collapses
    *ax = *bx = p1x;
    *ay = *by = p1y;
    return;
  }
  *ax = sel7(e, p0x + nx, p1x + nx, p1x - nx, p0x - nx, p1x, t1x, t2x);
  *ay = sel7(e, p0y + ny, p1y + ny, p1y - ny, p0y - ny, p1y, t1y, t2y);
  *bx = sel7(e, p1x + nx, p1x - nx, p0x - nx, p0x + nx, t1x, t2x, p1x);
  *by = sel7(e, p1y + ny, p1y - ny, p0y - ny, p0y + ny, t1y, t2y, p1y);
}

// the work shape (the fastest of a sweep, PERF.md §6): threads per CTA,
// and slots per thread, a warp's 32 consecutive slots at a time
constexpr int kThreads = 128;
constexpr int kPerThread = 1;

// line slot p < n_lines, owned by segment seg when p < total. kCols: 16
// (fill rows only) or 21 (with the stroke columns); a fill-only pack
// compiles without the stroke branch
template <int kCols>
__device__ __forceinline__ void line_slot(const float* __restrict__ spack,
                                          int seg, float* __restrict__ out,
                                          int n_lines, float hi, float height,
                                          int p, int total) {
  float r[21];
#pragma unroll
  for (int k = 0; k < 21; ++k) r[k] = 0.0f;
  if (p < total) {
    const float* row = spack + (size_t)seg * kCols;
#pragma unroll
    for (int k = 0; k < kCols; ++k) r[k] = row[k];
  }
  float n = fmaxf(r[8], 1.0f);
  float pfr = (float)p;
  float sub = pfr - r[9];
  float t0 = sub / n;
  float t1 = (sub + 1.0f) / n;
  float p0x, p0y, p1x, p1y;
  if (kCols == 21 && r[19] > 0.5f) {  // a stroked segment's slot
    float m = fmaxf(r[19], 1.0f);
    float si = floorf((sub + 0.5f) * (1.0f / kStrokeSlots));
    float se = sub - kStrokeSlots * si;
    float s0 = si / m, s1 = (si + 1.0f) / m, s2 = (si + 2.0f) / m;
    stroke_slot_line(cubic(s0, r[0], r[2], r[4], r[6]),
                     cubic(s0, r[1], r[3], r[5], r[7]),
                     cubic(s1, r[0], r[2], r[4], r[6]),
                     cubic(s1, r[1], r[3], r[5], r[7]),
                     cubic(s2, r[0], r[2], r[4], r[6]),
                     cubic(s2, r[1], r[3], r[5], r[7]), r[16], r[17], r[18],
                     r[20], si, se, m, &p0x, &p0y, &p1x, &p1y);
  } else {
    p0x = cubic(t0, r[0], r[2], r[4], r[6]);
    p0y = cubic(t0, r[1], r[3], r[5], r[7]);
    p1x = cubic(t1, r[0], r[2], r[4], r[6]);
    p1y = cubic(t1, r[1], r[3], r[5], r[7]);
  }

  // y trim (parametric; untrimmed endpoints stay bit-identical)
  float y0 = p0y, y1 = p1y;
  float dy = y1 - y0;
  float y0c = vt::clampf(y0, 0.0f, height);
  float y1c = vt::clampf(y1, 0.0f, height);
  bool nzy = fabsf(dy) > (float)1e-12;
  float inv_dy = nzy ? 1.0f / dy : 0.0f;
  float ta = nzy ? (y0c - y0) * inv_dy : 0.0f;
  float tb = nzy ? (y1c - y0) * inv_dy : 1.0f;
  float x0 = (y0c != y0) ? p0x + ta * (p1x - p0x) : p0x;
  float x1 = (y1c != y1) ? p0x + tb * (p1x - p0x) : p1x;
  y0 = y0c;
  y1 = y1c;
  bool real = pfr < (float)total;
  bool alive = real && (fabsf(y1 - y0) + fabsf(x1 - x0) > (float)1e-12);

  // x clamp + left-edge verticals
  const float lo = kEdgeEps;
  float x0c = vt::clampf(x0, lo, hi);
  float x1c = vt::clampf(x1, lo, hi);
  float dx = x1 - x0;
  bool nzx = fabsf(dx) > (float)1e-12;
  float inv_dx = nzx ? 1.0f / dx : 0.0f;
  float u0 = nzx ? vt::clampf((x0c - x0) * inv_dx, 0.0f, 1.0f) : 0.0f;
  float u1 = nzx ? vt::clampf((x1c - x0) * inv_dx, 0.0f, 1.0f) : 1.0f;
  float ye0 = y0 + u0 * (y1 - y0);
  float ye1 = y0 + u1 * (y1 - y0);
  bool outside = (fmaxf(x0, x1) <= lo) || (fminf(x0, x1) >= hi);
  float my0 = (outside || x0c == x0) ? y0 : ye0;
  float my1 = (outside || x1c == x1) ? y1 : ye1;
  bool crossing = alive && nzx && (fminf(x0, x1) < lo) && (fmaxf(x0, x1) > lo);
  bool need_start = crossing && (x0 < x1);
  float ev_y0 = need_start ? y0 : ye1;
  float ev_y1 = need_start ? ye0 : y1;

  // orientation + DDA touch count on the clamped line
  bool is_down = my1 >= my0;
  float qx0 = is_down ? x0c : x1c;
  float qy0 = is_down ? my0 : my1;
  float qx1 = is_down ? x1c : x0c;
  float qy1 = is_down ? my1 : my0;
  float sx0 = qx0 / kTile, sy0 = qy0 / kTile;
  float sx1 = qx1 / kTile, sy1 = qy1 / kTile;
  float span_x = fmaxf(ceilf(fmaxf(sx0, sx1)) - floorf(fminf(sx0, sx1)), 1.0f);
  float span_y = fmaxf(ceilf(fmaxf(sy0, sy1)) - floorf(fminf(sy0, sy1)), 1.0f);
  float count = span_x - 1.0f + span_y;
  float dxs = fabsf(sx1 - sx0);
  float dys = sy1 - sy0;
  bool dead = ((dxs + dys) == 0.0f) || ((dys == 0.0f) && (floorf(sy0) == sy0));
  if (dead) count = 0.0f;
  bool on_right = fminf(x0c, x1c) / kTile >= r[12];
  bool live = alive && !on_right && (r[14] > 0.0f) && (count > 0.0f);

  float o[16] = {qx0, qy0, qx1, qy1, is_down ? 1.0f : -1.0f,
                 live ? count : 0.0f, live ? 1.0f : 0.0f,
                 crossing ? 1.0f : 0.0f, ev_y0, ev_y1,
                 r[10], r[11], r[12], r[13], r[14], r[15]};
#pragma unroll
  for (int k = 0; k < 16; ++k) out[(size_t)k * n_lines + p] = o[k];
}

template <int kCols>
__global__ void __launch_bounds__(kThreads)
    flatten_kernel(const float* __restrict__ spack,
                   const int* __restrict__ incl, int n_segs,
                   float* __restrict__ out, int n_lines, float hi,
                   float height) {
  const int lane = threadIdx.x & 31;
  const int base = (blockIdx.x * kThreads + threadIdx.x - lane) * kPerThread;
  const int total = incl[n_segs - 1];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    int p0 = base + 32 * j;  // the same for the whole warp
    if (p0 >= n_lines) break;
    int p = p0 + lane;
    int seg = vt::warp_upper_bound(incl, n_segs, p0, p, total);
    if (p < n_lines) {
      line_slot<kCols>(spack, seg, out, n_lines, hi, height, p, total);
    }
  }
}

}  // namespace

extern "C" int vt_flatten(const float* spack, const int* incl, int n_segs,
                          int cols, float* out, int n_lines, float hi,
                          float height, cudaStream_t stream) {
  const int per_cta = kThreads * kPerThread;
  int blocks = (n_lines + per_cta - 1) / per_cta;
  if (cols == 16) {
    flatten_kernel<16><<<blocks, kThreads, 0, stream>>>(spack, incl, n_segs,
                                                        out, n_lines, hi,
                                                        height);
  } else if (cols == 21) {
    flatten_kernel<21><<<blocks, kThreads, 0, stream>>>(spack, incl, n_segs,
                                                        out, n_lines, hi,
                                                        height);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
