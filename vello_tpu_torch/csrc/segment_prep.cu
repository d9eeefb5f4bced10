// Segment preparation of the fused geometry: host-compacted segments -> the
// per-segment line counts and the (S, 16 | 21) segment pack that K1 reads.
//
// Replaces no TPU kernel: the JAX package leaves this segment-scale work to
// XLA, which fuses it into a few loops (vello_tpu/ops/flatten.py
// flatten_fused :222-266). Run eagerly, the same chain
// (ops/kernels.segment_prep_plain) is some 280 small PyTorch launches a
// stroked frame, and it built one constant on the host, which made the host
// wait for the frame in flight.
//
// What bounds it on the H100: memory, barely. Per segment it reads 48 bytes
// (the 4 points, kind, path, half-width, join flag) and a 24-byte path rect,
// and writes 4 bytes of count and 64 (fill-only) or 84 bytes of pack; a
// thread also reads the next segment's points, kind and half-width, which
// its neighbour loads too (L1). The arithmetic, ~300 flops for a stroked
// segment and twice that with the next segment's mini count, is far below
// the card's f32 rate.
//
// Design: one thread per segment. A stroked segment's join normal needs the
// NEXT segment's mini count (the plain version rolls the count array by
// one); the thread recomputes that count from the next segment's points
// instead of reading it from a second pass. The rows of a block's 128
// segments are staged in shared memory (an odd pitch, so that the row
// writes hit 32 banks) and stored as one contiguous run, so that a warp's
// stores are coalesced. The offset column (the exclusive scan of the counts)
// is left 0 here: the wrapper scans the counts with torch.cumsum and
// segment_offsets_kernel writes incl - counts into it.
//
// Every op follows the plain version's f32 op order, built with
// --fmad=false, and matches what PyTorch's CUDA kernels compute for it: the
// counts must agree bit for bit with the chain they replace, or tiers come
// out wrong and retries fire. Two places where PyTorch on CUDA rounds
// otherwise than the formula reads:
//  - a tensor divided by a Python scalar is a multiply by the scalar's f32
//    reciprocal (ATen's div_true_kernel_cuda): elevate_to_cubic's / 3.0 and
//    wang_counts' / (8 * tol) are multiplies by kInv3 and inv8tol here (the
//    plain version on the CPU divides);
//  - stroke_mini_counts divides a device tensor 8 * tol by a tensor, an
//    IEEE division: num8tol / max(hw, tol) here.
// A reciprocal 1 / x of a tensor (``1.0 / t`` is ``t.reciprocal()``) and
// sqrt are correctly rounded on both sides, and so is every division of two
// tensors. torch.maximum, minimum and clamp return a NaN operand; so do the
// helpers below.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr float kInv3 = 1.0f / 3.0f;              // ATen: 1 / (float)3.0
constexpr float kTwo3 = (float)(2.0 / 3.0);       // Python's 2.0 / 3.0
constexpr int kStrokeSlots = 7;

// the constants of the count bounds
struct Bounds {
  float max_lines;
  float inv8tol;        // 1 / (float)(8 * tol), rounded to f32
  float tol;            // (float)tol
  float num8tol;        // (float)(8 * tol)
};

struct Args {
  const float* pts;     // (S, 4, 2)
  const int* kind;      // (S,) 0 none, 1 line, 2 quad, 3 cubic
  const int* path;      // (S,)
  const int* n_segs;    // 0-d: the live segments are [0, n_segs)
  const int* rect[6];   // (P,) each: tx0, ty0, tx1, ty1, stride, base
  int n_paths;
  const float* hw;      // (S,) stroke half-widths, 0 for a fill; or null
  const int* join;      // (S,) join flags; or null
  int s;
  Bounds b;
  int* counts;          // (S,) out
  float* spack;         // (S, 16 | 21) out
};

__device__ __forceinline__ bool isnan_(float x) { return x != x; }

// torch.maximum / torch.minimum / clamp_min / clamp on CUDA
__device__ __forceinline__ float t_max(float a, float b) {
  return isnan_(a) ? a : (isnan_(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float t_min(float a, float b) {
  return isnan_(a) ? a : (isnan_(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float t_clamp_min(float x, float lo) {
  return isnan_(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float t_clamp(float x, float lo, float hi) {
  return isnan_(x) ? x : fminf(fmaxf(x, lo), hi);
}

// flatten._hypot: jnp.hypot's max * sqrt(1 + (min / max)^2)
__device__ __forceinline__ float hypot_j(float a, float b) {
  float x1 = fabsf(a), x2 = fabsf(b);
  float hi = t_max(x1, x2), lo = t_min(x1, x2);
  float q = lo / (hi == 0.0f ? 1.0f : hi);
  return hi == 0.0f ? hi : hi * sqrtf(1.0f + q * q);
}

// flatten.elevate_to_cubic for one segment: c = [p0, c1, c2, p3] as x, y
__device__ __forceinline__ void elevate(const float* __restrict__ p, int kind,
                                        float c[8]) {
  float p0x = p[0], p0y = p[1];
  float ax = p[2], ay = p[3];   // line end, quad control, cubic c1
  float bx = p[4], by = p[5];   // quad end, cubic c2
  c[0] = p0x;
  c[1] = p0y;
  if (kind == 1) {
    c[2] = p0x + (ax - p0x) * kInv3;
    c[3] = p0y + (ay - p0y) * kInv3;
    c[4] = p0x + kTwo3 * (ax - p0x);
    c[5] = p0y + kTwo3 * (ay - p0y);
    c[6] = ax;
    c[7] = ay;
  } else if (kind == 2) {
    c[2] = p0x + kTwo3 * (ax - p0x);
    c[3] = p0y + kTwo3 * (ay - p0y);
    c[4] = bx + kTwo3 * (ax - bx);
    c[5] = by + kTwo3 * (ay - by);
    c[6] = bx;
    c[7] = by;
  } else {
    c[2] = ax;
    c[3] = ay;
    c[4] = bx;
    c[5] = by;
    c[6] = p[6];
    c[7] = p[7];
  }
}

// flatten.wang_counts' clamped bound, before its kind selects, as a float
__device__ __forceinline__ float wang_bound(const float c[8], Bounds b) {
  float d1x = c[0] - 2.0f * c[2] + c[4];
  float d1y = c[1] - 2.0f * c[3] + c[5];
  float d2x = c[2] - 2.0f * c[4] + c[6];
  float d2y = c[3] - 2.0f * c[5] + c[7];
  float m = 6.0f * t_max(hypot_j(d1x, d1y), hypot_j(d2x, d2y));
  float n = ceilf(sqrtf(t_clamp_min(m, 0.0f) * b.inv8tol));
  return t_clamp(n, 1.0f, b.max_lines);
}

// flatten.wang_counts for one segment
__device__ __forceinline__ int wang_count(const float c[8], int kind,
                                          Bounds b) {
  int n = (int)wang_bound(c, b);
  n = kind == 1 ? 1 : n;
  return kind == 0 ? 0 : n;
}

// the exterior angle between control-polygon legs u and v
__device__ __forceinline__ float leg_angle(float ux, float uy, float vx,
                                           float vy) {
  float cr = fabsf(ux * vy - uy * vx);
  float dt = ux * vx + uy * vy;
  bool ok = (hypot_j(ux, uy) > (float)1e-12) &&
            (hypot_j(vx, vy) > (float)1e-12);
  return ok ? atan2f(cr, dt) : 0.0f;
}

// flatten.stroke_mini_counts for one segment of half-width hw
__device__ __forceinline__ int stroke_minis(const float c[8], float hw,
                                            Bounds b) {
  float wang = wang_bound(c, b);
  float v0x = c[2] - c[0], v0y = c[3] - c[1];
  float v1x = c[4] - c[2], v1y = c[5] - c[3];
  float v2x = c[6] - c[4], v2y = c[7] - c[5];
  float dtheta = leg_angle(v0x, v0y, v1x, v1y) + leg_angle(v1x, v1y, v2x, v2y);
  float theta_max = sqrtf(b.num8tol / t_clamp_min(hw, b.tol));
  float m_turn = ceilf(dtheta / theta_max);
  // wang is the int count of the plain version, exact as a float
  return (int)t_clamp(t_max((float)(int)wang, m_turn), 1.0f, b.max_lines);
}

// the mini count the plain version keeps for segment j: 0 unless stroked
__device__ __forceinline__ int masked_minis(const float c[8], float hw,
                                            Bounds b) {
  return hw > 0.0f ? stroke_minis(c, hw, b) : 0;
}

template <bool kStroke>
__global__ void __launch_bounds__(kThreads) segment_prep_kernel(Args a) {
  constexpr int kCols = kStroke ? 21 : 16;
  constexpr int kPitch = kStroke ? 21 : 17;  // odd: conflict-free rows
  __shared__ float rows[kThreads * kPitch];
  const int first = blockIdx.x * kThreads;
  const int i = first + threadIdx.x;
  if (i < a.s) {
    float* row = rows + threadIdx.x * kPitch;
    const int kind = a.kind[i];
    float c[8];
    elevate(a.pts + (size_t)i * 8, kind, c);
    int count = wang_count(c, kind, a.b);
    if constexpr (kStroke) {
      const float hw = a.hw[i];
      const bool is_stroke = hw > 0.0f;
      const int m = masked_minis(c, hw, a.b);
      if (is_stroke) count = m * kStrokeSlots;
      // the next segment (cyclically, as torch.roll) and its mini count
      const int j = i + 1 < a.s ? i + 1 : 0;
      float cn[8];
      elevate(a.pts + (size_t)j * 8, a.kind[j], cn);
      const int mn = masked_minis(cn, a.hw[j], a.b);
      // its first chord, at t = 1 / max(m, 1), and the join normal
      const float tq = 1.0f / (float)max(mn, 1);
      const float mt = 1.0f - tq;
      float pnx = mt * mt * mt * cn[0] + 3.0f * mt * mt * tq * cn[2] +
                  3.0f * mt * tq * tq * cn[4] + tq * tq * tq * cn[6];
      float pny = mt * mt * mt * cn[1] + 3.0f * mt * mt * tq * cn[3] +
                  3.0f * mt * tq * tq * cn[5] + tq * tq * tq * cn[7];
      float chx = pnx - cn[0];
      float chy = pny - cn[1];
      float l2 = chx * chx + chy * chy;
      float kj = hw * (1.0f / sqrtf(t_clamp_min(l2, (float)1e-24)));
      float joinf =
          (a.join[i] > 0 && is_stroke && l2 > (float)1e-24) ? 1.0f : 0.0f;
      row[16] = hw;
      row[17] = joinf * chy * kj;
      row[18] = -joinf * chx * kj;
      row[19] = (float)m;
      row[20] = joinf;
    }
    if (!(i < *a.n_segs)) count = 0;
    a.counts[i] = count;
#pragma unroll
    for (int k = 0; k < 8; ++k) row[k] = c[k];
    row[8] = (float)count;
    row[9] = 0.0f;  // offs: segment_offsets_kernel, after the scan
    const int p = min(max(a.path[i], 0), a.n_paths - 1);
#pragma unroll
    for (int k = 0; k < 6; ++k) row[10 + k] = (float)a.rect[k][p];
  }
  __syncthreads();
  const int n = min(kThreads, a.s - first);
  float* out = a.spack + (size_t)first * kCols;
  for (int e = threadIdx.x; e < n * kCols; e += kThreads) {
    int r = e / kCols;
    out[e] = rows[r * kPitch + (e - r * kCols)];
  }
}

__global__ void segment_offsets_kernel(const int* __restrict__ counts,
                                       const int* __restrict__ incl,
                                       float* __restrict__ spack, int s,
                                       int cols) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < s) spack[(size_t)i * cols + 9] = (float)(incl[i] - counts[i]);
}

}  // namespace

extern "C" int vt_segment_prep(const float* pts, const int* kind,
                               const int* path, const int* n_segs,
                               const int* tx0, const int* ty0, const int* tx1,
                               const int* ty1, const int* stride,
                               const int* base, int n_paths, const float* hw,
                               const int* join, int s, int max_lines,
                               float inv8tol, float tol, float num8tol,
                               int* counts, float* spack,
                               cudaStream_t stream) {
  if (s <= 0 || n_paths <= 0 || (hw == nullptr) != (join == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{pts, kind, path, n_segs, {tx0, ty0, tx1, ty1, stride, base},
         n_paths, hw, join, s, {(float)max_lines, inv8tol, tol, num8tol},
         counts, spack};
  const int blocks = (s + kThreads - 1) / kThreads;
  if (hw != nullptr) {
    segment_prep_kernel<true><<<blocks, kThreads, 0, stream>>>(a);
  } else {
    segment_prep_kernel<false><<<blocks, kThreads, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

extern "C" int vt_segment_offsets(const int* counts, const int* incl,
                                  float* spack, int s, int cols,
                                  cudaStream_t stream) {
  if (s <= 0 || (cols != 16 && cols != 21)) return (int)cudaErrorInvalidValue;
  const int blocks = (s + kThreads - 1) / kThreads;
  segment_offsets_kernel<<<blocks, kThreads, 0, stream>>>(counts, incl, spack,
                                                          s, cols);
  return (int)cudaGetLastError();
}
