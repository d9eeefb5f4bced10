// K5 area coverage: fragment-sorted touches -> (F, 256) exact-area coverage.
//
// Replaces vello_tpu/ops/pallas_kernels.py:84 coverage_cumsum_pallas (body
// _cov_kernel :31) together with the cumsum differencing, backdrop add,
// fill rule, centers threshold and valid mask around it
// (vello_tpu/pipeline/render.py:406-430).
//
// The TPU kernel wrote the inclusive running cumsum of the (T, 256) per-touch
// area tensor over the whole touch stream (its sequential grid carried the
// sum in VMEM), and the caller took differences at the segment starts. That
// (T, 256) tensor (671 MB at 655360 touches) exists only because of the
// carry; here each fragment sums its own touches directly, which is also
// the more exact of the two (a cumsum difference carries about an ulp of
// the running sum).
//
// What bounds it on the H100: the F x 1 KB coverage write (184 MB at the
// 1600x1600 filled_mmark-30k tier, F = 180224) against instruction issue
// and the latency of each fragment's short chain of dependent loads
// (its touch range, then its touches). Of the area formula, dx, 1 / dy and
// the sign belong to the touch; y, the clamped y0 and y1, dyc, t0, t1 and
// the left-edge term belong to the (touch, tile row); only the x chain
// (from x0 = fma(t0, dx, startx) on) and its quotient belong to the pixel,
// and only where the touch crosses the row (dyc != 0): a short touch
// crosses a few of the 16 rows.
//
// Design: one CTA of kThreads per fragment f, each thread kPix pixels of
// one column (rows y, y + 16 / kPix, ...): fewer, busier threads amortize
// a fragment's fixed work and keep kPix independent sums in flight (4
// pixels ran fastest of 1, 2, 4 and 8: PERF.md §6).
// The fragment's metadata loads are issued together. Per chunk
// of kThreads / 16 touches, thread (k, r) computes the row terms of touch
// k for tile row r into shared memory; then each thread walks the chunk's
// touches in stream order (the plain version's order of additions: these
// are real f32 sums), runs the x chain where dyc != 0 and adds area plus
// edge term to each of its sums. Then the backdrop, the fill rule, the
// centers threshold and the writes. Every term keeps the Pallas op order,
// including the 1e-6 nudge, the dy == 0 guard and the dyc != 0 select (the
// area is 0 where dyc is 0, whatever the quotient: it can be inf there),
// and the two fused multiply-adds that XLA contracts in the JAX package's
// formula (x0 and x1, and d * d - c * c as fma(d, d, -(c * c)); for an
// exactly vertical touch they move the area by up to 0.06, and the
// goldens carry them): __fmaf_rn, with --fmad=false everywhere else, so
// the kernel and its plain version (fine.coverage_area_plain, whose fma is
// exact too) agree bit for bit.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kPix = 4;  // pixels per thread, one column: 1, 2, 4 or 8
constexpr int kThreads = 256 / kPix;
constexpr int kChunk = kThreads / 16;   // touches staged per pass

// The area of a touch with x extent dx in the row whose terms rt are
// (dyc != 0, t0, t1, edge), at the pixel px columns right of the touch's
// x0 = sx.
__device__ __forceinline__ float crossed_area(float4 rt, float sx, float dx,
                                              float px) {
  const float startx = sx - px;
  const float x0 = __fmaf_rn(rt.y, dx, startx);
  const float x1 = __fmaf_rn(rt.z, dx, startx);
  const float xmin = fminf(fminf(x0, x1), 1.0f) - 1e-6f;
  const float xmax = fmaxf(x0, x1);
  const float b = fminf(xmax, 1.0f);
  const float c = fmaxf(b, 0.0f);
  const float d = fmaxf(xmin, 0.0f);
  const float a =
      (b + 0.5f * __fmaf_rn(d, d, -(c * c)) - xmin) / (xmax - xmin);
  return a * rt.x;
}

__global__ void __launch_bounds__(kThreads)
    coverage_area_kernel(const float* __restrict__ trow,
                         const int* __restrict__ starts,
                         const float* __restrict__ backdrop,
                         const int* __restrict__ rule,
                         const unsigned char* __restrict__ valid,
                         int centers, float* __restrict__ out) {
  // per (touch, row): dyc, t0, t1, sgn * clamp(py - ye + 1, 0, 1); per
  // touch: x0, dx
  __shared__ float4 row_terms[kChunk][16];
  __shared__ float2 start_dx[kChunk];
  const int f = blockIdx.x;
  const int tid = threadIdx.x;
  float* o = out + (size_t)f * 256 + tid;
  const bool ok = valid[f];
  const int lo = starts[f];
  const int hi = starts[f + 1];
  const float bd = backdrop[f];
  const bool evenodd = rule[f] == 1;
  if (!ok) {
#pragma unroll
    for (int h = 0; h < kPix; ++h) o[h * kThreads] = 0.0f;
    return;
  }
  // walking role: pixels (lo4, hi4 + h * 16 / kPix); staging role: touch
  // hi4 of the chunk at tile row lo4
  const int lo4 = tid % 16;
  const int hi4 = tid / 16;
  const float px = (float)lo4;
  const float row = (float)lo4;
  float sum[kPix];
#pragma unroll
  for (int h = 0; h < kPix; ++h) sum[h] = 0.0f;
  for (int c0 = lo; c0 < hi; c0 += kChunk) {
    const int t = c0 + hi4;
    if (t < hi) {
      const float* tr = trow + (size_t)t * 8;
      const float4 p = *reinterpret_cast<const float4*>(tr);  // p0, p1
      const float ye = tr[4];
      const float dx = p.z - p.x;
      const float dy = p.w - p.y;
      const float y = p.y - row;
      const float y0 = vt::clampf(y, 0.0f, 1.0f);
      const float y1 = vt::clampf(y + dy, 0.0f, 1.0f);
      const float inv_dy = 1.0f / (dy == 0.0f ? 1.0f : dy);
      const float t0 = (y0 - y) * inv_dy;
      const float t1 = (y1 - y) * inv_dy;
      const float sgn = dx > 0.0f ? 1.0f : (dx < 0.0f ? -1.0f : 0.0f);
      row_terms[hi4][lo4] =
          make_float4(y0 - y1, t0, t1,
                      sgn * vt::clampf(row - ye + 1.0f, 0.0f, 1.0f));
      if (lo4 == 0) start_dx[hi4] = make_float2(p.x, dx);
    }
    __syncthreads();
    const int n = min(kChunk, hi - c0);
    for (int k = 0; k < n; ++k) {
      const float2 sd = start_dx[k];
#pragma unroll
      for (int h = 0; h < kPix; ++h) {
        const float4 rt = row_terms[k][hi4 + h * (16 / kPix)];
        float area = 0.0f;
        if (rt.x != 0.0f) area = crossed_area(rt, sd.x, sd.y, px);
        sum[h] += area + rt.w;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int h = 0; h < kPix; ++h) {
    const float w = bd + sum[h];
    float cov = evenodd ? fabsf(w - 2.0f * rintf(0.5f * w))
                        : fminf(fabsf(w), 1.0f);
    if (centers) cov = cov >= 0.5f ? 1.0f : 0.0f;
    o[h * kThreads] = cov;
  }
}

}  // namespace

extern "C" int vt_coverage_area(const float* trow, const int* starts,
                                const float* backdrop, const int* rule,
                                const unsigned char* valid, int n_frags,
                                int centers, float* out, cudaStream_t stream) {
  coverage_area_kernel<<<n_frags, kThreads, 0, stream>>>(
      trow, starts, backdrop, rule, valid, centers, out);
  return (int)cudaGetLastError();
}
