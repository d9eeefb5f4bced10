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
// What bounds it on the H100: arithmetic. Every (touch, pixel) pair costs
// ~40 f32 operations including one IEEE divide; the kernel reads T x 32 B of
// touches (broadcast within a CTA) and writes F x 1 KB of coverage, so at
// the 1600x1600 filled_mmark-30k tier (T = 655360, F = 180224) the output
// write (184 MB) and the ~6.7e9 operations are of the same order.
//
// Design: one CTA per fragment f, 256 threads, one per tile pixel. Each
// thread walks the fragment's touches [starts[f], starts[f+1]) in stream
// order and keeps its sum in a register, then adds the backdrop, applies the
// fill rule and the centers threshold, and writes its pixel. Nothing crosses
// CTAs. The area formula keeps the Pallas op order, including the 1e-6
// nudge, the dy == 0 guard and the dyc != 0 select (a select, not a product:
// a can be inf there); with --fmad=false the kernel and its plain version
// (fine.coverage_area_plain) agree bit for bit.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

__global__ void coverage_area_kernel(const float* __restrict__ trow,
                                     const int* __restrict__ starts,
                                     const float* __restrict__ backdrop,
                                     const int* __restrict__ rule,
                                     const unsigned char* __restrict__ valid,
                                     int centers, float* __restrict__ out) {
  const int f = blockIdx.x;
  const int px_i = threadIdx.x;
  float* o = out + (size_t)f * 256 + px_i;
  if (!valid[f]) {
    *o = 0.0f;
    return;
  }
  const float px = (float)(px_i % 16);
  const float py = (float)(px_i / 16);
  float sum = 0.0f;
  const int t_end = starts[f + 1];
  for (int t = starts[f]; t < t_end; ++t) {
    const float* tr = trow + (size_t)t * 8;
    const float p0x = tr[0], p0y = tr[1], p1x = tr[2], p1y = tr[3];
    const float ye = tr[4];
    const float dx = p1x - p0x;
    const float dy = p1y - p0y;
    const float y = p0y - py;
    const float y0 = vt::clampf(y, 0.0f, 1.0f);
    const float y1 = vt::clampf(y + dy, 0.0f, 1.0f);
    const float dyc = y0 - y1;
    const float inv_dy = 1.0f / (dy == 0.0f ? 1.0f : dy);
    const float t0 = (y0 - y) * inv_dy;
    const float t1 = (y1 - y) * inv_dy;
    const float startx = p0x - px;
    const float x0 = startx + t0 * dx;
    const float x1 = startx + t1 * dx;
    const float xmin = fminf(fminf(x0, x1), 1.0f) - 1e-6f;
    const float xmax = fmaxf(x0, x1);
    const float b = fminf(xmax, 1.0f);
    const float c = fmaxf(b, 0.0f);
    const float d = fmaxf(xmin, 0.0f);
    const float a = (b + 0.5f * (d * d - c * c) - xmin) / (xmax - xmin);
    float area = dyc != 0.0f ? a * dyc : 0.0f;
    const float sgn = dx > 0.0f ? 1.0f : (dx < 0.0f ? -1.0f : 0.0f);
    area = area + sgn * vt::clampf(py - ye + 1.0f, 0.0f, 1.0f);
    sum += area;
  }
  const float w = backdrop[f] + sum;
  float cov = rule[f] == 1 ? fabsf(w - 2.0f * rintf(0.5f * w))
                           : fminf(fabsf(w), 1.0f);
  if (centers) cov = cov >= 0.5f ? 1.0f : 0.0f;
  *o = cov;
}

}  // namespace

extern "C" int vt_coverage_area(const float* trow, const int* starts,
                                const float* backdrop, const int* rule,
                                const unsigned char* valid, int n_frags,
                                int centers, float* out, cudaStream_t stream) {
  coverage_area_kernel<<<n_frags, 256, 0, stream>>>(trow, starts, backdrop,
                                                    rule, valid, centers, out);
  return (int)cudaGetLastError();
}
