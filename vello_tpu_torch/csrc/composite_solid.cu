// K4 solid composite: coverage rows + solid colors -> (G, 4, 256) tiles.
//
// Replaces vello_tpu/ops/pallas_kernels.py:1303 fine_composite_solid_cov
// (body _fine_cov_kernel, :1248).
//
// What bounds it on the H100: memory. Each fragment row is read once
// (1 KB of coverage plus 16 bytes of color) and each tile written once
// (4 KB); the blend is 5 flops per channel. At 131k fragments and 10000
// tiles that is ~175 MB.
//
// Design: one CTA per global tile, 256 threads, one per pixel, walking the
// tile's fragments [los[g], his[g]) in draw order with the premultiplied
// src-over dst = col * cov + (1 - col.a * cov) * dst from the base color:
// the exact sequential walk of fine.wgsl. The TPU kernel vectorized the
// walk over 128-fragment chunks as a log/exp transmittance product on the
// MXU, which only matches within ~2e-5; the per-pixel loop needs neither.
// los is already advanced past fragments hidden under an opaque full
// cover (occlusion_los_kernel below). Coverage loads are coalesced (one 1 KB
// row per step); the color is a broadcast.
//
// occlusion_los_kernel: the walks' starts. For each tile g, los[g] is the
// LAST fragment of [starts[g], starts[g + 1]) that is opaque and fully
// covers the tile (all 256 coverage values >= thr), or starts[g] if there
// is none: everything below it is hidden. Replaces the library chain of
// ops/kernels.occlusion_los_plain (amin over every row, a cummax over every
// fragment, a gather and a clamp; the JAX package's occlusion_los in
// vello_tpu/pipeline/render.py, an XLA cummax). A prefix max reaching back
// into an earlier tile only ever clamps to the tile's start, so the global
// scan is a search within each tile.
//
// What bounds it: memory latency. It reads at most what K4 reads after it:
// the rows of [los, his) and at most 7 below, of those only the opaque ones,
// and of most of these only their first 128 bytes. The first 128 bytes
// settle most rows (a stroke rarely fills a tile's first two pixel rows):
// on an H100 (700 W), on the 1600x900 stroked msaa16 frame's 818,284 live
// rows in 5,700 tiles, the walk took 0.087 ms, and 0.226 ms loading every
// row whole.
//
// Design: one CTA per tile, 8 warps, walking down from the tile's top
// fragment in windows of 8, one warp per fragment. A warp whose fragment is
// not opaque loads nothing. Otherwise its lanes first load the row's first
// 32 values (128 bytes, one a lane) and vote; only if all of them are full
// does the warp load the whole row (two float4 a lane) and vote again. The
// CTA stops at the first window with a full fragment and takes the highest
// one, so no row below that window is read. A NaN fails the compare, as it
// fails torch.amin's; thr is the f32 value torch compares an f32 tensor
// against for ``>= 1.0 - 1e-6`` (the wrapper's FULL_COVER_F32).

#include <cuda_runtime.h>

namespace {

constexpr int kWalkWarps = 8;

__global__ void composite_solid_kernel(const float* __restrict__ cov,
                                       const float* __restrict__ col,
                                       const float* __restrict__ base,
                                       const int* __restrict__ los,
                                       const int* __restrict__ his,
                                       float* __restrict__ out) {
  const int g = blockIdx.x;
  const int px = threadIdx.x;
  float r = base[0], gr = base[1], b = base[2], a = base[3];
  const int hi = his[g];
  for (int j = los[g]; j < hi; ++j) {
    const float c = cov[(size_t)j * 256 + px];
    const float* cl = col + (size_t)j * 4;
    const float m = 1.0f - cl[3] * c;
    r = cl[0] * c + m * r;
    gr = cl[1] * c + m * gr;
    b = cl[2] * c + m * b;
    a = cl[3] * c + m * a;
  }
  float* o = out + (size_t)g * 1024 + px;
  o[0] = r;
  o[256] = gr;
  o[512] = b;
  o[768] = a;
}

__global__ void occlusion_los_kernel(const float* __restrict__ cov,
                                     const unsigned char* __restrict__ opaque,
                                     const int* __restrict__ starts, float thr,
                                     int* __restrict__ los) {
  const unsigned kAll = 0xffffffffu;
  __shared__ int hit[kWalkWarps];
  const int g = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lo = starts[g];
  for (int top = starts[g + 1] - 1; top >= lo; top -= kWalkWarps) {
    const int j = top - warp;
    bool full = false;
    if (j >= lo && opaque[j]) {  // uniform over the warp
      const float* row = cov + (size_t)j * 256;
      full = __all_sync(kAll, row[lane] >= thr);
      if (full) {
        const float4* r4 = reinterpret_cast<const float4*>(row) + 2 * lane;
        const float4 a = r4[0], b = r4[1];
        full = __all_sync(kAll, a.x >= thr && a.y >= thr && a.z >= thr &&
                                    a.w >= thr && b.x >= thr && b.y >= thr &&
                                    b.z >= thr && b.w >= thr);
      }
    }
    if (lane == 0) hit[warp] = full;
    // hit[] is read only after a barrier that found a hit, after which no
    // warp writes it again
    if (__syncthreads_or(full)) {
      if (threadIdx.x == 0) {
        int w = 0;
        while (!hit[w]) ++w;
        los[g] = top - w;
      }
      return;
    }
  }
  if (threadIdx.x == 0) los[g] = lo;
}

}  // namespace

extern "C" int vt_occlusion_los(const float* cov, const unsigned char* opaque,
                                const int* starts, int n_tiles, float thr,
                                int* los, cudaStream_t stream) {
  occlusion_los_kernel<<<n_tiles, kWalkWarps * 32, 0, stream>>>(
      cov, opaque, starts, thr, los);
  return (int)cudaGetLastError();
}

extern "C" int vt_composite_solid(const float* cov, const float* col,
                                  const float* base, const int* los,
                                  const int* his, int n_tiles, float* out,
                                  cudaStream_t stream) {
  composite_solid_kernel<<<n_tiles, 256, 0, stream>>>(cov, col, base, los, his,
                                                      out);
  return (int)cudaGetLastError();
}
