// K6 src composite: premultiplied src rows -> (G, 4, 256) tiles.
//
// Replaces vello_tpu/ops/pallas_kernels.py:1084 fine_composite_solid (body
// _fine_kernel, :1035), the composite of frames with non-solid paints.
//
// What bounds it on the H100: memory. Each live src row is read once
// (4 KB: four channels of 256 pixels) and each tile written once (4 KB);
// the blend is 2 flops per channel. At 147456 rows and 10000 tiles that is
// ~645 MB, about 0.19 ms at HBM speed.
//
// Design: K4's walk with a materialized src. One CTA per global tile, 256
// threads, one per pixel, walking the tile's fragments [los[g], his[g]) in
// draw order with dst = src + (1 - src.a) * dst from the base color: the
// exact sequential walk of fine.wgsl. The TPU kernel vectorized the walk
// over 128-fragment chunks as a log/exp transmittance product on the MXU,
// within ~2e-5 of exact; the per-pixel loop needs neither. los is already
// advanced past fragments hidden under an opaque full cover. Each step's
// four channel loads are coalesced 1 KB rows.

#include <cuda_runtime.h>

namespace {

__global__ void composite_src_kernel(const float* __restrict__ src,
                                     const float* __restrict__ base,
                                     const int* __restrict__ los,
                                     const int* __restrict__ his,
                                     float* __restrict__ out) {
  const int g = blockIdx.x;
  const int px = threadIdx.x;
  float r = base[0], gr = base[1], b = base[2], a = base[3];
  const int hi = his[g];
  for (int j = los[g]; j < hi; ++j) {
    const float* s = src + (size_t)j * 1024 + px;
    const float m = 1.0f - s[768];
    r = s[0] + m * r;
    gr = s[256] + m * gr;
    b = s[512] + m * b;
    a = s[768] + m * a;
  }
  float* o = out + (size_t)g * 1024 + px;
  o[0] = r;
  o[256] = gr;
  o[512] = b;
  o[768] = a;
}

}  // namespace

extern "C" int vt_composite_src(const float* src, const float* base,
                                const int* los, const int* his, int n_tiles,
                                float* out, cudaStream_t stream) {
  composite_src_kernel<<<n_tiles, 256, 0, stream>>>(src, base, los, his, out);
  return (int)cudaGetLastError();
}
