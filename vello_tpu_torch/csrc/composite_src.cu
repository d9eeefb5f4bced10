// K6 src composite: premultiplied src rows -> (G, 4, 256) tiles.
//
// Replaces vello_tpu/ops/pallas_kernels.py:1084 fine_composite_solid (body
// _fine_kernel, :1035), the composite of frames with non-solid paints, in
// both of its instantiations: f32 src (render_mode "quality") and bf16 src
// (render_mode "speed", the Pallas kernel's src.astype(f32) at :1073).
//
// What bounds it on the H100: memory. Each live src row is read once
// (4 KB in f32, 2 KB in bf16: four channels of 256 pixels) and each tile
// written once (4 KB); the blend is 2 flops per channel. At 147456 rows
// and 10000 tiles that is ~645 MB in f32 (~0.19 ms at HBM speed) and
// ~343 MB in bf16.
//
// Design: K4's walk with a materialized src. One CTA per global tile, 256
// threads, one per pixel, walking the tile's fragments [los[g], his[g]) in
// draw order with dst = src + (1 - src.a) * dst from the base color: the
// exact sequential walk of fine.wgsl. The TPU kernel vectorized the walk
// over 128-fragment chunks as a log/exp transmittance product on the MXU,
// within ~2e-5 of exact; the per-pixel loop needs neither. los is already
// advanced past fragments hidden under an opaque full cover. Each step's
// four channel loads are coalesced rows (1 KB in f32, 512 B in bf16). A
// bf16 src value is widened exactly to f32 and everything else (dst, the
// arithmetic and its order) is the f32 kernel's, so both instantiations
// equal the plain version bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ void walk(const T* __restrict__ src,
                                     const float* __restrict__ base,
                                     const int* __restrict__ los,
                                     const int* __restrict__ his,
                                     float* __restrict__ out) {
  const int g = blockIdx.x;
  const int px = threadIdx.x;
  float r = base[0], gr = base[1], b = base[2], a = base[3];
  const int hi = his[g];
  for (int j = los[g]; j < hi; ++j) {
    const T* s = src + (size_t)j * 1024 + px;
    const float sa = widen(s[768]);
    const float m = 1.0f - sa;
    r = widen(s[0]) + m * r;
    gr = widen(s[256]) + m * gr;
    b = widen(s[512]) + m * b;
    a = sa + m * a;
  }
  float* o = out + (size_t)g * 1024 + px;
  o[0] = r;
  o[256] = gr;
  o[512] = b;
  o[768] = a;
}

__global__ void composite_src_kernel(const float* __restrict__ src,
                                     const float* __restrict__ base,
                                     const int* __restrict__ los,
                                     const int* __restrict__ his,
                                     float* __restrict__ out) {
  walk(src, base, los, his, out);
}

__global__ void composite_src_bf16_kernel(
    const __nv_bfloat16* __restrict__ src, const float* __restrict__ base,
    const int* __restrict__ los, const int* __restrict__ his,
    float* __restrict__ out) {
  walk(src, base, los, his, out);
}

}  // namespace

extern "C" int vt_composite_src(const float* src, const float* base,
                                const int* los, const int* his, int n_tiles,
                                float* out, cudaStream_t stream) {
  composite_src_kernel<<<n_tiles, 256, 0, stream>>>(src, base, los, his, out);
  return (int)cudaGetLastError();
}

extern "C" int vt_composite_src_bf16(const __nv_bfloat16* src,
                                     const float* base, const int* los,
                                     const int* his, int n_tiles, float* out,
                                     cudaStream_t stream) {
  composite_src_bf16_kernel<<<n_tiles, 256, 0, stream>>>(src, base, los, his,
                                                         out);
  return (int)cudaGetLastError();
}
