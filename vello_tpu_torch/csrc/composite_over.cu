// K7 layered draws op: premultiplied src rows over the (G, 4, 256) top
// layer buffer, in place.
//
// Replaces vello_tpu/ops/pallas_kernels.py:1183 fine_composite_over (body
// _fine_kernel_over, :1137), the draws op of the layered compositor
// (vello_tpu/pipeline/layered.py:381), in both of its instantiations: f32
// src (render_mode "quality", and "speed" where collapsed clip chains
// multiplied the src by f32 clip coverage) and bf16 src (render_mode
// "speed", the Pallas kernel's src.astype(f32) at :1172).
//
// What bounds it on the H100: memory. Each walked src row is read once
// (4 KB in f32, 2 KB in bf16: four channels of 256 pixels) and each tile
// with a non-empty walk is read and written once (4 KB each way); the
// blend is 9 flops per fragment and pixel. One op of layered_mmark-30k
// walks about a 24th of the frame's live rows, so a launch moves tens of
// MB.
//
// Design: K6's walk (composite_src.cu), but dst starts from the buffer's
// own tile instead of the base color, and the result is written back in
// place. One CTA per global tile, 256 threads, one per pixel, walking the
// op's rows [los[g], his[g]) of the (gtile, path)-sorted stream in draw
// order with the exact sequential dst = src + (1 - src.a) * dst. The TPU
// kernel re-sorted the stream by (op, tile) so that one grid step could
// read one span over 32 tiles, and composited 128-row chunks as a log/exp
// transmittance product (within ~2e-5 of exact); here the per-tile bounds
// come from a searchsorted on the sorted stream and the per-pixel loop
// needs neither. A CTA whose walk is empty returns at once, so a launch
// costs the op's rows and tiles, not the whole buffer. A bf16 src value is
// widened exactly to f32; the buffer and the arithmetic stay f32, so both
// instantiations equal the plain version bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ void walk(const T* __restrict__ src,
                                     const int* __restrict__ los,
                                     const int* __restrict__ his,
                                     float* __restrict__ buf) {
  const int g = blockIdx.x;
  const int lo = los[g];
  const int hi = his[g];
  if (lo >= hi) return;
  const int px = threadIdx.x;
  float* o = buf + (size_t)g * 1024 + px;
  float r = o[0], gr = o[256], b = o[512], a = o[768];
  for (int j = lo; j < hi; ++j) {
    const T* s = src + (size_t)j * 1024 + px;
    const float sa = widen(s[768]);
    const float m = 1.0f - sa;
    r = widen(s[0]) + m * r;
    gr = widen(s[256]) + m * gr;
    b = widen(s[512]) + m * b;
    a = sa + m * a;
  }
  o[0] = r;
  o[256] = gr;
  o[512] = b;
  o[768] = a;
}

__global__ void composite_over_kernel(const float* __restrict__ src,
                                      const int* __restrict__ los,
                                      const int* __restrict__ his,
                                      float* __restrict__ buf) {
  walk(src, los, his, buf);
}

__global__ void composite_over_bf16_kernel(
    const __nv_bfloat16* __restrict__ src, const int* __restrict__ los,
    const int* __restrict__ his, float* __restrict__ buf) {
  walk(src, los, his, buf);
}

}  // namespace

extern "C" int vt_composite_over(const float* src, const int* los,
                                 const int* his, int n_tiles, float* buf,
                                 cudaStream_t stream) {
  composite_over_kernel<<<n_tiles, 256, 0, stream>>>(src, los, his, buf);
  return (int)cudaGetLastError();
}

extern "C" int vt_composite_over_bf16(const __nv_bfloat16* src,
                                      const int* los, const int* his,
                                      int n_tiles, float* buf,
                                      cudaStream_t stream) {
  composite_over_bf16_kernel<<<n_tiles, 256, 0, stream>>>(src, los, his, buf);
  return (int)cudaGetLastError();
}
