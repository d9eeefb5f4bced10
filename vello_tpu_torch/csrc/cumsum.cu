// K8 column cumsum: out[t, c] = x[0, c] + ... + x[t, c] for a contiguous
// (T, C) f32 array, any T >= 0 and C >= 1.
//
// Replaces vello_tpu/ops/pallas_kernels.py:496 cumsum_pallas (body
// _cumsum_kernel :475), which the JAX package reaches through
// vello_tpu/ops/segmented.py:60 _cumsum0: on its unrolled layered path, the
// per-tile clip coverage of each clipped push (segment_sum_sorted,
// vello_tpu/pipeline/layered.py:519).
//
// What bounds it on the H100: memory. The function reads T x C x 4 bytes and
// writes as many, with one add per element.
//
// Design: the TPU kernel ran its grid in order on one core, scanned each
// block of rows with a Hillis-Steele ladder in VMEM and carried the last row
// from one grid step to the next. CTAs run in no order, so the carry becomes
// two more passes over blocks of `rows` rows:
//   1. block totals: one CTA per (block, 128 columns), one thread per column,
//      sums the block's rows of its column into tot[b, c];
//   2. block carries: one CTA per column turns tot[:, c] into exclusive
//      prefixes in place (each of 256 threads sums a run of blocks, a
//      shared-memory scan joins the runs);
//   3. one CTA per (block, 128 columns) walks its rows again from the carry
//      and writes every prefix.
// A warp reads and writes 32 neighbouring columns of one row (128 contiguous
// bytes). x is read twice and out written once: 1.5x the bytes of the bound.
// The sums run in f64 and each output is rounded to f32 once, so the result
// does not depend on the block split: it is the exact prefix rounded to f32
// (to within f64 rounding), as torch.cumsum gives it on the CPU, where it
// accumulates f32 in f64. Offsets are 64-bit. The caller allocates tot,
// ceil(T / rows) x C doubles.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COLS = 128;          // columns per CTA of passes 1 and 3
constexpr int SCAN_THREADS = 256;  // threads per column in pass 2

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__global__ void cumsum_totals_kernel(const float* __restrict__ x, int64_t t,
                                     int c, int rows,
                                     double* __restrict__ tot) {
  const int col = blockIdx.y * COLS + threadIdx.x;
  if (col >= c) return;
  const int64_t b = blockIdx.x;
  const int64_t r0 = b * rows;
  const int n = (int)min64(rows, t - r0);
  const float* p = x + r0 * c + col;
  double s = 0.0;
#pragma unroll 8
  for (int i = 0; i < n; ++i) s += (double)p[(int64_t)i * c];
  tot[b * c + col] = s;
}

__global__ void cumsum_carries_kernel(double* __restrict__ tot, int64_t nb,
                                      int c) {
  __shared__ double part[SCAN_THREADS];
  const int col = blockIdx.x;
  const int tid = threadIdx.x;
  const int64_t per = (nb + SCAN_THREADS - 1) / SCAN_THREADS;
  const int64_t b0 = min64(nb, (int64_t)tid * per);
  const int64_t b1 = min64(nb, b0 + per);
  double s = 0.0;
  for (int64_t b = b0; b < b1; ++b) s += tot[b * c + col];
  part[tid] = s;
  __syncthreads();
  for (int off = 1; off < SCAN_THREADS; off <<= 1) {
    const double v = tid >= off ? part[tid - off] : 0.0;
    __syncthreads();
    part[tid] += v;
    __syncthreads();
  }
  double carry = tid > 0 ? part[tid - 1] : 0.0;
  for (int64_t b = b0; b < b1; ++b) {
    const double v = tot[b * c + col];
    tot[b * c + col] = carry;
    carry += v;
  }
}

__global__ void cumsum_rows_kernel(const float* __restrict__ x, int64_t t,
                                   int c, int rows,
                                   const double* __restrict__ tot,
                                   float* __restrict__ out) {
  const int col = blockIdx.y * COLS + threadIdx.x;
  if (col >= c) return;
  const int64_t b = blockIdx.x;
  const int64_t r0 = b * rows;
  const int n = (int)min64(rows, t - r0);
  const int64_t o = r0 * c + col;
  double s = tot[b * c + col];
#pragma unroll 8
  for (int i = 0; i < n; ++i) {
    s += (double)x[o + (int64_t)i * c];
    out[o + (int64_t)i * c] = (float)s;
  }
}

}  // namespace

extern "C" int vt_cumsum(const float* x, int64_t t, int c, int rows,
                         double* tot, float* out, cudaStream_t stream) {
  const int64_t nb = (t + rows - 1) / rows;
  const dim3 grid((unsigned)nb, (unsigned)((c + COLS - 1) / COLS));
  cumsum_totals_kernel<<<grid, COLS, 0, stream>>>(x, t, c, rows, tot);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cumsum_carries_kernel<<<c, SCAN_THREADS, 0, stream>>>(tot, nb, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cumsum_rows_kernel<<<grid, COLS, 0, stream>>>(x, t, c, rows, tot, out);
  return (int)cudaGetLastError();
}
