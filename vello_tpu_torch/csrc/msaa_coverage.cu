// K3 msaa coverage: fragment-sorted touches -> (N, 256) coverage rows.
//
// Replaces vello_tpu/ops/pallas_kernels.py:349 msaa_coverage_pallas
// (_msaa_coverage_common :371, bodies _msaa_cov_kernel :136 and
// _msaa_block :231) together with the rank / window-base / flags packing
// and the row gather around it (vello_tpu/pipeline/render.py:66-150).
//
// What bounds it on the H100: instruction issue and the latency of each
// fragment's short chains (its row's touch range, then its touches, then
// the barrier-separated phases below). A touch's crossing test and
// crossing x depend on the sample row (tile row y, sample s) only, not on
// the pixel, so each is computed once per (touch, row, sample); the 16
// pixels of the row then differ only in where the crossing falls among
// their sample positions. Memory traffic (32 B per touch read, a 1 KB row
// per fragment written) is small beside that, and beside the per (pixel,
// sample) fill rule of the resolve.
//
// Design: one CTA of kThreads per live sorted fragment row at ns 16, per
// two rows at ns 8; in the touch phase each thread owns one sample s and
// KR tile rows y, y + 16 / KR, ... of its row's fragment. Fewer, busier
// threads amortize a fragment's fixed work and keep KR independent chains
// in flight; 2 rows ran fastest of 1, 2, 4 and 8 (PERF.md §6).
//  1. The fragment's touches [starts[f], starts[f+1]) (f = fidx[i]) are
//     staged in shared memory, one touch per thread and chunk, as their
//     per-touch terms (ymin, ymax, a = inv_dy * dx, the signs): the IEEE
//     divide runs once per touch.
//  2. For each of its sample rows sy, a thread tests each touch once:
//     crossing, xt = x0 + (sy - y0) * a (the Pallas op order, so coverage
//     equals the JAX package's), and the first pixel x whose sample x + c_s
//     lies right of xt (first_right), where the winding step sgn starts.
//     It adds sgn there in the sample row's difference row of 17 int32 in
//     shared memory (slot 16, no pixel, is never written), and the
//     left-edge term sgn_dx of sy >= ye to a register.
//  3. Resolve: the thread turns its difference rows into windings (a
//     prefix sum) in place; then each thread takes KR pixels of the
//     fragment, reads their ns windings, adds the backdrop, applies the
//     fill rule per sample in sample order and writes k/ns, coalesced.
//     Windings are integers, so the order in which a sample's touches add
//     up does not show.
// A fragment without touches (or invalid) skips the difference rows; its
// windings are 0.

#include <cuda_runtime.h>

namespace {

constexpr int KR = 2;  // sample rows per thread: 1, 2, 4 or 8
constexpr int kThreads = 256 / KR;
constexpr int kRow = 17;  // 16 pixels + the no-pixel slot; odd: no bank
                          // conflicts between the rows of a warp

// The column of sample s in the D3D11 standard patterns, one nibble per
// sample (8: 0 5 3 7 1 4 6 2; 16: 1 8 4 11 15 7 3 12 0 9 5 13 2 10 6 14),
// so that a thread's own sample index selects it without a local array.
template <int NS>
__device__ __forceinline__ int sample_col(int s) {
  constexpr unsigned long long pat =
      NS == 8 ? 0x26417350ull : 0xe6a2d590c37fb481ull;
  return (int)((pat >> (4 * s)) & 15);
}

// The least pixel x in [0, 16] with xt < x + cs (the exact f32 compare of
// the plain version), 16 when there is none (NaN included): floor(xt - cs)
// + 1, clamped. The subtraction is exact wherever the floor matters. cs is
// a multiple of 1/32, so of xt's ulp for |xt| < 2^19: for xt >= cs / 2 the
// difference is a multiple of that ulp and no larger than xt (Sterbenz
// below 2 cs); below cs / 2 it is under -cs / 2, where any rounding only
// moves a threshold that clamps to 0; from 2^19 on it clamps to 16.
__device__ __forceinline__ int first_right(float xt, float cs) {
  const float d = fmaxf(fminf(xt - cs, 16.0f), -1.0f);
  return min(__float2int_rd(d) + 1, 16);
}

template <int NS>
__global__ void __launch_bounds__(kThreads)
    msaa_coverage_kernel(const float* __restrict__ trow,
                         const int* __restrict__ starts,
                         const int* __restrict__ fidx,
                         const float* __restrict__ backdrop,
                         const int* __restrict__ rule,
                         const unsigned char* __restrict__ valid,
                         int n_rows, int has_evenodd,
                         float* __restrict__ out) {
  constexpr int kFrags = 16 / NS;          // output rows per CTA
  constexpr int kPer = kThreads / kFrags;  // threads per output row
  constexpr int kStep = 16 / KR;           // a thread's rows y + j * kStep
  constexpr int kRowStep = kStep * NS * kRow;
  __shared__ float4 touch[kThreads][2];
  // one difference row, then winding row, per (tile row, sample)
  __shared__ int wind[16 * 16 * kRow];

  const int tid = threadIdx.x;
  const int q = tid / kPer;                // this thread's output row
  const int r = tid % kPer;
  const int s = r % NS;
  const int y = r / NS;
  float sy[KR];
#pragma unroll
  for (int j = 0; j < KR; ++j)
    sy[j] = (float)(y + j * kStep) + (s + 0.5f) / NS;
  const float cs = (sample_col<NS>(s) + 0.5f) / NS;

  // the touch ranges of the CTA's rows: empty past n_rows and for an
  // invalid fragment
  int lo = 0, cnt = 0, max_cnt = 0;
#pragma unroll
  for (int k = 0; k < kFrags; ++k) {
    const int i = blockIdx.x * kFrags + k;
    int lo_k = 0, cnt_k = 0;
    if (i < n_rows && valid[fidx[i]]) {
      lo_k = starts[fidx[i]];
      cnt_k = starts[fidx[i] + 1] - lo_k;
    }
    if (k == q) {
      lo = lo_k;
      cnt = cnt_k;
    }
    max_cnt = max(max_cnt, cnt_k);
  }

  // row y + j * kStep of sample s at diff + j * kRowStep
  int* diff = wind + (q * 16 * NS + y * NS + s) * kRow;
  if (cnt > 0) {
#pragma unroll
    for (int j = 0; j < KR; ++j)
#pragma unroll
      for (int x = 0; x < 16; ++x) diff[j * kRowStep + x] = 0;
  }
  int edge[KR];
#pragma unroll
  for (int j = 0; j < KR; ++j) edge[j] = 0;
  const float4* mine = touch[q * kPer];
  for (int c0 = 0; c0 < max_cnt; c0 += kPer) {
    // 1. stage: this thread's touch of the chunk, with its per-touch terms
    if (c0 + r < cnt) {
      const float4* tr =
          reinterpret_cast<const float4*>(trow + (size_t)(lo + c0 + r) * 8);
      const float4 p = tr[0];
      const float ye = tr[1].x;
      const float dx = p.z - p.x;
      const float dy = p.w - p.y;
      const float inv_dy = 1.0f / (dy == 0.0f ? 1.0f : dy);
      const int sgn = dy > 0.0f ? -1 : 1;
      const int sgn_dx = dx > 0.0f ? 1 : (dx < 0.0f ? -1 : 0);
      touch[tid][0] = make_float4(p.x, p.y, fminf(p.y, p.w), fmaxf(p.y, p.w));
      touch[tid][1] = make_float4(inv_dy * dx, ye, __int_as_float(sgn),
                                  __int_as_float(sgn_dx));
    }
    __syncthreads();
    // 2. each touch once per (row, sample)
    const int n = min(kPer, cnt - c0);
    for (int k = 0; k < n; ++k) {
      const float4 u = mine[2 * k];       // x0, y0, ymin, ymax
      const float4 v = mine[2 * k + 1];   // a, ye, sgn, sgn_dx
#pragma unroll
      for (int j = 0; j < KR; ++j) {
        if (sy[j] >= u.z && sy[j] < u.w) {
          const int x = first_right(u.x + (sy[j] - u.y) * v.x, cs);
          if (x < 16) diff[j * kRowStep + x] += __float_as_int(v.z);
        }
        edge[j] += sy[j] >= v.y ? __float_as_int(v.w) : 0;
      }
    }
    __syncthreads();
  }

  // 3. windings per pixel, then the resolve with KR pixels per thread
  if (cnt > 0) {
#pragma unroll
    for (int j = 0; j < KR; ++j) {
      int w = edge[j];
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        w += diff[j * kRowStep + x];
        diff[j * kRowStep + x] = w;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kFrags; ++k) {
    const int i = blockIdx.x * kFrags + k;
    if (i >= n_rows) break;
    const int f = fidx[i];
    const bool ok = valid[f];
    const bool touched = starts[f + 1] > starts[f];
    const float bd = backdrop[f];
    const bool evenodd = has_evenodd && rule[f] == 1;
#pragma unroll
    for (int h = 0; h < KR; ++h) {
      const int pix = tid + h * kThreads;
      float cov = 0.0f;
      if (ok) {
        const int* wk =
            wind + (k * 16 * NS + pix / 16 * NS) * kRow + pix % 16;
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float wf = (float)(touched ? wk[j * kRow] : 0) + bd;
          sum += evenodd ? fabsf(wf - 2.0f * rintf(0.5f * wf))
                         : fminf(fabsf(wf), 1.0f);
        }
        cov = sum / NS;
      }
      out[(size_t)i * 256 + pix] = cov;
    }
  }
}

}  // namespace

extern "C" int vt_msaa_coverage(const float* trow, const int* starts,
                                const int* fidx, const float* backdrop,
                                const int* rule, const unsigned char* valid,
                                int n_rows, int ns, int has_evenodd,
                                float* out, cudaStream_t stream) {
  if (ns == 8)
    msaa_coverage_kernel<8><<<(n_rows + 1) / 2, kThreads, 0, stream>>>(
        trow, starts, fidx, backdrop, rule, valid, n_rows, has_evenodd, out);
  else if (ns == 16)
    msaa_coverage_kernel<16><<<n_rows, kThreads, 0, stream>>>(
        trow, starts, fidx, backdrop, rule, valid, n_rows, has_evenodd, out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
