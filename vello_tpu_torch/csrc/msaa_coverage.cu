// K3 msaa coverage: fragment-sorted touches -> (N, 256) coverage rows.
//
// Replaces vello_tpu/ops/pallas_kernels.py:349 msaa_coverage_pallas
// (_msaa_coverage_common :371, bodies _msaa_cov_kernel :136 and
// _msaa_block :231) together with the rank / window-base / flags packing
// and the row gather around it (vello_tpu/pipeline/render.py:66-150).
//
// A fragment's coverage row is 16 x 16 pixels of ns samples each. Sample
// s of tile row y sits on the sample row sy = y + (s + 0.5) / ns, at
// x + c_s in pixel x. A touch's crossing test and crossing x depend on the
// sample row only, so each is computed once per (touch, sample row); the
// 16 pixels of the row then differ only in where the crossing falls among
// their samples: the winding steps by the touch's sign from the first
// pixel x whose sample lies right of the crossing (first_right) on.
//
// Design: kParts = 2 warps per fragment row, each of half its tile rows,
// no barrier between them; persistent warps that load ahead (below).
// Lane = s + ns * h owns sample s of the tile rows y = H * j + h (H = 32
// / ns lanes per sample; j its "blocks", 0 .. 16 / H - 1, the warp's half
// of them). The windings of a lane's sample rows live in registers, bit
// sliced: plane p holds bit p of the windings of 32 pixels, two blocks of
// 16 pixels per 32-bit word (block j in half j & 1 of word j / 2), as
// integers modulo 2^K, the backdrop set before the first touch.
//  1. The warp stages its row's touches 32 at a time in its own shared
//     memory, one touch per lane, as their per-touch terms (the IEEE
//     divide runs once per touch), the sign's mask, and the bit mask of
//     the blocks whose tile rows the touch's y range can reach; a ballot
//     picks the touches that reach the warp's blocks or carry an edge term.
//  2. Each such touch, broadcast from shared memory, is tested in the
//     words its mask names (a branch the whole warp takes alike): for both
//     blocks of the word, crossing, xt = x0 + (sy - y0) * a (the Pallas op
//     order, so coverage equals the JAX package's), first_right, and the
//     mask of the pixels from first_right on; the word's mask is added
//     (sign +1) or subtracted (-1) through the K planes as a ripple carry,
//     two logic ops a plane. The left-edge term sgn_dx of sy >= ye, the
//     same for all 16 pixels of a sample row, is kept as one int a block
//     and added through the planes at the end.
//  3. Resolve without a grid: a pixel's sample counts iff its winding is
//     not 0 (nonzero: the OR of the planes) or odd (even-odd: plane 0,
//     K = 1). A 32 x 32 bit transpose across the warp (five shuffles)
//     turns each word's per-sample-row pixel bits into per-pixel sample
//     bits, and a popc over a pixel's ns lanes is its count; the value
//     written is count / ns.
// Exactness: windings are integers (touch signs, edge terms, and a
// backdrop that is an integer sum of +-1), so each of the plain version's
// per sample terms fminf(|w|, 1) or |w - 2 rint(w / 2)| is exactly 0 or 1,
// and a count of ones over 8 or 16 is exact in f32: the row is bit-equal
// to fine.msaa_coverage_plain. A winding's magnitude is at most
// 2 n + |backdrop| for a row of n touches, so K bits hold it exactly when
// that is below 2^K; the kernel picks K from each row's own count and
// backdrop: 4, 6, 8 or 16 planes (16 in two passes over half the warp's
// blocks each, so that no path holds more than 16 plane registers), 1 for
// even-odd. A row whose backdrop is not an integer below 2^16, or whose
// windings could reach 2^16, takes a generic path: exact int windings per
// block, the f32 fill rule per sample and the sum in sample order, as the
// plain version. A fragment without touches writes the fill rule of its
// backdrop everywhere; an invalid one writes 0.
//
// What bounds it on the H100: integer issue. Compares, min/max, shifts and
// logic run at half the f32 rate; a word a touch reaches costs about 45
// instructions, 28 of them such (the crossing tests, first_right, the
// step masks, the ripple carry), and a touch reaches about 1.5 words on
// the stroked cells, beside some 15 instructions a warp to pick, read and
// test it; a row's set-up and resolve cost a few hundred. Shared memory
// carries two broadcast loads a touch and warp; memory traffic (32 B per
// touch read, a 1 KB row written) is small beside the issue.

#include <cuda_runtime.h>

namespace {

constexpr int kParts = 2;     // warps per row, each of half its blocks
constexpr int kThreads = 128;  // a CTA: kThreads / 32 / kParts rows at once
constexpr unsigned kFull = 0xffffffffu;
// staged touch flags: bits 0-7 the blocks it reaches, then these
constexpr unsigned kEdge = 1u << 8;     // has a left-edge term in the tile
constexpr unsigned kEdgeNeg = 1u << 9;  // ... of sign -1 (dx < 0)

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

// The plain version's per-sample fill rule of an f32 winding.
__device__ __forceinline__ float fill_term(float w, bool evenodd) {
  return evenodd ? fabsf(w - 2.0f * rintf(0.5f * w)) : fminf(fabsf(w), 1.0f);
}

template <int NS>
struct Lanes {
  static constexpr int H = 32 / NS;   // tile rows of a block
  static constexpr int NJ = 16 / H;   // blocks of a lane
  static constexpr int NW = NJ / 2;   // words of a plane
  static constexpr int NWW = NW / kParts;  // words of a warp
};

// A touch as read: (x0, y0, x1, y1) and ye.
struct Touch {
  float4 p;
  float ye;
};

__device__ __forceinline__ Touch load_touch(const float* __restrict__ trow,
                                            int t) {
  const float4* tr = reinterpret_cast<const float4*>(trow + (size_t)t * 8);
  return Touch{tr[0], tr[1].x};
}

// A touch's terms into a staging slot: (x0, y0, a = inv_dy * dx, ye) and
// (ymin, ymax, flags).
template <int NS>
__device__ __forceinline__ void stage_touch(const Touch& r, float4* slot) {
  constexpr int H = Lanes<NS>::H;
  const float4 p = r.p;
  const float dx = p.z - p.x;
  const float dy = p.w - p.y;
  const float inv_dy = 1.0f / (dy == 0.0f ? 1.0f : dy);
  const float ymin = fminf(p.y, p.w);
  const float ymax = fmaxf(p.y, p.w);
  // the blocks j with ymin < H (j + 1) and ymax > H j, and more for a NaN
  // (the crossing test decides)
  const float jl = fmaxf(ymin * (1.0f / H), 0.0f);
  const float jh = fminf(ymax * (1.0f / H), (float)Lanes<NS>::NJ);
  unsigned flags = 0u;
  if (jl < jh) flags |= (2u << ((int)ceilf(jh) - 1)) - (1u << (int)jl);
  // sy < 16 on every sample row
  if (r.ye < 16.0f && (dx > 0.0f || dx < 0.0f))
    flags |= kEdge | (dx < 0.0f ? kEdgeNeg : 0u);
  slot[0] = make_float4(p.x, p.y, inv_dy * dx, r.ye);
  slot[1] = make_float4(ymin, ymax, __uint_as_float(flags),
                        __uint_as_float(dy > 0.0f ? kFull : 0u));
}

// A row's fragment: its touches [lo, lo + cnt) (none when invalid), its
// backdrop and fill rule.
struct Row {
  int lo, cnt;
  float bd;
  bool ok, evenodd;
};

__device__ __forceinline__ Row load_row(int f, const int* __restrict__ starts,
                                        const float* __restrict__ backdrop,
                                        const int* __restrict__ rule,
                                        const unsigned char* __restrict__ valid,
                                        int has_evenodd) {
  if (f < 0) return Row{0, 0, 0.0f, false, false};
  const bool ok = valid[f];
  const int lo = starts[f];
  const int hi = starts[f + 1];
  return Row{lo, ok ? hi - lo : 0, backdrop[f], ok,
             has_evenodd && rule[f] == 1};
}

// 32 x 32 bit transposes across the warp, N at once: bit b of lane L
// becomes bit L of lane b. Each stage swaps the off-diagonal blocks of
// lanes L, L ^ d: a lane sends itself rotated towards its partner's block
// and keeps its own.
template <int N>
__device__ __forceinline__ void transpose32(unsigned (&a)[N], int lane) {
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) {
    const unsigned m0 = d == 16 ? 0x0000ffffu
                        : d == 8 ? 0x00ff00ffu
                        : d == 4 ? 0x0f0f0f0fu
                        : d == 2 ? 0x33333333u : 0x55555555u;
    const bool up = lane & d;
    const unsigned keep = up ? ~m0 : m0;
#pragma unroll
    for (int w = 0; w < N; ++w) {
      const unsigned send = __funnelshift_l(a[w], a[w], up ? d : 32 - d);
      const unsigned recv = __shfl_xor_sync(kFull, send, d);
      a[w] = (a[w] & keep) | (recv & ~keep);
    }
  }
}

// Words [w0, w0 + NWP) of a touched row with K planes: the touch loop, the
// edge terms, the resolve and the writes of their pixels. The row's first
// 32 touches are staged already when ``staged``.
template <int NS, int K, int NWP>
__device__ __forceinline__ void planes_pass(
    const float* __restrict__ trow, int lo, int cnt, int bdi, int w0,
    bool staged, float4 (*stage)[2], int lane, float* __restrict__ orow) {
  constexpr int H = Lanes<NS>::H;
  constexpr int NB = 2 * NWP;  // blocks of this pass
  const int s = lane % NS;
  const int h = lane / NS;
  const float cs = (sample_col<NS>(s) + 0.5f) / NS;
  float sy[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b)
    sy[b] = (float)(H * (2 * w0 + b) + h) + (s + 0.5f) / NS;
  unsigned plane[K][NWP];
#pragma unroll
  for (int p = 0; p < K; ++p)
#pragma unroll
    for (int w = 0; w < NWP; ++w) plane[p][w] = (bdi >> p) & 1 ? kFull : 0u;
  int edge[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) edge[b] = 0;

  for (int c0 = 0; c0 < cnt; c0 += 32) {
    const int n = min(32, cnt - c0);
    if (c0 > 0 || !staged) {
      __syncwarp();  // the previous chunk is read
      if (lane < n) stage_touch<NS>(load_touch(trow, lo + c0 + lane),
                                    stage[lane]);
    }
    __syncwarp();
    // the touches that reach this pass's blocks, or have an edge term
    const unsigned reach = (((1u << NB) - 1) << (2 * w0)) | kEdge;
    unsigned todo = __ballot_sync(
        kFull, lane < n && (__float_as_uint(stage[lane][1].z) & reach));
    while (todo) {
      const int k = 31 - __clz(todo);  // any order: the sums commute
      todo &= ~(1u << k);
      const float4 u = stage[k][0];  // x0, y0, a, ye
      const float4 v = stage[k][1];  // ymin, ymax, flags
      const unsigned flags = __float_as_uint(v.z);
      const unsigned blocks = flags >> (2 * w0);  // this pass's from bit 0
      const unsigned neg = __float_as_uint(v.w);  // the sign's mask
#pragma unroll
      for (int w = 0; w < NWP; ++w) {
        if (blocks & (3u << (2 * w))) {
          // the step masks of the word's two blocks, in its two halves
          unsigned c = 0u;
#pragma unroll
          for (int b = 2 * w; b < 2 * w + 2; ++b) {
            const int x = first_right(u.x + (sy[b] - u.y) * u.z, cs);
            const unsigned m =
                b & 1 ? 0xffff0000u << x : (0xffffu << x) & 0xffffu;
            c |= sy[b] >= v.x && sy[b] < v.y ? m : 0u;
          }
          // + or - the step masks, through the planes
#pragma unroll
          for (int p = 0; p < K; ++p) {
            const unsigned carry = (plane[p][w] ^ neg) & c;
            plane[p][w] ^= c;
            c = carry;
          }
        }
      }
      if (flags & kEdge) {
        const int e = flags & kEdgeNeg ? -1 : 1;
#pragma unroll
        for (int b = 0; b < NB; ++b) edge[b] += sy[b] >= u.w ? e : 0;
      }
    }
  }

  unsigned t[NWP];
#pragma unroll
  for (int w = 0; w < NWP; ++w) {
    const int elo = edge[2 * w];
    const int ehi = edge[2 * w + 1];
    if (elo | ehi) {
      // + the blocks' edge terms (two's complement), a full adder a plane
      unsigned carry = 0u;
#pragma unroll
      for (int p = 0; p < K; ++p) {
        const unsigned e = ((elo >> p) & 1 ? 0x0000ffffu : 0u) |
                           ((ehi >> p) & 1 ? 0xffff0000u : 0u);
        const unsigned q = plane[p][w];
        plane[p][w] = q ^ e ^ carry;
        carry = (q & e) | (carry & (q ^ e));
      }
    }
    t[w] = plane[0][w];
#pragma unroll
    for (int p = 1; p < K; ++p) t[w] |= plane[p][w];
  }
  // lane L: the samples (lanes) of pixel x = L & 15 of block
  // 2 (w0 + w) + L / 16, ns per tile row
  transpose32(t, lane);
  const int half = lane >> 4;
  const int x = lane & 15;
#pragma unroll
  for (int w = 0; w < NWP; ++w) {
    const int y0 = H * (2 * (w0 + w) + half);
#pragma unroll
    for (int r = 0; r < H; ++r) {
      const unsigned bits = NS == 16 ? (r ? t[w] >> 16 : t[w] & 0xffffu)
                                     : (t[w] >> (8 * r)) & 0xffu;
      orow[(y0 + r) * 16 + x] = (float)__popc(bits) / NS;
    }
  }
}

// Blocks [j0, j1) of a touched row of any backdrop and touch count: per
// block, exact int windings (a difference row in local memory), then the
// f32 fill rule per sample and each pixel's sum in sample order, as the
// plain version. Rare (no scene of the repository reaches it), so kept
// small: few registers, nothing unrolled.
template <int NS>
__device__ __noinline__ void generic_row(const float* __restrict__ trow,
                                         int lo, int cnt, float bd,
                                         bool evenodd, int j0, int j1,
                                         int lane, float* __restrict__ orow) {
  constexpr int H = Lanes<NS>::H;
  const int s = lane % NS;
  const int h = lane / NS;
  const float cs = (sample_col<NS>(s) + 0.5f) / NS;
#pragma unroll 1
  for (int j = j0; j < j1; ++j) {
    const float sy = (float)(H * j + h) + (s + 0.5f) / NS;
    int d[17];  // slot 16: no pixel
#pragma unroll 1
    for (int x = 0; x < 17; ++x) d[x] = 0;
    int w = 0;  // the edge terms
#pragma unroll 1
    for (int t = lo; t < lo + cnt; ++t) {
      const Touch r = load_touch(trow, t);
      const float dx = r.p.z - r.p.x;
      const float dy = r.p.w - r.p.y;
      const float inv_dy = 1.0f / (dy == 0.0f ? 1.0f : dy);
      if (sy >= fminf(r.p.y, r.p.w) && sy < fmaxf(r.p.y, r.p.w))
        d[first_right(r.p.x + (sy - r.p.y) * (inv_dy * dx), cs)] +=
            dy > 0.0f ? -1 : 1;
      w += sy >= r.ye ? (dx > 0.0f ? 1 : (dx < 0.0f ? -1 : 0)) : 0;
    }
#pragma unroll 1
    for (int x = 0; x < 16; ++x) {
      w += d[x];
      const float term = fill_term((float)w + bd, evenodd);
      float sum = 0.0f;
#pragma unroll 1
      for (int q = 0; q < NS; ++q) sum += __shfl_sync(kFull, term, h * NS + q);
      if (x % NS == s) orow[(H * j + h) * 16 + x] = sum / NS;
    }
  }
}

// One row's part: the blocks of words [w0, w0 + NWW).
template <int NS>
__device__ __forceinline__ void row_part(const float* __restrict__ trow,
                                         const Row& row, int part,
                                         bool staged, float4 (*st)[2],
                                         int lane, float* __restrict__ orow) {
  constexpr int NWW = Lanes<NS>::NWW;
  constexpr int NW16 = NWW > 1 ? NWW / 2 : 1;  // words a pass at K = 16
  if (row.cnt <= 0) {
    // one value for the whole row: the fill rule of the backdrop, summed
    // over the samples in order; 0 for an invalid fragment
    float sum = 0.0f;
#pragma unroll
    for (int q = 0; q < NS; ++q) sum += fill_term(0.0f + row.bd, row.evenodd);
    const float cov = row.ok ? sum / NS : 0.0f;
#pragma unroll
    for (int q = 0; q < 2 / kParts; ++q)
      reinterpret_cast<float4*>(orow)[(part * 2 / kParts + q) * 32 + lane] =
          make_float4(cov, cov, cov, cov);
    return;
  }
  const float bd = row.bd;
  const bool integral = bd == rintf(bd) && fabsf(bd) < 65536.0f;
  const int bdi = integral ? (int)bd : 0;
  const int w0 = part * NWW;
  // the windings' bound: a step and an edge term a touch, the backdrop
  const long long need = 2ll * row.cnt + (bdi < 0 ? -bdi : bdi);
  const int lo = row.lo, cnt = row.cnt;
  if (!integral || need >= 65536) {
    generic_row<NS>(trow, lo, cnt, bd, row.evenodd, 2 * w0, 2 * (w0 + NWW),
                    lane, orow);
  } else if (row.evenodd) {
    planes_pass<NS, 1, NWW>(trow, lo, cnt, bdi, w0, staged, st, lane, orow);
  } else if (need < 16) {
    planes_pass<NS, 4, NWW>(trow, lo, cnt, bdi, w0, staged, st, lane, orow);
  } else if (need < 64) {
    planes_pass<NS, 6, NWW>(trow, lo, cnt, bdi, w0, staged, st, lane, orow);
  } else if (need < 256) {
    planes_pass<NS, 8, NWW>(trow, lo, cnt, bdi, w0, staged, st, lane, orow);
  } else {
#pragma unroll 1
    for (int w = w0; w < w0 + NWW; w += NW16) {
      planes_pass<NS, 16, NW16>(trow, lo, cnt, bdi, w, staged, st, lane,
                                orow);
      staged = false;
    }
  }
}

// Persistent: each group of kParts warps takes rows group, group + groups,
// ... and loads ahead, so that a row's chain of reads (fidx, then its
// fragment's range and backdrop, then its touches) is in flight while the
// rows before it are computed: the fragment two rows ahead, the first 32
// touches one row ahead.
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
  __shared__ float4 stage[kThreads / 32][32][2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int part = warp % kParts;
  const int step = gridDim.x * (kThreads / 32 / kParts);
  int i = blockIdx.x * (kThreads / 32 / kParts) + warp / kParts;
  float4(*st)[2] = stage[warp];
  Row row = load_row(i < n_rows ? fidx[i] : -1, starts, backdrop, rule,
                     valid, has_evenodd);
  Row next = load_row(i + step < n_rows ? fidx[i + step] : -1, starts,
                      backdrop, rule, valid, has_evenodd);
  int f_after = i + 2 * step < n_rows ? fidx[i + 2 * step] : -1;
  Touch ahead = {};
  if (lane < row.cnt) ahead = load_touch(trow, row.lo + lane);
  for (; i < n_rows; i += step) {
    if (row.cnt > 0) {
      __syncwarp();  // the previous row's touches are read
      if (lane < row.cnt) stage_touch<NS>(ahead, st[lane]);
    }
    if (lane < next.cnt) ahead = load_touch(trow, next.lo + lane);
    const Row after = load_row(f_after, starts, backdrop, rule, valid,
                               has_evenodd);
    f_after = i + 3 * step < n_rows ? fidx[i + 3 * step] : -1;
    row_part<NS>(trow, row, part, true, st, lane, out + (size_t)i * 256);
    row = next;
    next = after;
  }
}

}  // namespace

// The persistent grid: as many CTAs as the card holds at once, fewer for
// a small call.
template <int NS>
int grid_size(int n_rows) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, msaa_coverage_kernel<NS>, kThreads, 0);
    resident = max(sms * per_sm, 1);
  }
  constexpr int rows_per_cta = kThreads / 32 / kParts;
  return min((n_rows + rows_per_cta - 1) / rows_per_cta, resident);
}

extern "C" int vt_msaa_coverage(const float* trow, const int* starts,
                                const int* fidx, const float* backdrop,
                                const int* rule, const unsigned char* valid,
                                int n_rows, int ns, int has_evenodd,
                                float* out, cudaStream_t stream) {
  if (ns == 8)
    msaa_coverage_kernel<8><<<grid_size<8>(n_rows), kThreads, 0, stream>>>(
        trow, starts, fidx, backdrop, rule, valid, n_rows, has_evenodd, out);
  else if (ns == 16)
    msaa_coverage_kernel<16><<<grid_size<16>(n_rows), kThreads, 0,
                               stream>>>(trow, starts, fidx, backdrop, rule,
                                         valid, n_rows, has_evenodd, out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
