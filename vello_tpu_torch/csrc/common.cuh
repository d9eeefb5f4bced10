// Helpers shared by the port's CUDA kernels.
#pragma once

namespace vt {

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// first index s in [lo, hi) with incl[s] > p in a nondecreasing inclusive
// scan (hi if none): the element that owns output slot p (offs[s] <= p <
// incl[s]) when incl[lo - 1] <= p
__device__ __forceinline__ int upper_bound(const int* incl, int lo, int hi,
                                           int p) {
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (incl[mid] > p) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// upper_bound for the 32 lanes of a warp whose slots are consecutive,
// p = p0 + lane; every lane of the warp calls it with the same p0 and
// total = incl[n - 1]. The warp finds the owner l0 of p0 by a 32-way
// search (each step probes 32 scan entries at once: ~4 steps for 10^6
// owners where a binary search waits on ~20 dependent loads), then each
// lane counts the entries of incl[l0 .. l0 + 31] that are <= p by a search
// over the lanes' registers. A lane whose owner lies past those 32 entries
// (after a run of zero counts) searches on from there alone. Lanes with
// p >= total get an index they must not use.
__device__ __forceinline__ int warp_upper_bound(const int* incl, int n,
                                                int p0, int p, int total) {
  const unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  if (p0 >= total) return n;  // the whole warp's slots are dead
  int lo = 0, hi = n;         // the owner of p0 lies in [lo, hi]
  while (hi - lo > 32) {
    int stride = (hi - lo + 31) >> 5;
    int q = lo + (lane + 1) * stride - 1;
    unsigned m = __ballot_sync(kAll, q >= hi || incl[q] > p0);
    int j = __ffs(m) - 1;
    if (j < 0) {
      lo = hi;
    } else {
      hi = min(hi, lo + (j + 1) * stride - 1);
      lo += j * stride;
    }
  }
  unsigned m = __ballot_sync(kAll, lo + lane >= hi || incl[lo + lane] > p0);
  int l0 = m ? lo + __ffs(m) - 1 : hi;
  int w = l0 + lane < n ? incl[l0 + lane] : 0x7fffffff;
  int pos = 0;  // the lanes k with w_k <= p (w is nondecreasing in k)
#pragma unroll
  for (int step = 16; step > 0; step >>= 1) {
    if (__shfl_sync(kAll, w, pos + step - 1) <= p) pos += step;
  }
  if (__shfl_sync(kAll, w, pos) <= p) pos += 1;
  if (pos < 32 || p >= total) return l0 + pos;
  return upper_bound(incl, l0 + 32, n, p);
}

}  // namespace vt
