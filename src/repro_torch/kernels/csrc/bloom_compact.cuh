// Ordered compaction of hash entries into shared memory: the building block
// of the dense Bloom embedding backward (csrc/bloom_embed.cu).
//
// The JAX package's dense backwards build a one-hot count of the entries
// that fall in one m-tile (kernels/common.py :: onehot_count) and contract
// it on the MXU, in an order the compiler picks. Here a block keeps, in
// entry order, the list of the entries whose value falls in its tile, so
// that each output can be summed in that order from 0.0: the order of the
// CSR bins (a stable sort of the same entries), with no float atomics, and
// the same bits from run to run.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bloom_compact {

// Entry e0 + (p >> kOffBits) with offset p & kOffMask in its tile.
constexpr int kOffBits = 16;
constexpr int kOffMask = (1 << kOffBits) - 1;

// Writes to list[0 ...] (shared memory) the entries e in
// [e0, e0 + blockDim.x * kPer) with e < n whose value v = vals[e] satisfies
// 0 <= v - base < tile, in increasing e, packed as
// (e - e0) << kOffBits | (v - base); -1 pads and values outside the tile
// never match. Needs blockDim.x * kPer <= 2^15 and tile <= 2^16. Thread t
// tests the kPer consecutive entries from e0 + t * kPer (one 16-byte load
// per 4 when aligned), so a block-wide exclusive scan of the per-thread hit
// counts gives each hit its place in entry order. warp_tot is shared
// scratch of blockDim.x / 32 ints. Every thread of the block must call it
// with the same arguments; returns the number of entries written, the same
// in every thread, with the list visible to the whole block. The list may
// be overwritten by the next call only: its first barrier waits for every
// thread to be done with the previous list.
template <int kPer>
__device__ __forceinline__ int compact(const int* __restrict__ vals,
                                       long long e0, long long n, int base,
                                       int tile, int* list, int* warp_tot) {
  static_assert(kPer % 4 == 0, "kPer must be a multiple of 4");
  const int rel0 = threadIdx.x * kPer;
  const long long first = e0 + rel0;
  int v[kPer];
  if (first + kPer <= n && reinterpret_cast<uintptr_t>(vals) % 16 == 0) {
#pragma unroll
    for (int q = 0; q < kPer; q += 4) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(vals + first + q));
      v[q] = x.x;
      v[q + 1] = x.y;
      v[q + 2] = x.z;
      v[q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kPer; ++q)
      v[q] = first + q < n ? __ldg(vals + first + q) : -1;
  }
  int hits = 0;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const unsigned o = (unsigned)(v[q] - base);
    v[q] = o < (unsigned)tile ? (int)o : -1;
    hits += v[q] >= 0;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = hits;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, s);
    if (lane >= s) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int before = 0, total = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    const int t = warp_tot[w];
    before += w < warp ? t : 0;
    total += t;
  }
  int pos = before + incl - hits;
#pragma unroll
  for (int q = 0; q < kPer; ++q)
    if (v[q] >= 0) list[pos++] = (rel0 + q) << kOffBits | v[q];
  __syncthreads();
  return total;
}

}  // namespace bloom_compact
