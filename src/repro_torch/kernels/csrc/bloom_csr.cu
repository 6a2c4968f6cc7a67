// CSR scatter-add for Hopper (sm_90a): the backward of the Bloom embedding,
//     out[r, :] = sum over entries e in [row_ptr[r], row_ptr[r + 1]) of
//                 g[src[e], :]
// where the entries are the flat (T * k) hash indices stably sorted by their
// value (so each row's entries come in token, then j, order), src[e] is the
// token row of entry e, and row_ptr (m + 1) holds each output row's segment.
// g (T, D) f32 or bf16, out (m, D) f32. Each row is summed in f32 from 0.0 in
// entry order (__fadd_rn), so the result is the same from run to run and
// bit-identical to its plain version (zeros(m, D).index_add_ over the same
// sorted entries, on the CPU). The file also holds the binning that builds
// row_ptr and src on the card (bloom_csr_bin).
//
// Replaces the Pallas TPU kernel src/repro/kernels/bloom_csr.py ::
// csr_scatter_add_pallas (_csr_kernel), reached from the Bloom embedding's
// backward through bloom_embed_bwd_csr_pallas and from the Eq. 3 decode's
// through bloom_decode_bwd_csr_pallas, and the jitted bin_csr that feeds it.
// The TPU kernel bins entries into fixed e_tile tiles per m-tile and
// accumulates a one-hot w^T @ rows product per tile on the MXU, because its
// grid runs in order and one output block is revisited by a consecutive run
// of tiles. Here blocks run in no order, so each block owns its output rows
// outright: no block ever writes a row another block writes, there is no
// float atomicAdd, and a row with no entries is written as zeros by its own
// block.
//
// Bound on the H100: bytes. The least traffic is the (m, D) f32 output once
// (124 MB at m = 30,208, D = 1024: 37 us at 3.35 TB/s), the cotangent rows
// once per entry that reads them (each token row about k times; about 4 MB
// in bf16 at T = 520, k = 4, D = 1024, mostly from L2) and the int32 segment
// arrays. The adds are negligible. At the train shape a row has 0.07 entries
// on average, so the kernel is nearly a zero-fill, and what matters is that
// the stores stream at the card's write rate.
//
// Scatter design: a block owns a run of rows_per_block consecutive output
// rows (picked by the wrapper so that a thread has up to 8 chunks and the
// grid still fills the card). It reads its slice of row_ptr into shared
// memory once, then its threads walk the run's (row, chunk) pairs in order,
// a chunk being 4 output columns (16 bytes of f32) on the vector path and
// one column on the scalar path (a ragged D or unaligned pointers): thread
// t takes pairs t, t + blockDim, ..., so neighbouring threads store
// neighbouring 16-byte chunks and every warp-wide store fills whole 128-byte
// lines, across row ends too. An empty row is stored as zeros with no load;
// otherwise the thread walks the row's segment, loads 4 columns of each
// entry's g row (8 bytes of bf16, 16 of f32) and adds them in order. Stores
// are streaming (__stcs): the output is larger than the 50 MB L2 and is not
// read again here. The decode caller (D = B = 8, f32) gets the same layout:
// a row is two chunks, so a block of 256 threads covers 128 rows.
//
// Binning design (bloom_csr_bin): entries are bucketed by value, bucket 0
// for values below 0, v + 1 for v in [0, m), m + 1 for values from m up (so
// out-of-range entries, such as -1 pads, fall outside every row's segment
// and keep their entry order among themselves). A row range (the backward of
// one rank's shard of a vocab-parallel embedding: rows [row0, row0 + m) of
// the full table) bins v - row0 instead, so the entries of other shards'
// rows drop out the same way; row0 = 0 is the unranged binning. row_ptr[r] is the start of
// bucket r + 1. Integer atomics count the buckets and give each entry a
// place in its bucket, an exclusive scan turns the counts into starts, and
// the entries of each bucket, placed in no fixed order, are put back into
// increasing entry order by rank: the entry at place p goes to the start of
// its bucket plus the number of entries of the bucket smaller than it. The
// atomics decide only where an entry waits, never the order of a float
// sum, and the bins equal the stable sort's exactly (bin_csr_plain). Every
// atomic is on shared memory, and two paths spread the work over the card:
// - n <= 8,192 (the train step: n = 2,080, m = 30,208): one launch. Block j
//   owns 1,024 buckets; it reads all n entries, counts those below its
//   buckets and its own, scans its counts, writes its row pointers, and
//   places and ranks its own entries in a shared list; the two
//   out-of-range buckets are put in entry order by an ordered scan.
// - more entries (the decode's d * k = 607,744): four launches, two levels.
//   The entries are cut into chunks of 2,048 or more (at most 1,024 chunks)
//   and the buckets into groups of 64. part_count counts each chunk's
//   entries per group; scan_rows scans each group's counts over the chunks
//   and totals the group; part_place moves every chunk's entries, each
//   packed with its bucket in one int, to the group's start plus its run,
//   in entry order (so n < 2^25); and
//   group_bin bins each group by bucket in one block and writes its row
//   pointers and src. Both stage their output in shared memory and store it
//   in contiguous runs: scattered 4- and 8-byte stores, one 32-byte sector
//   each, were what cost the most. A block keeps two counters per group in
//   shared memory, so this path takes at most 2,048 groups (m + 2 <=
//   131,072).
// Ranking by comparison (bin_ranges, and part_place within a round of 2,048)
// costs a segment's length per entry: a few at the shapes above, at most
// 8,192 (one launch) or 2,048 (a round); group_bin ranks with ballots in
// constant work per entry, so one row may hold any number of entries.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// the most rows a scatter block owns (its row_ptr slice is kMaxRows + 1)
constexpr int kMaxRows = 2048;

// binning (bloom_csr.py :: bin_plan mirrors these): blocks of kBinThreads
// threads; on the one-launch path a block owns kRange buckets (4 a thread);
// on the two-level path a group is kGroup buckets, there are at most
// kMaxGroups groups (and at most 4 * kBinThreads chunks), a chunk is read
// in rounds of kSub entries (8 a thread), and group_bin stages a group's
// src in shared memory up to kStageCap entries
constexpr int kBinThreads = 256;
constexpr int kWarps = kBinThreads / 32;
constexpr int kRange = 4 * kBinThreads;
constexpr int kGroup = 64;
constexpr int kMaxGroups = 8 * kBinThreads;
constexpr int kSub = 8 * kBinThreads;
constexpr int kStageCap = 10240;
// the two-level path packs an entry e with its bucket's place in its group
// as e * kGroup + place, which must stay below 2^31
constexpr int kMaxGroupedEntries = (1 << 25) - 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// kVec columns of g row s starting at column c, widened to f32.
template <typename T, int kVec>
__device__ __forceinline__ void load_cols(const T* __restrict__ g, size_t off,
                                          float (&v)[kVec]) {
  if constexpr (kVec == 1) {
    v[0] = to_f32(__ldg(g + off));
  } else if constexpr (sizeof(T) == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(g + off));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(g + off));
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
    v[0] = __low2float(lo);
    v[1] = __high2float(lo);
    v[2] = __low2float(hi);
    v[3] = __high2float(hi);
  }
}

// Grid (ceil(m / rows_per_block)): block b owns rows [b * rows_per_block,
// ...); thread t takes the block's (row, chunk) pairs t, t + kThreads, ...
// with chunks of kVec columns (kVec = 4 needs D % 4 == 0, g aligned to
// 4 elements and out to 16 bytes).
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
    csr_rows(const T* __restrict__ g, const int* __restrict__ row_ptr,
             const int* __restrict__ src, float* __restrict__ out, int m,
             int D, int rows_per_block) {
  __shared__ int ptr[kMaxRows + 1];
  const int r0 = blockIdx.x * rows_per_block;
  const int nr = min(rows_per_block, m - r0);
  for (int i = threadIdx.x; i <= nr; i += kThreads) ptr[i] = row_ptr[r0 + i];
  __syncthreads();
  const int cpr = D / kVec;  // chunks per row
  const int pairs = nr * cpr;
  float* o = out + (size_t)r0 * D;
  for (int p = threadIdx.x; p < pairs; p += kThreads) {
    const int r = p / cpr;
    const size_t col = (size_t)(p - r * cpr) * kVec;
    float acc[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = 0.0f;
    const int e1 = ptr[r + 1];
#pragma unroll 4
    for (int e = ptr[r]; e < e1; ++e) {
      float v[kVec];
      load_cols<T, kVec>(g, (size_t)__ldg(src + e) * D + col, v);
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] = __fadd_rn(acc[i], v[i]);
    }
    // p * kVec == r * D + col: the block's stores are one contiguous run
    if constexpr (kVec == 1) {
      __stcs(o + p, acc[0]);
    } else {
      __stcs(reinterpret_cast<float4*>(o) + p,
             make_float4(acc[0], acc[1], acc[2], acc[3]));
    }
  }
}

template <typename T>
int launch(const T* g, const int* row_ptr, const int* src, float* out, int m,
           int D, int rows_per_block, void* stream) {
  if (rows_per_block < 1 || rows_per_block > kMaxRows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = D % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % (4 * sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int blocks = (m + rows_per_block - 1) / rows_per_block;
  if (vec)
    csr_rows<T, 4><<<blocks, kThreads, 0, s>>>(g, row_ptr, src, out, m, D,
                                                rows_per_block);
  else
    csr_rows<T, 1><<<blocks, kThreads, 0, s>>>(g, row_ptr, src, out, m, D,
                                                rows_per_block);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- binning

__device__ __forceinline__ int bucket(int v, int m) {
  return v < 0 ? 0 : (v < m ? v + 1 : m + 1);
}

__device__ __forceinline__ int warp_incl_scan(int x, int lane) {
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, s);
    if (lane >= s) x += y;
  }
  return x;
}

// The sum of x over the lower threads of the block (an exclusive scan) and,
// in total, over all of them. red is shared scratch of kBinThreads / 32
// ints; every thread must call it.
__device__ __forceinline__ int block_excl_scan(int x, int* red, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int incl = warp_incl_scan(x, lane);
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? red[w] : 0;
    total += red[w];
  }
  __syncthreads();
  return before + incl - x;
}

// The rank of entry e among the entries list[lo, hi) of its bucket.
__device__ __forceinline__ int rank_in(const int* list, int lo, int hi,
                                       int e) {
  int r = 0;
  for (int q = lo; q < hi; ++q) r += list[q] < e;
  return r;
}

// Writes row_ptr[b - 1] = the start of bucket b for thread t's buckets
// b = lo + 4t ... lo + 4t + 3 in [1, m + 1], from their counts c and
// run = the start of the first.
__device__ __forceinline__ void write_starts(const int (&c)[4], int run,
                                             int lo, int m, int* row_ptr) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int b = lo + 4 * threadIdx.x + q;
    if (b >= 1 && b <= m + 1) row_ptr[b - 1] = run;
    run += c[q];
  }
}

// The one-launch path (n <= 8,192). Grid (ceil((m + 2) / kRange)):
// block j owns buckets [lo, hi) = [j * kRange, min(lo + kRange, m + 2)).
// Every block reads all n entries: it counts those below lo, and counts its
// own in shared memory; it scans its counts into starts and writes its row
// pointers; then it places its own entries in a shared list by integer
// atomics and puts each at its rank in its bucket.
__global__ void __launch_bounds__(kBinThreads)
    bin_ranges(const int* __restrict__ vals, int n, int k, int m, int row0,
               int* __restrict__ row_ptr, int* __restrict__ src) {
  __shared__ __align__(16) int cnt[kRange];
  __shared__ int red[kWarps];
  extern __shared__ int list[];
  const int lo = blockIdx.x * kRange, hi = min(lo + kRange, m + 2);
  for (int i = threadIdx.x; i < kRange; i += kBinThreads) cnt[i] = 0;
  __syncthreads();
  int below = 0;
  for (int e = threadIdx.x; e < n; e += kBinThreads) {
    const int b = bucket(__ldg(vals + e) - row0, m);
    if (b < lo)
      ++below;
    else if (b < hi)
      atomicAdd(&cnt[b - lo], 1);
  }
  __syncthreads();
  int total;
  block_excl_scan(below, red, total);
  below = total;
  const int4 c4 = reinterpret_cast<const int4*>(cnt)[threadIdx.x];
  const int c[4] = {c4.x, c4.y, c4.z, c4.w};
  int run = block_excl_scan(c[0] + c[1] + c[2] + c[3], red, total);
  write_starts(c, below + run, lo, m, row_ptr);
  // cnt becomes each bucket's cursor, from its start in the block's list
  reinterpret_cast<int4*>(cnt)[threadIdx.x] =
      make_int4(run, run + c[0], run + c[0] + c[1], run + c[0] + c[1] + c[2]);
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += kBinThreads) {
    const int b = bucket(__ldg(vals + e) - row0, m);
    if (b >= lo && b < hi) list[atomicAdd(&cnt[b - lo], 1)] = e;
  }
  __syncthreads();
  // cnt[x] is now the end of bucket lo + x, so its start is cnt[x - 1]
  for (int p = threadIdx.x; p < total; p += kBinThreads) {
    const int e = list[p];
    const int b = bucket(__ldg(vals + e) - row0, m);
    if (b == 0 || b == m + 1) continue;
    const int x = b - lo;
    const int s = x ? cnt[x - 1] : 0;
    src[below + s + rank_in(list, s, cnt[x], e)] = e / k;
  }
  // The two out-of-range buckets (0: values below the rows, m + 1: from
  // their end up) keep entry order by an ordered pass over the entries, a
  // block-wide scan a round: with a row range they hold most entries, and
  // ranking by comparison costs a bucket's length squared.
  for (int ob = 0; ob < 2; ++ob) {
    const int b = ob ? m + 1 : 0;
    if (b < lo || b >= hi) continue;   // the same in every thread
    int at = below + (b > lo ? cnt[b - lo - 1] : 0);
    for (int e0 = 0; e0 < n; e0 += kBinThreads) {
      const int e = e0 + (int)threadIdx.x;
      const int in = e < n && bucket(__ldg(vals + e) - row0, m) == b;
      int tot;
      const int before = block_excl_scan(in, red, tot);
      if (in) src[at + before] = e / k;
      at += tot;
    }
  }
}

// In-place exclusive scan of c[0, len) in shared memory (len <= 16 *
// kBinThreads): thread t takes a run of len / kBinThreads counters. Every
// thread must call it; it ends on a barrier.
__device__ void smem_scan(int* c, int len, int* red) {
  const int per = (len + kBinThreads - 1) / kBinThreads;
  const int lo = min(len, (int)threadIdx.x * per), hi = min(len, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += c[i];
  int total;
  int run = block_excl_scan(sum, red, total);
  for (int i = lo; i < hi; ++i) {
    const int x = c[i];
    c[i] = run;
    run += x;
  }
  __syncthreads();
}

// The two-level path (more entries): entries are first split stably into
// groups of kGroup buckets, chunk by chunk, then each group is binned by one
// block. Step 1, grid (nc chunks): table[g * nc + j] = the entries of chunk
// j in group g (shared-memory atomics).
__global__ void __launch_bounds__(kBinThreads)
    part_count(const int* __restrict__ vals, int n, int m, int row0,
               int chunk, int nc,
               int* __restrict__ table) {
  extern __shared__ int cnt[];
  const int G = (m + 2 + kGroup - 1) / kGroup;
  for (int g = threadIdx.x; g < G; g += kBinThreads) cnt[g] = 0;
  __syncthreads();
  const int j = blockIdx.x;
  const int e1 = min(n, (j + 1) * chunk);
  for (int e = j * chunk + (int)threadIdx.x; e < e1; e += kBinThreads)
    atomicAdd(&cnt[bucket(__ldg(vals + e) - row0, m) / kGroup], 1);
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += kBinThreads)
    table[g * nc + j] = cnt[g];
}

// Step 2, grid (G groups): block g scans its row of the table in place (the
// entries of group g in the chunks before each, nc <= 4 * kBinThreads) and
// writes the group's total.
__global__ void __launch_bounds__(kBinThreads)
    scan_rows(int* __restrict__ table, int nc, int* __restrict__ totals) {
  __shared__ int red[kWarps];
  int* row = table + blockIdx.x * nc;
  const int first = 4 * threadIdx.x;
  int c[4], sum = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    c[q] = first + q < nc ? row[first + q] : 0;
    sum += c[q];
  }
  int total;
  int run = block_excl_scan(sum, red, total);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (first + q < nc) row[first + q] = run;
    run += c[q];
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = total;
}

// The bucket and entry index of a round's entries base + q * kBinThreads +
// t (thread t), or -1 past e1.
__device__ __forceinline__ void load_round(const int* __restrict__ vals,
                                           int base, int e1, int m,
                                           int row0, int (&ev)[8],
                                           int (&bv)[8]) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    ev[q] = base + q * kBinThreads + (int)threadIdx.x;
    bv[q] = ev[q] < e1 ? bucket(__ldg(vals + ev[q]) - row0, m) : 0;
    if (ev[q] >= e1) ev[q] = -1;
  }
}

// Step 3, grid (nc chunks): block j moves its chunk's entries to their
// places in part, each packed as entry * kGroup + its bucket's place in its
// group: group g's entries of chunk j go, in entry order, from the group's
// start (the totals of the groups before it) plus its entries in the chunks
// before j. A round of kSub entries counts its entries per group, scans the
// counts, places them by shared atomics, ranks each in its group, stages
// the round in group order in shared memory, and writes each group's run
// out contiguously.
__global__ void __launch_bounds__(kBinThreads)
    part_place(const int* __restrict__ vals, int n, int m, int row0,
               int chunk, int nc,
               const int* __restrict__ table, const int* __restrict__ totals,
               int* __restrict__ part) {
  extern __shared__ int sm[];
  __shared__ int red[kWarps];
  const int G = (m + 2 + kGroup - 1) / kGroup;
  int* next = sm;                 // G: where the chunk's next entry of g goes
  int* cnt = sm + G;              // G
  int* list = sm + 2 * G;         // kSub
  int* stage = list + kSub;       // kSub packed entries in group order
  int* stage_g = stage + kSub;    // kSub: their groups
  const int j = blockIdx.x;
  const int e1 = min(n, (j + 1) * chunk);
  int ev[8], bv[8];
  load_round(vals, j * chunk, e1, m, row0, ev, bv);
  for (int g = threadIdx.x; g < G; g += kBinThreads) {
    next[g] = totals[g];
    cnt[g] = table[g * nc + j];
  }
  __syncthreads();
  smem_scan(next, G, red);
  for (int g = threadIdx.x; g < G; g += kBinThreads) next[g] += cnt[g];
  for (int base = j * chunk; base < e1; base += kSub) {
    for (int g = threadIdx.x; g < G; g += kBinThreads) cnt[g] = 0;
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (ev[q] >= 0) atomicAdd(&cnt[bv[q] / kGroup], 1);
    __syncthreads();
    smem_scan(cnt, G, red);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (ev[q] >= 0) list[atomicAdd(&cnt[bv[q] / kGroup], 1)] = ev[q];
    __syncthreads();
    // cnt[g] is now the round's end of group g, so its start is cnt[g - 1]
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (ev[q] < 0) continue;
      const int g = bv[q] / kGroup;
      const int s = g ? cnt[g - 1] : 0;
      const int at = s + rank_in(list, s, cnt[g], ev[q]);
      stage[at] = ev[q] * kGroup + bv[q] % kGroup;
      stage_g[at] = g;
    }
    __syncthreads();
    if (base + kSub < e1)
      load_round(vals, base + kSub, e1, m, row0, ev, bv);
    for (int p = threadIdx.x; p < cnt[G - 1]; p += kBinThreads) {
      const int g = stage_g[p];
      part[next[g] + p - (g ? cnt[g - 1] : 0)] = stage[p];
    }
    __syncthreads();
    for (int g = threadIdx.x; g < G; g += kBinThreads)
      next[g] += cnt[g] - (g ? cnt[g - 1] : 0);
    __syncthreads();  // cnt is read before the next round clears it
  }
}

// Step 4, grid (G groups): block g bins its group's part[rs, re) by bucket
// (thread t < kGroup owns bucket g * kGroup + t): it counts and scans the
// buckets (row_ptr), then ranks the entries in order, a tile of kBinThreads
// at a time: an entry's rank in its bucket is the bucket's entries in the
// tiles before, plus those in the tile's lower warps (per-warp counts in
// shared memory), plus those in its warp's lower lanes (the lanes whose
// bucket bits agree, from one ballot a bit). The group's src is staged in
// shared memory and written out contiguously when it holds at most
// kStageCap entries (the spec's H: 1,285 on average), else written in
// place.
__global__ void __launch_bounds__(kBinThreads)
    group_bin(const int* __restrict__ part, int k, int m,
              const int* __restrict__ totals, int* __restrict__ row_ptr,
              int* __restrict__ src) {
  __shared__ int start[kGroup];
  __shared__ int ranked[kGroup];
  __shared__ int wcnt[kWarps][kGroup + 1];
  __shared__ int red[kWarps];
  __shared__ int stage[kStageCap];
  const int g = blockIdx.x, b0 = g * kGroup;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int below = 0;
  for (int i = threadIdx.x; i < g; i += kBinThreads) below += totals[i];
  int total;
  block_excl_scan(below, red, total);
  const int rs = total, re = rs + totals[g];
  if (threadIdx.x < kGroup) start[threadIdx.x] = 0;
  __syncthreads();
  for (int p = rs + threadIdx.x; p < re; p += kBinThreads)
    atomicAdd(&start[part[p] % kGroup], 1);
  __syncthreads();
  const int c = threadIdx.x < kGroup ? start[threadIdx.x] : 0;
  const int s = block_excl_scan(c, red, total);
  if (threadIdx.x < kGroup) {
    const int b = b0 + threadIdx.x;
    if (b >= 1 && b <= m + 1) row_ptr[b - 1] = rs + s;
    start[threadIdx.x] = s;
    ranked[threadIdx.x] = 0;
  }
  const bool staged = re - rs <= kStageCap;
  for (int base = rs; base < re; base += kBinThreads) {
    for (int i = threadIdx.x; i < kWarps * (kGroup + 1); i += kBinThreads)
      (&wcnt[0][0])[i] = 0;
    __syncthreads();
    const int p = base + threadIdx.x;
    int e = 0, x = kGroup;  // lanes past the group's end share key kGroup
    if (p < re) {
      const int v = part[p];
      e = v / kGroup;
      x = v % kGroup;
    }
    unsigned peers = 0xffffffffu;
#pragma unroll
    for (int bit = 0; bit < 7; ++bit) {  // kGroup + 1 keys fit in 7 bits
      const bool on = (x >> bit) & 1;
      const unsigned bal = __ballot_sync(0xffffffffu, on);
      peers &= on ? bal : ~bal;
    }
    if (lane == __ffs(peers) - 1) wcnt[warp][x] = __popc(peers);
    __syncthreads();
    if (threadIdx.x < kGroup) {
      int acc = ranked[threadIdx.x];
      for (int w = 0; w < kWarps; ++w) {
        const int t = wcnt[w][threadIdx.x];
        wcnt[w][threadIdx.x] = acc;
        acc += t;
      }
      ranked[threadIdx.x] = acc;
    }
    __syncthreads();
    if (p < re) {
      const int pos = start[x] + wcnt[warp][x] +
                      __popc(peers & ((1u << lane) - 1u));
      if (staged)
        stage[pos] = e / k;
      else
        src[rs + pos] = e / k;
    }
    __syncthreads();  // wcnt is read before the next tile clears it
  }
  if (staged) {
    for (int q = threadIdx.x; q < re - rs; q += kBinThreads)
      src[rs + q] = stage[q];
  }
}

int bin(const int* vals, int n, int k, int m, int row0, int chunk,
        int* row_ptr,
        int* src, int* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk == 0) {
    bin_ranges<<<(m + 2 + kRange - 1) / kRange, kBinThreads,
                 (size_t)n * sizeof(int), s>>>(vals, n, k, m, row0, row_ptr,
                                               src);
    return (int)cudaGetLastError();
  }
  const int G = (m + 2 + kGroup - 1) / kGroup;
  const int nc = n > 0 && chunk > 0 ? (n + chunk - 1) / chunk : 0;
  if (chunk % kSub != 0 || nc < 1 || nc > 4 * kBinThreads ||
      G > kMaxGroups || n > kMaxGroupedEntries)
    return (int)cudaErrorInvalidValue;
  // scratch: the packed entries split by group, the (G, nc) table of
  // counts, and the groups' totals
  int* part = scratch;
  int* table = part + n;
  int* totals = table + G * nc;
  part_count<<<nc, kBinThreads, (size_t)G * sizeof(int), s>>>(
      vals, n, m, row0, chunk, nc, table);
  scan_rows<<<G, kBinThreads, 0, s>>>(table, nc, totals);
  part_place<<<nc, kBinThreads, (2 * (size_t)G + 3 * kSub) * sizeof(int),
               s>>>(vals, n, m, row0, chunk, nc, table, totals, part);
  group_bin<<<G, kBinThreads, 0, s>>>(part, k, m, totals, row_ptr, src);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// g (T, D), row_ptr (m + 1,) int32 non-decreasing, src (E,) int32 token
// rows in [0, T), out (m, D) f32, all contiguous on one device;
// rows_per_block in [1, 2048] (bloom_csr.py :: rows_per_block). Launches on
// `stream` without synchronising; returns the CUDA error code of the launch
// (0 on success).
int bloom_csr_f32(const float* g, const int* row_ptr, const int* src,
                  float* out, int m, int D, int rows_per_block,
                  void* stream) {
  return launch<float>(g, row_ptr, src, out, m, D, rows_per_block, stream);
}

int bloom_csr_bf16(const void* g, const int* row_ptr, const int* src,
                   float* out, int m, int D, int rows_per_block,
                   void* stream) {
  return launch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(g), row_ptr,
                               src, out, m, D, rows_per_block, stream);
}

// vals (n,) int32 (the flat (T, k) indices, any values), binned over the
// rows [row0, row0 + m) (row0 = 0: the whole table), out row_ptr (m + 1,)
// and src (n,) int32, and `chunk` and the int32 scratch (16-byte aligned) as
// bloom_csr.py :: bin_plan gives them (chunk 0: the one-launch path, no
// scratch), all contiguous on one device. Launches on `stream` without
// synchronising; returns the CUDA error code (0 on success).
int bloom_csr_bin(const int* vals, int n, int k, int m, int row0, int chunk,
                  int* row_ptr, int* src, int* scratch, void* stream) {
  return bin(vals, n, k, m, row0, chunk, row_ptr, src, scratch, stream);
}

const char* bloom_csr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
