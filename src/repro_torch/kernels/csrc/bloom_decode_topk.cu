// Fused Bloom Eq. 3 decode + top-k for Hopper (sm_90a): logp rows stored in
// f32, bf16, int8 with one f32 scale per row, or fp8 e4m3, and the hash
// indices read from an explicit (d, k) matrix or re-derived in the kernel.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bloom_decode_topk.py ::
// bloom_decode_topk_pallas: its dense grid (_kernel) and its row-skipping
// grid (_kernel_skip) are one kernel here, with an optional `active` mask,
// and so are its quantized variants (has_scales: _fold_tile's per-row scale
// multiply; hash_spec: _tile_scores' in-kernel double hashing).
//
// What it computes, for each row b with active[b] != 0 (or every row when
// active is null): the topk ids over i in [0, d) of
//     score[b, i] = row_b[h_0(i)] + row_b[h_1(i)] + ...
// summed in f32 in j order, ranked by the total order (score descending,
// id ascending), so equal scores resolve to the lowest id. row_b is logp
// row b widened to f32 (times scales[b] for int8, rounded on its own: the
// reference's `logp * s` before the gather). h_j(i) is H[i, j], or, with H
// null, the enhanced double hash of core/hashing.double_hash:
//     h1 = splitmix32(i ^ c1) % m,  h2 = splitmix32(i ^ c2) % max(m-1, 1) + 1
//     h_j = (h1 + j*h2 + ((j^3 - j)/6 % m)) % m
// in uint32 arithmetic, so it equals the cached hash matrix of an
// on-the-fly spec bit for bit. A row with active[b] == 0 does no work and
// returns (-inf, 0).
//
// Bound on the H100: with H, bytes. The least traffic is H once (d*k*4
// bytes), each live logp row once (m*itemsize) and the outputs
// (B*topk*8): at d = 1e7, k = 2, m = 8192, B = 8, f32 that is ~80.3 MB,
// ~24 us at 3.35 TB/s. The adds are d*B*(k-1) f32 operations, ~1 us at
// 67 TFLOP/s. Without H the bytes are a few KB and the bound is the hash's
// integer operations, counted once per id: ~27 at k = 2, ~16 us for
// d = 1e7 at the card's ~16.7e12 int32 operations/s. This kernel hashes
// every id once per live ROW (B times), trading integer instructions for
// the d*k*4 bytes of H that the TPU design drops.
//
// Design. The TPU kernel carries its running top-k in VMEM scratch across a
// sequential vocab grid. Hopper blocks run in no order, so:
//   pass 1, grid (B rows, G groups): a block stages its logp row in shared
//     memory as f32 (m*4 bytes, whatever the stored width, converted while
//     staging), walks the catalog grid-strided over the G groups,
//     keeps a sorted top-K per thread in registers (K is a compile-time cap
//     >= topk), and merges its threads into one partial top-k per
//     (group, row) in scratch the wrapper allocated. A warp runs a K-step
//     insertion whenever any of its lanes inserts, which early on is nearly
//     every step; so after kSampleIters iterations the block takes the
//     topk-th best score of what it has seen as a threshold, and later ids
//     scoring below it (beaten by topk real ids already) are not pushed.
//     That drops only ids that cannot be in the answer, so it stays exact;
//   pass 2, grid (B rows): one block per row merges the G partials.
// Rows are the fast grid index, so the B blocks of one group are launched
// together and read the same H addresses, so that H can come from DRAM
// about once while the other rows re-read it from L2. Because (score desc,
// id asc) is a total order, the result does not depend on which block ran
// first, and no atomics are used. The in-kernel hash walks h_j
// incrementally, adding h2 and j(j-1)/2 mod m with one conditional
// subtraction each, which equals the formula above because no uint32 sum in
// it wraps (k <= kMaxHashK and m <= the shared-memory row keep (k + 1) * m
// far below 2^32). What still
// keeps it above the bound: every row's blocks re-read H from L2 (B*d*k*4
// bytes of L2 traffic), or rehash every id, and gather from shared memory
// with bank conflicts; its measured time is in PERF.md (chip_smoke.py).
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// H loads a thread keeps in flight in pass 1 (-D to tune it, see
// kernels/sweep_decode_topk.py)
#ifndef BLOOM_DECODE_TOPK_UNROLL
#define BLOOM_DECODE_TOPK_UNROLL 4
#endif
constexpr int kUnroll = BLOOM_DECODE_TOPK_UNROLL;
// pass-1 iterations each thread scores before its block sets the threshold
constexpr int kSampleIters = 32;
constexpr int kSentinelId = 0x7fffffff;  // loses every tie to a real id
// most hash functions the in-kernel hash takes (the wrapper raises above)
constexpr int kMaxHashK = 32;

// logp storage dtype codes of the C interface
enum Dtype { kF32 = 0, kBF16 = 1, kI8 = 2, kFP8 = 3 };

// The in-kernel hash's constants: the salts (hashing.double_hash_salts),
// m and max(m - 1, 1), and step[j] = (j(j-1)/2) % m, the increment of the
// (j^3 - j)/6 term from h_{j-1} to h_j.
struct HashSpec {
  unsigned c1, c2, m, m1;
  const unsigned* step;  // shared memory, k entries
};

__device__ __forceinline__ unsigned splitmix32(unsigned z) {
  z += 0x9E3779B9u;
  z = (z ^ (z >> 16)) * 0x85EBCA6Bu;
  z = (z ^ (z >> 13)) * 0xC2B2AE35u;
  return z ^ (z >> 16);
}

__device__ __forceinline__ bool better(float v, int i, float ov, int oi) {
  return v > ov || (v == ov && i < oi);
}

// A thread's running top-K, sorted by `better`, held in registers: every
// index below is a compile-time constant after unrolling.
template <int K>
struct TopK {
  float v[K];
  int id[K];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      v[q] = -CUDART_INF_F;
      id[q] = kSentinelId;
    }
  }

  __device__ __forceinline__ void push(float s, int i) {
    if (!better(s, i, v[K - 1], id[K - 1])) return;
    // position q takes the old entry q-1 when the new entry ranks above it,
    // else the new entry itself; q runs downwards, so v[q] and v[q-1] still
    // hold their old values when position q is decided
#pragma unroll
    for (int q = K - 1; q > 0; --q) {
      if (better(s, i, v[q], id[q])) {
        const bool above = better(s, i, v[q - 1], id[q - 1]);
        v[q] = above ? v[q - 1] : s;
        id[q] = above ? id[q - 1] : i;
      }
    }
    if (better(s, i, v[0], id[0])) {
      v[0] = s;
      id[0] = i;
    }
  }

  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int q = 0; q < K - 1; ++q) {
      v[q] = v[q + 1];
      id[q] = id[q + 1];
    }
    v[K - 1] = -CUDART_INF_F;
    id[K - 1] = kSentinelId;
  }
};

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// Writes the block's best `topk` entries, in order, to out_v/out_i: each
// round finds the best head of all the threads' lists and pops it from the
// one thread that holds it (ids are unique within a block; sentinels may
// repeat, and popping a sentinel changes nothing).
template <int K>
__device__ void block_select(TopK<K>& t, int topk, float* out_v, int* out_i) {
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ int win_i;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = 0; r < topk; ++r) {
    float cv = t.v[0];
    int ci = t.id[0];
    warp_best(cv, ci);
    if (lane == 0) {
      warp_v[warp] = cv;
      warp_i[warp] = ci;
    }
    __syncthreads();
    if (warp == 0) {
      cv = lane < kWarps ? warp_v[lane] : -CUDART_INF_F;
      ci = lane < kWarps ? warp_i[lane] : kSentinelId;
      warp_best(cv, ci);
      if (lane == 0) {
        win_i = ci;
        out_v[r] = cv;
        out_i[r] = ci;
      }
    }
    __syncthreads();
    if (t.id[0] == win_i) t.pop();
  }
}

// Pushes the scores of ids i = begin, begin + stride, ... < end whose score
// is at least theta. Each score is summed in j order in f32. With H null the
// indices come from the hash `hs` (see the file comment).
template <int K>
__device__ __forceinline__ void scan(TopK<K>& t, const float* row,
                                     const int* __restrict__ H,
                                     const HashSpec& hs, int k, unsigned i,
                                     unsigned end, unsigned stride,
                                     float theta) {
  if (H == nullptr) {
    for (; i < end; i += stride) {
      unsigned x = splitmix32(i ^ hs.c1) % hs.m;
      const unsigned h2 = splitmix32(i ^ hs.c2) % hs.m1 + 1u;
      float s = row[x];
      for (int j = 1; j < k; ++j) {
        x += h2;
        if (x >= hs.m) x -= hs.m;
        x += hs.step[j];
        if (x >= hs.m) x -= hs.m;
        s = __fadd_rn(s, row[x]);
      }
      if (s >= theta) t.push(s, (int)i);
    }
  } else if (k == 2) {
    const int2* H2 = reinterpret_cast<const int2*>(H);
    for (; i + (kUnroll - 1) * stride < end; i += kUnroll * stride) {
      int2 h[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) h[u] = H2[i + u * stride];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float s = row[h[u].x] + row[h[u].y];
        if (s >= theta) t.push(s, (int)(i + u * stride));
      }
    }
    for (; i < end; i += stride) {
      const int2 h = H2[i];
      const float s = row[h.x] + row[h.y];
      if (s >= theta) t.push(s, (int)i);
    }
  } else {
    for (; i < end; i += stride) {
      const int* h = H + (size_t)i * k;
      float s = row[h[0]];
      for (int j = 1; j < k; ++j) s += row[h[j]];
      if (s >= theta) t.push(s, (int)i);
    }
  }
}

// The topk-th best entry of the block's lists so far: a score every id of
// the answer reaches, since topk real ids score at least that much. The
// entries block_select pops are pushed back, so the lists are unchanged
// in what they can contribute.
template <int K>
__device__ float block_threshold(TopK<K>& t, int topk) {
  __shared__ float sel_v[64];
  __shared__ int sel_i[64];
  block_select<K>(t, topk, sel_v, sel_i);
  if (threadIdx.x < topk) t.push(sel_v[threadIdx.x], sel_i[threadIdx.x]);
  return sel_v[topk - 1];
}

// Stages logp row b as f32 in shared memory: the stored value widened, and
// for int8 multiplied by the row's scale (rounded on its own).
__device__ __forceinline__ void stage_row(float* row, const void* logp,
                                          int dtype, const float* scales,
                                          int b, int m) {
  const size_t off = (size_t)b * m;
  switch (dtype) {
    case kF32: {
      const float* src = static_cast<const float*>(logp) + off;
      for (int c = threadIdx.x; c < m; c += kThreads) row[c] = src[c];
      break;
    }
    case kBF16: {
      const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(logp) + off;
      for (int c = threadIdx.x; c < m; c += kThreads)
        row[c] = __bfloat162float(src[c]);
      break;
    }
    case kI8: {
      const int8_t* src = static_cast<const int8_t*>(logp) + off;
      const float s = scales[b];
      for (int c = threadIdx.x; c < m; c += kThreads)
        row[c] = __fmul_rn(static_cast<float>(src[c]), s);
      break;
    }
    case kFP8: {
      const __nv_fp8_e4m3* src = static_cast<const __nv_fp8_e4m3*>(logp) + off;
      for (int c = threadIdx.x; c < m; c += kThreads)
        row[c] = static_cast<float>(src[c]);
      break;
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    decode_topk_partial(const void* __restrict__ logp, int dtype,
                        const float* __restrict__ scales,
                        const int* __restrict__ H, unsigned c1, unsigned c2,
                        const int* __restrict__ active,
                        float* __restrict__ part_v, int* __restrict__ part_i,
                        int B, int m, int d, int k, int topk) {
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  if (active != nullptr && active[b] == 0) return;

  extern __shared__ float row[];
  __shared__ unsigned step[kMaxHashK];
  stage_row(row, logp, dtype, scales, b, m);
  if (H == nullptr && threadIdx.x < k) {
    const unsigned long long j = threadIdx.x;   // j(j-1)/2 is 0 at j = 0
    step[j] = (unsigned)(j * (j - 1) / 2 % (unsigned)m);
  }
  __syncthreads();
  const HashSpec hs{c1, c2, (unsigned)m, (unsigned)(m > 1 ? m - 1 : 1),
                    step};

  TopK<K> t;
  t.init();
  const unsigned stride = gridDim.y * kThreads;
  const unsigned first = g * kThreads + threadIdx.x;
  const unsigned sample_end = min(first + kSampleIters * stride, (unsigned)d);
  scan<K>(t, row, H, hs, k, first, sample_end, stride, -CUDART_INF_F);
  const float theta = block_threshold<K>(t, topk);
  scan<K>(t, row, H, hs, k, sample_end, (unsigned)d, stride, theta);
  const size_t off = ((size_t)g * B + b) * topk;
  block_select<K>(t, topk, part_v + off, part_i + off);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    decode_topk_merge(const float* __restrict__ part_v,
                      const int* __restrict__ part_i,
                      const int* __restrict__ active, float* __restrict__ vals,
                      int* __restrict__ ids, int B, int G, int topk) {
  const int b = blockIdx.x;
  float* out_v = vals + (size_t)b * topk;
  int* out_i = ids + (size_t)b * topk;
  if (active != nullptr && active[b] == 0) {
    for (int r = threadIdx.x; r < topk; r += kThreads) {
      out_v[r] = -CUDART_INF_F;
      out_i[r] = 0;
    }
    return;
  }
  TopK<K> t;
  t.init();
  const int n = G * topk;
  for (int c = threadIdx.x; c < n; c += kThreads) {
    const size_t off = ((size_t)(c / topk) * B + b) * topk + c % topk;
    t.push(part_v[off], part_i[off]);
  }
  block_select<K>(t, topk, out_v, out_i);
}

template <int K>
int launch(const void* logp, int dtype, const float* scales, const int* H,
           unsigned c1, unsigned c2, const int* active, float* part_v,
           int* part_i, float* vals, int* ids, int B, int m, int d, int k,
           int topk, int groups, cudaStream_t stream) {
  const size_t smem = (size_t)m * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_topk_partial<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_topk_partial<K><<<dim3(B, groups), kThreads, smem, stream>>>(
      logp, dtype, scales, H, c1, c2, active, part_v, part_i, B, m, d, k,
      topk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_topk_merge<K><<<B, kThreads, 0, stream>>>(
      part_v, part_i, active, vals, ids, B, groups, topk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest topk the kernel takes; the Python wrapper raises above it.
int bloom_decode_topk_max_topk() { return 64; }

// Largest k the in-kernel hash takes; the Python wrapper raises above it.
int bloom_decode_topk_max_hash_k() { return kMaxHashK; }

// Launches both passes on `stream` without synchronising. logp is (B, m)
// stored as `dtype` (a Dtype code); scales (B,) f32 for int8, else null;
// H (d, k) int32, or null to hash in the kernel with the salts c1, c2;
// part_v/part_i are (groups, B, topk) scratch, vals/ids (B, topk); active
// is null or (B,) int32. Returns the CUDA error code of the launches (0 on
// success).
int bloom_decode_topk(const void* logp, int dtype, const float* scales,
                      const int* H, unsigned c1, unsigned c2,
                      const int* active, float* part_v, int* part_i,
                      float* vals, int* ids, int B, int m, int d, int k,
                      int topk, int groups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype < kF32 || dtype > kFP8 || (dtype == kI8) != (scales != nullptr) ||
      (H == nullptr && k > kMaxHashK))
    return (int)cudaErrorInvalidValue;
  if (topk <= 16)
    return launch<16>(logp, dtype, scales, H, c1, c2, active, part_v, part_i,
                      vals, ids, B, m, d, k, topk, groups, s);
  if (topk <= 64)
    return launch<64>(logp, dtype, scales, H, c1, c2, active, part_v, part_i,
                      vals, ids, B, m, d, k, topk, groups, s);
  return (int)cudaErrorInvalidValue;
}

const char* bloom_decode_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
