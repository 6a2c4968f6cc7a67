// Fused Bloom Eq. 3 decode + top-k for Hopper (sm_90a), float32 logp with an
// explicit (d, k) hash matrix.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bloom_decode_topk.py ::
// bloom_decode_topk_pallas: its dense grid (_kernel) and its row-skipping
// grid (_kernel_skip) are one kernel here, with an optional `active` mask.
//
// What it computes, for each row b with active[b] != 0 (or every row when
// active is null): the topk ids over i in [0, d) of
//     score[b, i] = logp[b, H[i, 0]] + logp[b, H[i, 1]] + ...
// summed in f32 in j order, ranked by the total order (score descending,
// id ascending), so equal scores resolve to the lowest id. A row with
// active[b] == 0 does no work and returns (-inf, 0).
//
// Bound on the H100: bytes. The least traffic is H once (d*k*4 bytes), each
// live logp row once (m*4) and the outputs (B*topk*8): at d = 1e7, k = 2,
// m = 8192, B = 8 that is ~80.3 MB, ~24 us at 3.35 TB/s. The adds are
// d*B*(k-1) f32 operations, ~1 us at 67 TFLOP/s.
//
// Design. The TPU kernel carries its running top-k in VMEM scratch across a
// sequential vocab grid. Hopper blocks run in no order, so:
//   pass 1, grid (B rows, G groups): a block stages its logp row (m*4 bytes)
//     in shared memory, walks the catalog grid-strided over the G groups,
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
// about once while the other rows re-read it from L2. Because (score desc, id asc) is a total
// order, the result does not depend on which block ran first, and no atomics
// are used. What still keeps it above the bound: every row's blocks re-read
// H from L2 (B*d*k*4 bytes of L2 traffic) and gather from shared memory
// with bank conflicts; its measured time is in PERF.md (chip_smoke.py).
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
// is at least theta. Each score is summed in j order in f32.
template <int K>
__device__ __forceinline__ void scan(TopK<K>& t, const float* row,
                                     const int* __restrict__ H, int k,
                                     unsigned i, unsigned end,
                                     unsigned stride, float theta) {
  if (k == 2) {
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

template <int K>
__global__ void __launch_bounds__(kThreads)
    decode_topk_partial(const float* __restrict__ logp,
                        const int* __restrict__ H,
                        const int* __restrict__ active,
                        float* __restrict__ part_v, int* __restrict__ part_i,
                        int B, int m, int d, int k, int topk) {
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  if (active != nullptr && active[b] == 0) return;

  extern __shared__ float row[];
  const float* src = logp + (size_t)b * m;
  for (int c = threadIdx.x; c < m; c += kThreads) row[c] = src[c];
  __syncthreads();

  TopK<K> t;
  t.init();
  const unsigned stride = gridDim.y * kThreads;
  const unsigned first = g * kThreads + threadIdx.x;
  const unsigned sample_end = min(first + kSampleIters * stride, (unsigned)d);
  scan<K>(t, row, H, k, first, sample_end, stride, -CUDART_INF_F);
  const float theta = block_threshold<K>(t, topk);
  scan<K>(t, row, H, k, sample_end, (unsigned)d, stride, theta);
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
int launch(const float* logp, const int* H, const int* active, float* part_v,
           int* part_i, float* vals, int* ids, int B, int m, int d, int k,
           int topk, int groups, cudaStream_t stream) {
  const size_t smem = (size_t)m * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_topk_partial<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_topk_partial<K><<<dim3(B, groups), kThreads, smem, stream>>>(
      logp, H, active, part_v, part_i, B, m, d, k, topk);
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

// Launches both passes on `stream` without synchronising. part_v/part_i are
// (groups, B, topk) scratch, vals/ids (B, topk); active is null or (B,)
// int32. Returns the CUDA error code of the launches (0 on success).
int bloom_decode_topk_f32(const float* logp, const int* H, const int* active,
                          float* part_v, int* part_i, float* vals, int* ids,
                          int B, int m, int d, int k, int topk, int groups,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (topk <= 16)
    return launch<16>(logp, H, active, part_v, part_i, vals, ids, B, m, d, k,
                      topk, groups, s);
  if (topk <= 64)
    return launch<64>(logp, H, active, part_v, part_i, vals, ids, B, m, d, k,
                      topk, groups, s);
  return (int)cudaErrorInvalidValue;
}

const char* bloom_decode_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
