// Bloom softmax cross-entropy for Hopper (sm_90a), forward and backward:
//     loss[t]  = lse(z[t, :]) - (1/k) * sum_j z[t, h[t, j]]     (and lse[t])
//     dz[t, c] = g[t] * (exp(z[t, c] - lse[t]) - count_j(h[t, j] == c) / k)
// z (T, m) f32 logits in the hashed space, h (T, k) int32 hashed labels in
// [0, m). A label hashed twice to one column counts twice, as the reference's
// onehot_count does.
//
// Replaces the Pallas TPU kernels src/repro/kernels/bloom_ce.py ::
// bloom_ce_pallas (_ce_fwd -> _fwd_kernel) and bloom_ce_bwd_pallas
// (_bwd_kernel). The TPU kernels hold a (t_tile, m) block of rows in VMEM
// and run max, exp-sum and the k-gather over it; here there is no such block:
// each row streams through registers once in each direction.
//
// Bound on the H100: bytes. The forward reads the (T, m) f32 row once (the
// max and the exp-sum are one online pass, the k picked logits are k loads
// from L2); the backward reads it once and writes dz once. At T = 512,
// m = 30,208 that is 61.9 MB (18.5 us at 3.35 TB/s) forward and 124 MB
// (37 us) backward; the expf per element is far below the f32 peak.
//
// Design:
// * forward: one block of kFwdThreads per row. Each thread keeps an online
//   (max, sum of exp(x - max)) pair in f32 over its strided share of the
//   row, with 16-byte loads where the row allows them; the pairs are merged
//   by warp shuffles, then across warps through shared memory. Thread 0 adds
//   the k picked logits in j order, divides the sum by k and writes loss and
//   lse.
// * backward: grid (T rows, column chunks of kBwdThreads * kBwdIters
//   vectors), so T = 512 rows give 4096 blocks over the 132 SMs. Each element
//   takes its count from k compares against the row's labels.
// Both take the 16-byte path when m is a multiple of 4 and the pointers are
// 16-byte aligned, and otherwise walk the row one element per thread (a
// ragged m, or a row that starts off a 16-byte boundary).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kFwdThreads = 512;
constexpr int kBwdThreads = 256;
constexpr int kBwdIters = 4;   // vectors (or elements) per thread per block

struct MaxSum {
  float m;  // running max
  float s;  // sum of exp(x - m) over the elements seen
};

__device__ __forceinline__ void push(MaxSum& a, float x) {
  if (x > a.m) {
    a.s = a.s * expf(a.m - x) + 1.0f;
    a.m = x;
  } else if (a.m != -INFINITY) {  // -inf next to an empty pair adds nothing
    a.s += expf(x - a.m);
  }
}

__device__ __forceinline__ MaxSum merge(MaxSum a, MaxSum b) {
  const float M = fmaxf(a.m, b.m);
  if (M == -INFINITY) return {M, 0.0f};
  return {M, a.s * expf(a.m - M) + b.s * expf(b.m - M)};
}

__device__ __forceinline__ MaxSum warp_merge(MaxSum a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const MaxSum o{__shfl_xor_sync(0xffffffffu, a.m, off),
                   __shfl_xor_sync(0xffffffffu, a.s, off)};
    a = merge(a, o);
  }
  return a;
}

template <bool kVec>
__global__ void __launch_bounds__(kFwdThreads)
    ce_fwd(const float* __restrict__ z, const int* __restrict__ h,
           float* __restrict__ loss, float* __restrict__ lse, int m, int k) {
  const int t = blockIdx.x;
  const float* row = z + (size_t)t * m;
  MaxSum acc{-INFINITY, 0.0f};
  if (kVec) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
    for (int i = (int)threadIdx.x; i < m / 4; i += kFwdThreads) {
      const float4 v = __ldcs(row4 + i);   // read once: stream past the L1
      push(acc, v.x);
      push(acc, v.y);
      push(acc, v.z);
      push(acc, v.w);
    }
  } else {
    for (int i = (int)threadIdx.x; i < m; i += kFwdThreads)
      push(acc, __ldcs(row + i));
  }
  acc = warp_merge(acc);

  constexpr int kWarps = kFwdThreads / 32;
  __shared__ float part_m[kWarps], part_s[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    part_m[warp] = acc.m;
    part_s[warp] = acc.s;
  }
  __syncthreads();
  if (warp != 0) return;
  acc = lane < kWarps ? MaxSum{part_m[lane], part_s[lane]}
                      : MaxSum{-INFINITY, 0.0f};
  acc = warp_merge(acc);
  if (lane == 0) {
    const float l = acc.m + logf(acc.s);
    const int* hr = h + (size_t)t * k;
    float picked = row[hr[0]];
    for (int j = 1; j < k; ++j) picked += row[hr[j]];
    lse[t] = l;
    loss[t] = l - picked / (float)k;
  }
}

__device__ __forceinline__ float ce_grad(float x, int c, const int* hr, int k,
                                         float l, float g, float kf) {
  int cnt = 0;
  for (int j = 0; j < k; ++j) cnt += __ldg(hr + j) == c;
  return g * (expf(x - l) - (float)cnt / kf);
}

template <bool kVec>
__global__ void __launch_bounds__(kBwdThreads)
    ce_bwd(const float* __restrict__ g, const float* __restrict__ z,
           const int* __restrict__ h, const float* __restrict__ lse,
           float* __restrict__ dz, int m, int k) {
  const int t = blockIdx.x;
  const float gt = g[t], l = lse[t], kf = (float)k;
  const int* hr = h + (size_t)t * k;
  const size_t base = (size_t)t * m;
  // this block's chunk: [i0, i1) in vectors of 4 (kVec) or in elements
  const int n = kVec ? m / 4 : m;
  const int i0 = (int)blockIdx.y * kBwdThreads * kBwdIters;
  const int i1 = min(n, i0 + kBwdThreads * kBwdIters);
  if (kVec) {
    const float4* z4 = reinterpret_cast<const float4*>(z + base);
    float4* dz4 = reinterpret_cast<float4*>(dz + base);
    for (int i = i0 + (int)threadIdx.x; i < i1; i += kBwdThreads) {
      const float4 v = __ldcs(z4 + i);
      const int c = 4 * i;
      float4 o;
      o.x = ce_grad(v.x, c, hr, k, l, gt, kf);
      o.y = ce_grad(v.y, c + 1, hr, k, l, gt, kf);
      o.z = ce_grad(v.z, c + 2, hr, k, l, gt, kf);
      o.w = ce_grad(v.w, c + 3, hr, k, l, gt, kf);
      __stcs(dz4 + i, o);
    }
  } else {
    for (int c = i0 + (int)threadIdx.x; c < i1; c += kBwdThreads)
      dz[base + c] = ce_grad(__ldcs(z + base + c), c, hr, k, l, gt, kf);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// z (T, m) f32, h (T, k) int32 in [0, m), loss and lse (T,) f32, all
// contiguous on one device. Launches on `stream` without synchronising;
// returns the CUDA error code of the launch (0 on success).
int bloom_ce_fwd(const float* z, const int* h, float* loss, float* lse, int T,
                 int m, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m % 4 == 0 && aligned16(z))
    ce_fwd<true><<<T, kFwdThreads, 0, s>>>(z, h, loss, lse, m, k);
  else
    ce_fwd<false><<<T, kFwdThreads, 0, s>>>(z, h, loss, lse, m, k);
  return (int)cudaGetLastError();
}

// g (T,) f32 cotangent of loss, z (T, m) f32, h (T, k) int32, lse (T,) f32
// from the forward, dz (T, m) f32 out.
int bloom_ce_bwd(const float* g, const float* z, const int* h,
                 const float* lse, float* dz, int T, int m, int k,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_block = kBwdThreads * kBwdIters;
  if (m % 4 == 0 && aligned16(z) && aligned16(dz)) {
    const dim3 grid(T, (m / 4 + per_block - 1) / per_block);
    ce_bwd<true><<<grid, kBwdThreads, 0, s>>>(g, z, h, lse, dz, m, k);
  } else {
    const dim3 grid(T, (m + per_block - 1) / per_block);
    ce_bwd<false><<<grid, kBwdThreads, 0, s>>>(g, z, h, lse, dz, m, k);
  }
  return (int)cudaGetLastError();
}

const char* bloom_ce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
