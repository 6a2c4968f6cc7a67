// Bloom softmax cross-entropy for Hopper (sm_90a), forward and backward:
//     loss[t]  = lse(z[t, :]) - (1/k) * sum_j z[t, h[t, j]]     (and lse[t])
//     dz[t, c] = g[t] * (exp(z[t, c] - lse[t]) - count_j(h[t, j] == c) / k)
// z (T, m) f32 logits in the hashed space, h (T, k) int32 hashed labels in
// [0, m). A label hashed twice to one column counts twice, as the reference's
// onehot_count does.
//
// Row range (the vocab-parallel loss of a tensor-parallel step): z may be
// the columns [lo, lo + m) of the full (T, m_full) logits, one rank's shard,
// with h the global labels in [0, m_full). Only the labels that fall in the
// shard are picked (relative to lo) and counted; the forward then also
// writes the local hit sum hits[t] = sum over those labels of z[t, h - lo]
// (the caller all-reduces it, and combines the ranks' local lse into the
// global one), and the backward takes the GLOBAL lse, so that
//     dz[t, c] = g[t] * (exp(z[t, c] - lse[t]) - count_j(h[t, j] == lo + c) / k)
// is exact on the shard. lo = 0 with every label in [0, m) is the unsharded
// loss, bit for bit: the picked sum starts at 0.0 and 0.0 + x == x.
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
// Design (the second one; the first kept a serial (max, sum) update per
// element and one column chunk per block, and reached about half the bound):
// * forward: one block of kFwdThreads per row, so T = 512 rows are resident
//   at once (4 or more blocks an SM) and each SM streams ~4 rows. Each
//   thread loads a batch of kFwdU independent 16-byte vectors before it
//   uses any (64 KB or more in flight an SM), takes the batch's max with
//   fmaxf (no exp), rescales its running sum once and adds exp(x - max)
//   over the batch: one independent expf per element and one per batch, no
//   per-element branch. The k picked
//   logits are loaded by k lanes of warp 0 before the stream starts, so
//   their round trips overlap it. The block then takes the row max (fmaxf
//   shuffles), each thread rescales its sum to it once, and the sums are
//   added by shuffles and, across warps, by thread 0 in warp order; thread 0
//   adds the picked logits in j order from 0.0.
// * backward: a flat walk. The (T, m) elements are cut into equal,
//   contiguous ranges of kBwdThreads x kBwdU vectors, one a block, so no
//   block is partly empty (the first design's per-row column chunks left
//   a row's last chunk 37.5-50% full). A range spans one row or the end
//   of one and the start of the next (several rows where m is short),
//   whose g, lse and labels are read once a row segment. The labels sit
//   in registers as shard-relative columns (templated k = 1, 2, 4, 8;
//   other k read them from L1 per element, as the first design did), so
//   each element's count is k register compares.
//   Each thread loads kBwdU vectors before it computes any, and stores with
//   __stcs. The per-element expression g * (expf(x - lse) - cnt / k) is the
//   first design's, so dz is bit for bit what it wrote.
// Both take the 16-byte path when m is a multiple of 4 and the pointers are
// 16-byte aligned, and otherwise walk the row one element at a time (a
// ragged m, or a row that starts off a 16-byte boundary). Every sum runs in
// one fixed order; there is no float atomic.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// The launch shapes, the measured best (PERF.md): the forward 256 threads
// a row with 4 vectors each in flight; the backward 128 threads with 4
// vectors each, so one block's range is 512 vectors.
constexpr int kFwdThreads = 256;
constexpr int kFwdU = 4;         // loads in flight per thread
constexpr int kBwdThreads = 128;
constexpr int kBwdU = 4;

template <bool kVec>
__device__ __forceinline__ void load_batch(const float* __restrict__ row,
                                           int base, int n,
                                           float (&x)[kFwdU * (kVec ? 4 : 1)]) {
#pragma unroll
  for (int u = 0; u < kFwdU; ++u) {
    const int i = base + u * kFwdThreads;
    if (kVec) {
      float4 v = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      if (i < n) v = __ldcs(reinterpret_cast<const float4*>(row) + i);
      x[4 * u] = v.x;
      x[4 * u + 1] = v.y;
      x[4 * u + 2] = v.z;
      x[4 * u + 3] = v.w;
    } else {
      x[u] = i < n ? __ldcs(row + i) : -INFINITY;
    }
  }
}

// at least 1,024 threads an SM (64 registers a thread), so that 512 rows
// fit on the card's 132 SMs in one wave
template <bool kVec>
__global__ void __launch_bounds__(kFwdThreads, 1024 / kFwdThreads)
    ce_fwd(const float* __restrict__ z, const int* __restrict__ h,
           float* __restrict__ loss, float* __restrict__ lse,
           float* __restrict__ hits, int m, int k, int lo) {
  constexpr int kW = kVec ? 4 : 1;
  constexpr int kWarps = kFwdThreads / 32;
  const int t = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const float* row = z + (size_t)t * m;
  const int* hr = h + (size_t)t * k;

  // the picked logits of labels 0..31, one lane each, issued now
  float pick = 0.0f;
  int inside = 0;
  if (tid < k && tid < 32) {
    const unsigned c = (unsigned)(__ldg(hr + tid) - lo);
    inside = c < (unsigned)m;
    if (inside) pick = row[c];
  }

  const int n = m / kW;
  float M = -INFINITY, s = 0.0f;   // running max, sum of exp(x - M)
  for (int base = tid; base - tid < n; base += kFwdThreads * kFwdU) {
    float x[kFwdU * kW];
    load_batch<kVec>(row, base, n, x);
    float bm = x[0];
#pragma unroll
    for (int j = 1; j < kFwdU * kW; ++j) bm = fmaxf(bm, x[j]);
    const float Mn = fmaxf(M, bm);
    if (Mn != -INFINITY) {         // else every value so far is -inf
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < kFwdU * kW; ++j) acc += expf(x[j] - Mn);
      s = s * expf(M - Mn) + acc;  // M = -inf: s is 0 and expf gives 0
      M = Mn;
    }
  }

  __shared__ float part[kWarps];
  float wm = M;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    wm = fmaxf(wm, __shfl_xor_sync(0xffffffffu, wm, off));
  if (lane == 0) part[warp] = wm;
  __syncthreads();
  float rm = part[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) rm = fmaxf(rm, part[w]);
  float rs = (M == -INFINITY) ? 0.0f : s * expf(M - rm);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    rs += __shfl_xor_sync(0xffffffffu, rs, off);
  __syncthreads();                 // every thread has read part[]
  if (lane == 0) part[warp] = rs;
  __syncthreads();
  if (warp != 0) return;

  float picked = 0.0f;             // the labels in [lo, lo + m), in j order
  const int k32 = k < 32 ? k : 32;
  for (int j = 0; j < k32; ++j) {
    const float v = __shfl_sync(0xffffffffu, pick, j);
    if (__shfl_sync(0xffffffffu, inside, j)) picked += v;
  }
  if (lane == 0) {
    for (int j = 32; j < k; ++j) {
      const unsigned c = (unsigned)(hr[j] - lo);
      if (c < (unsigned)m) picked += row[c];
    }
    float S = part[0];
    for (int w = 1; w < kWarps; ++w) S += part[w];
    const float l = rm + logf(S);
    lse[t] = l;
    if (loss != nullptr) loss[t] = l - picked / (float)k;
    if (hits != nullptr) hits[t] = picked;
  }
}

// The count of labels on shard-relative column c: K > 0 from the labels
// held in registers, K = 0 (any other k) from the row's labels in L1.
template <int K>
struct Labels {
  int col[K];
  __device__ __forceinline__ void load(const int* hr, int k, int lo) {
#pragma unroll
    for (int j = 0; j < K; ++j) col[j] = __ldg(hr + j) - lo;
  }
  __device__ __forceinline__ int count(int c) const {
    int n = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) n += col[j] == c;
    return n;
  }
};

template <>
struct Labels<0> {
  const int* hr;
  int k, lo;
  __device__ __forceinline__ void load(const int* hr_, int k_, int lo_) {
    hr = hr_;
    k = k_;
    lo = lo_;
  }
  __device__ __forceinline__ int count(int c) const {
    int n = 0;
    for (int j = 0; j < k; ++j) n += __ldg(hr + j) - lo == c;
    return n;
  }
};

// kBwdU vectors (or elements) i, i + kBwdThreads, ... of a row, those
// below i1, streamed past the caches
template <bool kVec>
__device__ __forceinline__ void bwd_load(float (&x)[kBwdU * (kVec ? 4 : 1)],
                                         const float* __restrict__ zr,
                                         int i, int i1) {
#pragma unroll
  for (int u = 0; u < kBwdU; ++u) {
    const int v = i + u * kBwdThreads;
    if (v < i1) {
      if (kVec) {
        const float4 q = __ldcs(reinterpret_cast<const float4*>(zr) + v);
        x[4 * u] = q.x;
        x[4 * u + 1] = q.y;
        x[4 * u + 2] = q.z;
        x[4 * u + 3] = q.w;
      } else {
        x[u] = __ldcs(zr + v);
      }
    }
  }
}

template <bool kVec, int K>
__global__ void __launch_bounds__(kBwdThreads)
    ce_bwd(const float* __restrict__ g, const float* __restrict__ z,
           const int* __restrict__ h, const float* __restrict__ lse,
           float* __restrict__ dz, int m, int k, int lo, long long total) {
  constexpr int kW = kVec ? 4 : 1;
  const int n = m / kW;            // vectors (or elements) per row
  const int tid = threadIdx.x;
  // a power of two for every templated k, so cnt / kf is the same exact
  // quotient whether divided or multiplied
  const float kf = K > 0 ? (float)K : (float)k;
  constexpr long long kRange = kBwdThreads * kBwdU;
  long long a = (long long)blockIdx.x * kRange;
  const long long b = a + kRange < total ? a + kRange : total;
  while (a < b) {                  // one row segment [i0, i1) a pass
    const int t = (int)(a / n);
    const int i0 = (int)(a - (long long)t * n);
    const int i1 = (int)(b - a < (long long)(n - i0) ? i0 + (b - a) : n);
    const float gt = g[t], l = lse[t];
    Labels<K> lab;
    lab.load(h + (size_t)t * k, k, lo);
    const float* zr = z + (size_t)t * m;
    float* dr = dz + (size_t)t * m;
    // a batch of kBwdU vectors in flight per thread, loaded before any
    // is used; a segment is at most one batch
    const int i = i0 + tid;
    if (i < i1) {
      float x[kBwdU * kW];
      bwd_load<kVec>(x, zr, i, i1);
#pragma unroll
      for (int u = 0; u < kBwdU; ++u) {
        const int v = i + u * kBwdThreads;
        if (v >= i1) break;
        float o[kW];
#pragma unroll
        for (int e = 0; e < kW; ++e) {
          const int cnt = lab.count(kW * v + e);
          o[e] = gt * (expf(x[kW * u + e] - l) - (float)cnt / kf);
        }
        if (kVec)
          __stcs(reinterpret_cast<float4*>(dr) + v,
                 make_float4(o[0], o[kW > 1 ? 1 : 0], o[kW > 2 ? 2 : 0],
                             o[kW > 3 ? 3 : 0]));
        else
          __stcs(dr + v, o[0]);
      }
    }
    a += i1 - i0;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool kVec, int K>
void launch_bwd(const float* g, const float* z, const int* h,
                const float* lse, float* dz, int T, int m, int k, int lo,
                cudaStream_t s) {
  const long long total = (long long)T * (kVec ? m / 4 : m);
  const long long range = kBwdThreads * kBwdU;
  const long long blocks = (total + range - 1) / range;
  if (blocks > 0)
    ce_bwd<kVec, K><<<(unsigned)blocks, kBwdThreads, 0, s>>>(
        g, z, h, lse, dz, m, k, lo, total);
}

template <bool kVec>
void launch_bwd_k(const float* g, const float* z, const int* h,
                  const float* lse, float* dz, int T, int m, int k, int lo,
                  cudaStream_t s) {
  switch (k) {
    case 1: launch_bwd<kVec, 1>(g, z, h, lse, dz, T, m, k, lo, s); break;
    case 2: launch_bwd<kVec, 2>(g, z, h, lse, dz, T, m, k, lo, s); break;
    case 4: launch_bwd<kVec, 4>(g, z, h, lse, dz, T, m, k, lo, s); break;
    case 8: launch_bwd<kVec, 8>(g, z, h, lse, dz, T, m, k, lo, s); break;
    default: launch_bwd<kVec, 0>(g, z, h, lse, dz, T, m, k, lo, s);
  }
}

}  // namespace

extern "C" {

// z (T, m) f32: the logits' columns [lo, lo + m); h (T, k) int32 global
// labels (those outside [lo, lo + m) are not picked); lse (T,) f32 out;
// loss (T,) f32 out or null; hits (T,) f32 out (the local hit sum) or null;
// all contiguous on one device. Launches on `stream` without synchronising;
// returns the CUDA error code of the launch (0 on success).
int bloom_ce_fwd(const float* z, const int* h, float* loss, float* lse,
                 float* hits, int T, int m, int k, int lo, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m % 4 == 0 && aligned16(z))
    ce_fwd<true><<<T, kFwdThreads, 0, s>>>(z, h, loss, lse, hits, m, k, lo);
  else
    ce_fwd<false><<<T, kFwdThreads, 0, s>>>(z, h, loss, lse, hits, m, k, lo);
  return (int)cudaGetLastError();
}

// g (T,) f32 cotangent of loss, z (T, m) f32 (columns [lo, lo + m)), h
// (T, k) int32 global labels, lse (T,) f32 (the global one), dz (T, m) f32
// out.
int bloom_ce_bwd(const float* g, const float* z, const int* h,
                 const float* lse, float* dz, int T, int m, int k, int lo,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m % 4 == 0 && aligned16(z) && aligned16(dz))
    launch_bwd_k<true>(g, z, h, lse, dz, T, m, k, lo, s);
  else
    launch_bwd_k<false>(g, z, h, lse, dz, T, m, k, lo, s);
  return (int)cudaGetLastError();
}

const char* bloom_ce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
