// Bloom vocabulary recovery (Eq. 3) for Hopper (sm_90a), forward and dense
// backward:
//     forward   scores[b, i] = row_b[H[i, 0]] + row_b[H[i, 1]] + ...   (B, d)
//     backward  dlogp[b, c]  = sum over (i, j) with H[i, j] == c of g[b, i]
//                                                                     (B, m)
// row_b is logp row b widened to f32 from f32, bf16 or fp8 e4m3, or, for
// int8, the raw stored values: the int8 scores are (sum_j q) * scales[b],
// one multiply per output (__fmul_rn, never contracted into an FMA), and
// the sum of k int8 values is exact in f32, so the product has a single
// rounding. Sums run in f32 in j order from j = 0 (__fadd_rn), so the
// forward is bit-identical to its plain PyTorch version.
//
// Replaces the Pallas TPU kernels src/repro/kernels/bloom_decode.py ::
// bloom_decode_pallas (_decode_fwd -> _fwd_kernel, and _fwd_kernel_scaled
// via _decode_fwd_quant for int8 logp) and bloom_decode_bwd_pallas
// (_bwd_kernel, the bwd_impl="dense" VJP). The TPU forward keeps the whole
// (b_tile, m) logp block in VMEM while the vocab streams through its grid;
// here each block stages one logp row in shared memory. The TPU backward
// sweeps m-tiles, re-reading H and g per tile, and contracts a one-hot
// count (kernels/common.py :: onehot_count) with g on the MXU, in the
// compiler's order; here each block also owns one m-tile of output columns
// and reads all of H, but compacts the entries that hit its tile into
// shared memory in entry order (csrc/bloom_compact.cuh), and each thread
// sums its own column over them from 0.0: the order of the CSR bins, so it
// is bit-identical to the CSR decode backward, with no float atomics.
//
// Bound on the H100: bytes. Forward: H once (d*k*4), each logp row once and
// the (B, d) f32 scores: 8.26 MB at B = 8, d = 151,936, k = 4, m = 30,208,
// ~2.5 us at 3.35 TB/s; the B*d*(k-1) adds are ~0.1 us at 67 TFLOP/s. The
// dense backward moves the same bytes (g (B, d) and H in, (B, m) out). What
// keeps them above it: the forward's blocks each stage a full row (B*G rows
// of 118 KB from L2) and gather from shared memory with bank conflicts; the
// backward is latency-bound: each of its m / 256 blocks (fewer than the
// card's SMs) walks all of H in d*k / 8,192 steps, and every step pays an
// L2 round trip for H, two block barriers, a serial walk of the step's hit
// list and an L2 round trip for the queued g values. Its measured time is
// in PERF.md (chip_smoke.py).
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bloom_compact.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// backward: output rows per block, and entries a thread tests per step
// (the block's hit list holds one step's entries)
constexpr int kRows = 8;
constexpr int kPer = 32;
constexpr int kStep = kThreads * kPer;
// entries a thread queues before it loads their g values
constexpr int kSlots = 4;

// logp storage dtype codes of the C interface
enum Dtype { kF32 = 0, kBF16 = 1, kI8 = 2, kFP8 = 3 };

// Stages logp row b in shared memory as f32: the stored value widened
// (int8 unscaled: the forward multiplies by the row's scale at the end).
__device__ __forceinline__ void stage_row(float* row, const void* logp,
                                          int dtype, int b, int m) {
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
      for (int c = threadIdx.x; c < m; c += kThreads)
        row[c] = static_cast<float>(src[c]);
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

// Grid (B rows, G groups): a block stages its row, then scores the ids
// g*kThreads + tid, stepping by G*kThreads, one id per thread per step.
__global__ void __launch_bounds__(kThreads)
    decode_fwd(const void* __restrict__ logp, int dtype,
               const float* __restrict__ scales, const int* __restrict__ H,
               float* __restrict__ out, int m, int d, int k) {
  const int b = blockIdx.x;
  extern __shared__ float row[];
  stage_row(row, logp, dtype, b, m);
  __syncthreads();
  const float s = dtype == kI8 ? scales[b] : 1.0f;
  float* o = out + (size_t)b * d;
  for (int i = blockIdx.y * kThreads + threadIdx.x; i < d;
       i += gridDim.y * kThreads) {
    const int* h = H + (size_t)i * k;
    float acc = row[__ldg(h)];
    for (int j = 1; j < k; ++j) acc = __fadd_rn(acc, row[__ldg(h + j)]);
    o[i] = dtype == kI8 ? __fmul_rn(acc, s) : acc;
  }
}

// Adds g[b0 + r, i] of the n <= kSlots queued entries (entry indices e,
// i = e / k, in entry order) into acc: all loads first, then the adds in
// order, so a thread waits for device memory once per batch, not once per
// entry.
__device__ __forceinline__ void add_queued(float (&acc)[kRows],
                                           const int (&queue)[kSlots], int n,
                                           const float* __restrict__ g, int d,
                                           int k, int nb) {
  float v[kSlots][kRows];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const float* gi = g + queue[s] / k;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      v[s][r] = s < n && r < nb ? __ldg(gi + (size_t)r * d) : 0.0f;
  }
#pragma unroll
  for (int s = 0; s < kSlots; ++s)
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (s < n && r < nb) acc[r] = __fadd_rn(acc[r], v[s][r]);
}

// Grid (m / kThreads column tiles, B / kRows row groups): thread t owns
// column c = tile base + t of kRows rows. The block walks H's d*k entries
// in order, kStep at a time: it lists the ones in its tile in shared memory
// (in entry order); every thread walks the list, queues the entries in its
// column, and adds their g values (add_queued) when its queue is full and
// at the end of the step. Lanes of a warp thus load together, once a step.
__global__ void __launch_bounds__(kThreads)
    decode_bwd_dense(const float* __restrict__ g, const int* __restrict__ H,
                     float* __restrict__ out, int B, int d, int m, int k) {
  __shared__ int list[kStep];
  __shared__ int warp_tot[kWarps];
  const int base = blockIdx.x * kThreads;
  const int b0 = blockIdx.y * kRows;
  const int nb = min(kRows, B - b0);
  const float* gb = g + (size_t)b0 * d;
  const long long n = (long long)d * k;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  int queue[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) queue[s] = 0;
  for (long long e0 = 0; e0 < n; e0 += kStep) {
    const int hits = bloom_compact::compact<kPer>(H, e0, n, base, kThreads,
                                                  list, warp_tot);
    int queued = 0;
    for (int q = 0; q < hits; ++q) {
      const int p = list[q];
      if ((p & bloom_compact::kOffMask) != (int)threadIdx.x) continue;
      const int e = (int)e0 + (p >> bloom_compact::kOffBits);
#pragma unroll
      for (int s = 0; s < kSlots; ++s)
        if (s == queued) queue[s] = e;
      if (++queued == kSlots) {
        add_queued(acc, queue, queued, gb, d, k, nb);
        queued = 0;
      }
    }
    add_queued(acc, queue, queued, gb, d, k, nb);
  }
  const int c = base + threadIdx.x;
  if (c >= m) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (r < nb) out[(size_t)(b0 + r) * m + c] = acc[r];
}

}  // namespace

extern "C" {

// logp (B, m) stored as `dtype` (a Dtype code), scales (B,) f32 for int8
// and null otherwise, H (d, k) int32 in [0, m), out (B, d) f32, all
// contiguous on one device; `groups` blocks per row. Launches on `stream`
// without synchronising; returns the CUDA error code (0 on success).
int bloom_decode_fwd(const void* logp, int dtype, const float* scales,
                     const int* H, float* out, int B, int m, int d, int k,
                     int groups, void* stream) {
  if (dtype < kF32 || dtype > kFP8 || (dtype == kI8) != (scales != nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)m * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_fwd<<<dim3(B, groups), kThreads, smem,
               static_cast<cudaStream_t>(stream)>>>(logp, dtype, scales, H,
                                                    out, m, d, k);
  return (int)cudaGetLastError();
}

// g (B, d) f32, H (d, k) int32 (entries outside [0, m), such as -1 pads,
// never match), out (B, m) f32, all contiguous on one device. Launches on
// `stream` without synchronising; returns the CUDA error code.
int bloom_decode_bwd_dense(const float* g, const int* H, float* out, int B,
                           int d, int m, int k, void* stream) {
  const dim3 grid((m + kThreads - 1) / kThreads, (B + kRows - 1) / kRows);
  decode_bwd_dense<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, H, out, B, d, m, k);
  return (int)cudaGetLastError();
}

const char* bloom_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
