// Bloom vocabulary recovery (Eq. 3) for Hopper (sm_90a), the forward:
//     scores[b, i] = row_b[H[i, 0]] + row_b[H[i, 1]] + ...           (B, d)
// row_b is logp row b widened to f32 from f32, bf16 or fp8 e4m3, or, for
// int8, the raw stored values: the int8 scores are (sum_j q) * scales[b],
// one multiply per output (__fmul_rn, never contracted into an FMA), and
// the sum of k int8 values is exact in f32, so the product has a single
// rounding. Sums run in f32 in j order from j = 0 (__fadd_rn), so the
// forward is bit-identical to its plain PyTorch version.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bloom_decode.py ::
// bloom_decode_pallas (_decode_fwd -> _fwd_kernel, and _fwd_kernel_scaled
// via _decode_fwd_quant for int8 logp). The TPU forward keeps the whole
// (b_tile, m) logp block in VMEM while the vocab streams through its grid;
// here each block stages one logp row in shared memory. (The dense
// backward, bloom_decode_bwd_pallas, is ported by bloom_decode.py on the
// kernels of csrc/bloom_csr.cu: H binned on the card on every call, then
// the CSR scatter-add on the transposed cotangent.)
//
// Bound on the H100: bytes: H once (d*k*4), each logp row once and the
// (B, d) f32 scores: 8.26 MB at B = 8, d = 151,936, k = 4, m = 30,208,
// ~2.5 us at 3.35 TB/s; the B*d*(k-1) adds are ~0.1 us at 67 TFLOP/s. What
// keeps it above that: the blocks each stage a full row (B*G rows of 118 KB
// from L2) and gather from shared memory with bank conflicts. Its measured
// time is in PERF.md (chip_smoke.py).
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

const char* bloom_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
