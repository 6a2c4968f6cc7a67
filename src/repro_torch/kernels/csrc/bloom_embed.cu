// Bloom embedding forward for Hopper (sm_90a): the k-way row gather-sum
//     out[t, :] = row(idx[t, 0]) + row(idx[t, 1]) + ...
// over a table stored in f32, bf16, int8 with one f32 scale per row, or
// fp8 e4m3, where row(r) is table[r, :] widened to f32 (times scales[r] for
// int8). Summed in f32 in j order from row 0 and rounded once to the output
// dtype (f32 or bf16), so it is bit-identical to its plain PyTorch version:
// widening bf16 or fp8 to f32 is exact, and the int8 product q * scale is
// rounded on its own (__fmul_rn: never contracted into an FMA with the add).
//
// Replaces the Pallas TPU kernels src/repro/kernels/bloom_embed.py ::
// bloom_embed_pallas (_embed_fwd -> _fwd_kernel, the table_dtype=None path)
// and its quantized variants (_fwd_kernel_scaled via _embed_fwd_quant and
// bloom_embed_fwd_quantized). The TPU kernel keeps the table in HBM, starts
// t_tile * k async row DMAs per grid step into VMEM, and (int8) prefetches
// the (T, k) scales gathered on the host; here each block gathers its rows
// straight from device memory with 16-byte loads and reads each row's scale
// itself (one f32 per row, shared by the block's threads): every table
// element is used once per token, so there is nothing to stage.
//
// Bound on the H100: bytes. The least traffic is each distinct gathered row
// once (<= T*k*D*itemsize, plus 4 bytes of scale per int8 row), the (T, k)
// int32 indices and the (T, D) output; the T*(k-1)*D adds are negligible.
// At T = 8, D = 1024, k = 4 that is ~40-80 KB, far below what one launch
// costs, so at decode shapes the kernel is bound by launch latency.
//
// Design: grid (T tokens, column chunks). On the vector path (D a multiple
// of 16 bytes' worth of stored elements, table and out 16-byte aligned)
// each thread owns one 16-byte chunk of every row: kVec = 16 / itemsize
// columns (4 f32, 8 bf16, 16 int8 or fp8). It loads that chunk of each of
// the k rows (one uint4 each, neighbouring threads on neighbouring
// addresses), widens to f32, adds in j order, and stores kVec outputs with
// the widest aligned stores (8 to 64 bytes). Otherwise (a ragged D) the
// same walk runs one element per thread.
//
// Dense backward (bwd_impl="dense"), in the same library:
//     dtable[r, :] = sum over (t, j) with idx[t, j] == r of g[t, :]
// into (m, D) f32 from g (T, D) f32 or bf16, every row written (zeros for a
// row no entry reaches). Replaces src/repro/kernels/bloom_embed.py ::
// bloom_embed_bwd_pallas (_bwd_kernel): per m-tile, a one-hot count of the
// token tile's indices (kernels/common.py :: onehot_count) contracted with
// g on the MXU, in the compiler's order. Here a block owns an (m-tile,
// column chunk) of the output, accumulated in shared memory; it compacts
// the entries whose row falls in its tile into a shared list in (t, j)
// order (csrc/bloom_compact.cuh) and every thread adds each listed entry's
// g row into its own columns, so each output sums in (t, j) order from 0.0:
// the order of the CSR bins, bit-identical to csrc/bloom_csr.cu, with no
// float atomics. Bound: bytes, the (m, D) f32 output written once (124 MB
// at m = 30,208, D = 1024: 37 us at 3.35 TB/s) plus g and idx once; every
// block re-reads the (T, k) indices from L2.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bloom_compact.cuh"

namespace {

constexpr int kMaxThreads = 128;

// storage and output dtype codes of the C interface
enum Dtype { kF32 = 0, kBF16 = 1, kI8 = 2, kFP8 = 3 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

// row(r)[c] as f32: the stored value, times the row's scale for int8
template <typename S>
__device__ __forceinline__ float load_scaled(S v, float scale) {
  if constexpr (std::is_same<S, int8_t>::value)
    return __fmul_rn(to_f32(v), scale);
  else
    return to_f32(v);
}

template <typename S>
__device__ __forceinline__ float row_scale(const float* scales, int r) {
  if constexpr (std::is_same<S, int8_t>::value)
    return __ldg(scales + r);
  else
    return 1.0f;
}

// One element per thread: any D, any alignment.
template <typename S, typename O>
__global__ void __launch_bounds__(kMaxThreads)
    embed_fwd_scalar(const S* __restrict__ table,
                     const float* __restrict__ scales,
                     const int* __restrict__ idx, O* __restrict__ out, int D,
                     int k) {
  const int t = blockIdx.x;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= D) return;
  const int* rows = idx + (size_t)t * k;
  int r = rows[0];
  float acc = load_scaled(table[(size_t)r * D + c], row_scale<S>(scales, r));
  for (int j = 1; j < k; ++j) {
    r = rows[j];
    acc = __fadd_rn(acc, load_scaled(table[(size_t)r * D + c],
                                     row_scale<S>(scales, r)));
  }
  from_f32(acc, out + (size_t)t * D + c);
}

// One 16-byte chunk of stored elements (kVec of them) per thread; needs
// D % kVec == 0 and 16-byte aligned table and out.
template <typename S, typename O>
__global__ void __launch_bounds__(kMaxThreads)
    embed_fwd_vec(const S* __restrict__ table,
                  const float* __restrict__ scales,
                  const int* __restrict__ idx, O* __restrict__ out, int D,
                  int k) {
  constexpr int kVec = 16 / sizeof(S);
  constexpr int kOutBytes = kVec * sizeof(O);
  // the widest store the output chunk's alignment allows: 16 bytes, or 8
  // for f32 stored and bf16 out (4 columns)
  using W = typename std::conditional<kOutBytes % 16 == 0, uint4,
                                      uint2>::type;
  constexpr int kWords = kOutBytes / sizeof(W);
  const int t = blockIdx.x;
  const int chunk = blockIdx.y * blockDim.x + threadIdx.x;
  const int n_chunks = D / kVec;
  if (chunk >= n_chunks) return;
  const int* rows = idx + (size_t)t * k;
  float acc[kVec];
  for (int j = 0; j < k; ++j) {
    const int r = rows[j];
    const float s = row_scale<S>(scales, r);
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
                                table + (size_t)r * D) + chunk);
    const S* v = reinterpret_cast<const S*>(&raw);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float x = load_scaled(v[e], s);
      acc[e] = j == 0 ? x : __fadd_rn(acc[e], x);
    }
  }
  W packed[kWords];
  O* o = reinterpret_cast<O*>(packed);
#pragma unroll
  for (int e = 0; e < kVec; ++e) from_f32(acc[e], o + e);
  W* dst = reinterpret_cast<W*>(out + (size_t)t * D + (size_t)chunk * kVec);
#pragma unroll
  for (int w = 0; w < kWords; ++w) dst[w] = packed[w];
}

int round_up_warp(int n) { return (n + 31) / 32 * 32; }

template <typename S, typename O>
int launch(const void* table_, const float* scales, const int* idx,
           void* out_, int T, int D, int k, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(S);
  const S* table = static_cast<const S*>(table_);
  O* out = static_cast<O*>(out_);
  const bool vec = D % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int n = vec ? D / kVec : D;
  const int threads = n < kMaxThreads ? round_up_warp(n) : kMaxThreads;
  const dim3 grid(T, (n + threads - 1) / threads);
  if (vec)
    embed_fwd_vec<S, O><<<grid, threads, 0, s>>>(table, scales, idx, out, D,
                                                 k);
  else
    embed_fwd_scalar<S, O><<<grid, threads, 0, s>>>(table, scales, idx, out,
                                                    D, k);
  return (int)cudaGetLastError();
}

template <typename S>
int launch_out(const void* table, const float* scales, const int* idx,
               void* out, int T, int D, int k, int out_dtype,
               cudaStream_t s) {
  if (out_dtype == kF32)
    return launch<S, float>(table, scales, idx, out, T, D, k, s);
  if (out_dtype == kBF16)
    return launch<S, __nv_bfloat16>(table, scales, idx, out, T, D, k, s);
  return (int)cudaErrorInvalidValue;
}

// Dense backward: kBwdRows output rows by kBwdCols columns per block;
// thread t owns columns c0 + t + v * kBwdThreads, v < kBwdVecs, of every
// row of the tile (neighbouring threads on neighbouring columns).
constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdVecs = 4;
constexpr int kBwdCols = kBwdThreads * kBwdVecs;
constexpr int kBwdRows = 16;
constexpr int kBwdPer = 8;
constexpr int kBwdStep = kBwdThreads * kBwdPer;
constexpr size_t kBwdSmem = (size_t)kBwdRows * kBwdCols * sizeof(float);

template <typename G>
__global__ void __launch_bounds__(kBwdThreads)
    embed_bwd_dense(const G* __restrict__ g, const int* __restrict__ idx,
                    float* __restrict__ out, int T, int D, int m, int k) {
  extern __shared__ float acc[];   // (kBwdRows, kBwdCols)
  __shared__ int list[kBwdStep];
  __shared__ int warp_tot[kBwdWarps];
  const int base = blockIdx.x * kBwdRows;
  const int c0 = blockIdx.y * kBwdCols + threadIdx.x;
  for (int r = 0; r < kBwdRows; ++r)
#pragma unroll
    for (int v = 0; v < kBwdVecs; ++v)
      acc[r * kBwdCols + v * kBwdThreads + threadIdx.x] = 0.0f;
  const long long n = (long long)T * k;
  for (long long e0 = 0; e0 < n; e0 += kBwdStep) {
    const int hits = bloom_compact::compact<kBwdPer>(
        idx, e0, n, base, kBwdRows, list, warp_tot);
    for (int q = 0; q < hits; ++q) {
      const int p = list[q];
      const G* gt = g + (size_t)((e0 + (p >> bloom_compact::kOffBits)) / k) *
                            D;
      float* a = acc + (p & bloom_compact::kOffMask) * kBwdCols + threadIdx.x;
#pragma unroll
      for (int v = 0; v < kBwdVecs; ++v) {
        const int c = c0 + v * kBwdThreads;
        if (c < D)
          a[v * kBwdThreads] = __fadd_rn(a[v * kBwdThreads], to_f32(gt[c]));
      }
    }
  }
  for (int r = 0; r < kBwdRows && base + r < m; ++r)
#pragma unroll
    for (int v = 0; v < kBwdVecs; ++v) {
      const int c = c0 + v * kBwdThreads;
      if (c < D)
        out[(size_t)(base + r) * D + c] =
            acc[r * kBwdCols + v * kBwdThreads + threadIdx.x];
    }
}

template <typename G>
int launch_bwd(const G* g, const int* idx, float* out, int T, int D, int m,
               int k, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      embed_bwd_dense<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kBwdSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m + kBwdRows - 1) / kBwdRows,
                  (D + kBwdCols - 1) / kBwdCols);
  embed_bwd_dense<G><<<grid, kBwdThreads, kBwdSmem, s>>>(g, idx, out, T, D,
                                                          m, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The dense backward: g (T, D) as `g_dtype` (kF32 or kBF16), idx (T, k)
// int32 (entries outside [0, m), such as -1 pads, never match), out (m, D)
// f32, all contiguous on one device. Launches on `stream` without
// synchronising; returns the CUDA error code of the launch (0 on success).
int bloom_embed_bwd_dense(const void* g, int g_dtype, const int* idx,
                          float* out, int T, int D, int m, int k,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_dtype == kF32)
    return launch_bwd<float>(static_cast<const float*>(g), idx, out, T, D, m,
                             k, s);
  if (g_dtype == kBF16)
    return launch_bwd<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(g),
                                     idx, out, T, D, m, k, s);
  return (int)cudaErrorInvalidValue;
}


// table (m, D) stored as `table_dtype` (a Dtype code), scales (m,) f32 for
// int8 and null otherwise, idx (T, k) int32 in [0, m), out (T, D) as
// `out_dtype` (kF32 or kBF16), all contiguous on one device. Launches on
// `stream` without synchronising; returns the CUDA error code of the
// launch (0 on success).
int bloom_embed_fwd(const void* table, const float* scales, const int* idx,
                    void* out, int T, int D, int k, int table_dtype,
                    int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (table_dtype) {
    case kF32:
      return launch_out<float>(table, scales, idx, out, T, D, k, out_dtype,
                               s);
    case kBF16:
      return launch_out<__nv_bfloat16>(table, scales, idx, out, T, D, k,
                                       out_dtype, s);
    case kI8:
      if (scales == nullptr) return (int)cudaErrorInvalidValue;
      return launch_out<int8_t>(table, scales, idx, out, T, D, k, out_dtype,
                                s);
    case kFP8:
      return launch_out<__nv_fp8_e4m3>(table, scales, idx, out, T, D, k,
                                       out_dtype, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* bloom_embed_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
