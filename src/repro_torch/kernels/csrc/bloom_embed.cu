// Bloom embedding forward for Hopper (sm_90a): the k-way row gather-sum
//     out[t, :] = table[idx[t, 0], :] + table[idx[t, 1], :] + ...
// summed in f32 in j order and rounded once to the table's dtype (f32 or
// bf16), so it is bit-identical to its plain PyTorch version.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bloom_embed.py ::
// bloom_embed_pallas, forward only (_embed_fwd -> _fwd_kernel, the
// table_dtype=None path). The TPU kernel keeps the table in HBM and issues
// t_tile * k async row DMAs per grid step into VMEM; here each block gathers
// its rows straight from device memory with 16-byte loads, and there is
// nothing to stage: every table element is used once per token.
//
// Bound on the H100: bytes. The least traffic is each distinct gathered row
// once (<= T*k*D*itemsize), the (T, k) int32 indices and the (T, D) output;
// the T*(k-1)*D adds are negligible next to it. At T = 8, D = 1024, k = 4,
// bf16 that is ~80 KB, far below what one launch costs, so at decode shapes
// the kernel is bound by launch latency, not by the card.
//
// Design: grid (T tokens, column chunks); block of kThreads threads. On the
// vector path (D a multiple of 16 bytes' worth of elements and both
// pointers 16-byte aligned) each thread owns one 16-byte column chunk:
// it loads that chunk of each of the k rows (one uint4 each, neighbouring
// threads on neighbouring addresses), widens to f32, adds in j order, and
// stores one uint4. Otherwise (a ragged D) the same walk runs one element
// per thread. D = 1024 bf16 is one block of 128 threads per token.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

// One element per thread: any D, any alignment.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    embed_fwd_scalar(const T* __restrict__ table, const int* __restrict__ idx,
                     T* __restrict__ out, int D, int k) {
  const int t = blockIdx.x;
  const int c = blockIdx.y * kThreads + threadIdx.x;
  if (c >= D) return;
  const int* rows = idx + (size_t)t * k;
  float acc = to_f32(table[(size_t)rows[0] * D + c]);
  for (int j = 1; j < k; ++j) acc += to_f32(table[(size_t)rows[j] * D + c]);
  from_f32(acc, out + (size_t)t * D + c);
}

// One 16-byte chunk (kVec elements) per thread; needs D % kVec == 0 and
// 16-byte aligned table and out.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    embed_fwd_vec(const T* __restrict__ table, const int* __restrict__ idx,
                  T* __restrict__ out, int D, int k) {
  constexpr int kVec = 16 / sizeof(T);
  const int t = blockIdx.x;
  const int chunk = blockIdx.y * kThreads + threadIdx.x;
  const int n_chunks = D / kVec;
  if (chunk >= n_chunks) return;
  const int* rows = idx + (size_t)t * k;
  float acc[kVec];
  for (int j = 0; j < k; ++j) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
                                table + (size_t)rows[j] * D) + chunk);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      acc[e] = j == 0 ? to_f32(v[e]) : acc[e] + to_f32(v[e]);
  }
  uint4 packed;
  T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
  for (int e = 0; e < kVec; ++e) from_f32(acc[e], o + e);
  reinterpret_cast<uint4*>(out + (size_t)t * D)[chunk] = packed;
}

template <typename T>
int launch(const T* table, const int* idx, T* out, int T_, int D, int k,
           void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = D % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    const int n_chunks = D / kVec;
    const dim3 grid(T_, (n_chunks + kThreads - 1) / kThreads);
    embed_fwd_vec<T><<<grid, kThreads, 0, s>>>(table, idx, out, D, k);
  } else {
    const dim3 grid(T_, (D + kThreads - 1) / kThreads);
    embed_fwd_scalar<T><<<grid, kThreads, 0, s>>>(table, idx, out, D, k);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// table (m, D), idx (T, k) int32 in [0, m), out (T, D), all contiguous on
// one device. Launches on `stream` without synchronising; returns the CUDA
// error code of the launch (0 on success).
int bloom_embed_fwd_f32(const float* table, const int* idx, float* out,
                        int T, int D, int k, void* stream) {
  return launch<float>(table, idx, out, T, D, k, stream);
}

int bloom_embed_fwd_bf16(const void* table, const int* idx, void* out, int T,
                         int D, int k, void* stream) {
  return launch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(table), idx,
                               static_cast<__nv_bfloat16*>(out), T, D, k,
                               stream);
}

const char* bloom_embed_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
