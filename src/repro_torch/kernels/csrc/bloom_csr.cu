// CSR scatter-add for Hopper (sm_90a): the backward of the Bloom embedding,
//     out[r, :] = sum over entries e in [row_ptr[r], row_ptr[r + 1]) of
//                 g[src[e], :]
// where the entries are the flat (T * k) hash indices stably sorted by their
// value (so each row's entries come in token, then j, order), src[e] is the
// token row of entry e, and row_ptr (m + 1) holds each output row's segment.
// g (T, D) f32 or bf16, out (m, D) f32. Each row is summed in f32 from 0.0 in
// entry order, so the result is the same from run to run and bit-identical to
// its plain version (zeros(m, D).index_add_ over the same sorted entries, on
// the CPU).
//
// Replaces the Pallas TPU kernel src/repro/kernels/bloom_csr.py ::
// csr_scatter_add_pallas (_csr_kernel), reached from the Bloom embedding's
// backward through bloom_embed_bwd_csr_pallas. The TPU kernel bins entries
// into fixed e_tile tiles per m-tile and accumulates a one-hot w^T @ rows
// product per tile on the MXU, because its grid runs in order and one output
// block is revisited by a consecutive run of tiles. Here blocks run in no
// order, so each block owns its output rows outright: no block ever writes a
// row another block writes, there is no float atomicAdd, and a row with no
// entries is written as zeros by its own block.
//
// Bound on the H100: bytes. The least traffic is the (m, D) f32 output once
// (124 MB at m = 30,208, D = 1024: 37 us at 3.35 TB/s), the cotangent rows
// once per entry that reads them (each token row about k times; about 4 MB
// in bf16 at T = 520, k = 4, D = 1024, mostly from L2) and the int32 segment
// arrays. The adds are negligible.
//
// Design: grid (m output rows, column chunks); block of kThreads threads. On
// the vector path (D a multiple of 16 bytes' worth of g elements and both
// pointers 16-byte aligned) each thread owns one 16-byte column chunk of g
// (8 bf16 or 4 f32 columns), walks its row's segment, widens each entry's
// chunk to f32 and adds it in entry order, then stores its f32 columns with
// 16-byte stores. Otherwise (a ragged D) the same walk runs one column per
// thread. D = 1024 bf16 is one block of 128 threads per output row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One column per thread: any D, any alignment.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    csr_scalar(const T* __restrict__ g, const int* __restrict__ row_ptr,
               const int* __restrict__ src, float* __restrict__ out, int D) {
  const int r = blockIdx.x;
  const int c = blockIdx.y * kThreads + threadIdx.x;
  if (c >= D) return;
  const int e1 = row_ptr[r + 1];
  float acc = 0.0f;
#pragma unroll 4
  for (int e = row_ptr[r]; e < e1; ++e)
    acc += to_f32(g[(size_t)__ldg(src + e) * D + c]);
  out[(size_t)r * D + c] = acc;
}

// One 16-byte chunk of g (kVec columns) per thread; needs D % kVec == 0 and
// 16-byte aligned g and out.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    csr_vec(const T* __restrict__ g, const int* __restrict__ row_ptr,
            const int* __restrict__ src, float* __restrict__ out, int D) {
  constexpr int kVec = 16 / sizeof(T);
  const int r = blockIdx.x;
  const int chunk = blockIdx.y * kThreads + threadIdx.x;
  if (chunk >= D / kVec) return;
  const int e1 = row_ptr[r + 1];
  float acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.0f;
#pragma unroll 4
  for (int e = row_ptr[r]; e < e1; ++e) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
                                g + (size_t)__ldg(src + e) * D) + chunk);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] += to_f32(v[i]);
  }
  float4* o = reinterpret_cast<float4*>(out + (size_t)r * D) +
              chunk * (kVec / 4);
#pragma unroll
  for (int i = 0; i < kVec / 4; ++i)
    o[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                       acc[4 * i + 3]);
}

template <typename T>
int launch(const T* g, const int* row_ptr, const int* src, float* out, int m,
           int D, void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = D % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    const dim3 grid(m, (D / kVec + kThreads - 1) / kThreads);
    csr_vec<T><<<grid, kThreads, 0, s>>>(g, row_ptr, src, out, D);
  } else {
    const dim3 grid(m, (D + kThreads - 1) / kThreads);
    csr_scalar<T><<<grid, kThreads, 0, s>>>(g, row_ptr, src, out, D);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// g (T, D), row_ptr (m + 1,) int32 non-decreasing from 0, src (E,) int32
// token rows in [0, T), out (m, D) f32, all contiguous on one device.
// Launches on `stream` without synchronising; returns the CUDA error code of
// the launch (0 on success).
int bloom_csr_f32(const float* g, const int* row_ptr, const int* src,
                  float* out, int m, int D, void* stream) {
  return launch<float>(g, row_ptr, src, out, m, D, stream);
}

int bloom_csr_bf16(const void* g, const int* row_ptr, const int* src,
                   float* out, int m, int D, void* stream) {
  return launch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(g), row_ptr,
                               src, out, m, D, stream);
}

const char* bloom_csr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
