// Bloom embedding forward for Hopper (sm_90a): the k-way row gather-sum
//     out[t, :] = row(h_0(t)) + row(h_1(t)) + ...
// over a table stored in f32, bf16, int8 with one f32 scale per row, or
// fp8 e4m3, where row(r) is table[r, :] widened to f32 (times scales[r] for
// int8). Summed in f32 in j order from row 0 and rounded once to the output
// dtype (f32 or bf16), so it is bit-identical to its plain PyTorch version:
// widening bf16 or fp8 to f32 is exact, and the int8 product q * scale is
// rounded on its own (__fmul_rn: never contracted into an FMA with the add).
// The indices h_j(t) come from one of four sources:
//   * idx: a (T, k) int32 matrix the caller hashed (kernels/bloom_embed.py
//     bloom_embed_cuda, the tests' and the dense backward checks' entry);
//   * the token entry, (T,) token ids (int32 or int64, read as they are),
//     hashed in the kernel as core/bloom.BloomSpec.indices_for does: the
//     on-the-fly double hash (csrc/bloom_hash.cuh, a negative id by its
//     uint32 bit pattern), a row of the precomputed (d, k) hash matrix
//     (the id clamped into [0, d)), or the identity spec's id itself
//     (a negative id counted from the end, as torch indexes). When autograd
//     needs them, the same launch writes the (T, k) int32 indices that
//     indices_for returns, which the backward (CSR or dense) reads.
//
// Row range (one rank's shard of a vocab-parallel embedding): the table may
// hold only the rows [lo, lo + rows) of the full (m, D) table. The indices
// are hashed (or read) as ever, in [0, m); an index outside the range adds
// 0.0 and one inside reads table row index - lo. Each rank's output is then
// its part of the sum, and the caller all-reduces the parts. lo = 0, rows =
// m is the unranged gather-sum, bit for bit (every index lies inside). The
// dense backward takes the same range: it sums into the shard's rows only.
//
// Replaces the Pallas TPU kernels src/repro/kernels/bloom_embed.py ::
// bloom_embed_pallas (_embed_fwd -> _fwd_kernel, the table_dtype=None path)
// and its quantized variants (_fwd_kernel_scaled via _embed_fwd_quant and
// bloom_embed_fwd_quantized). The TPU kernel keeps the table in HBM, starts
// t_tile * k async row DMAs per grid step into VMEM, and (int8) prefetches
// the (T, k) scales gathered on the host; the reference hashes the tokens
// outside the kernel in XLA. Here each block gathers its rows straight from
// device memory with 16-byte loads and reads each row's scale itself: every
// table element is used once per token, so there is nothing to stage.
//
// Bound on the H100: bytes. The least traffic is each distinct gathered row
// once (<= T*k*D*itemsize, plus 4 bytes of scale per int8 row), the token
// ids (or the (T, k) indices) and the (T, D) output; the T*(k-1)*D adds are
// negligible. At T = 8, D = 1024, k = 4 that is ~40-80 KB, ~25 ns at 3.35
// TB/s: far below what one launch costs, so at decode shapes the kernel is
// bound by launch latency and by its chain of dependent memory round trips.
// The design keeps that chain at two (the token, then all k rows at once):
//   * one launch from token ids to activations: the hash runs in the kernel
//     (once per warp: every thread of a block serves the same token), so no
//     index tensor is built by ~40 PyTorch launches, and no host sync;
//   * k is a template parameter (1 to 8): the k indices (or the token) come
//     in with one load, and all k row chunks (and int8 scales) are issued
//     before any is used;
//   * grid (T tokens, column chunks): blocks of 128 threads, or of one warp
//     when 128-thread blocks would not fill one wave of the card (T = 8), so
//     more SMs issue the row loads;
//   * on the vector path (D a multiple of 16 bytes' worth of stored
//     elements, table and out 16-byte aligned) each thread owns one 16-byte
//     chunk of every row: kVec = 16 / itemsize columns (4 f32, 8 bf16, 16
//     int8 or fp8), loads it from each of the k rows (neighbouring threads
//     on neighbouring addresses), widens to f32, adds in j order, and stores
//     kVec outputs with the widest aligned stores (8 to 64 bytes). Otherwise
//     (a ragged D, an unaligned table, or k > 8) one element per thread.
// The build with -DBLOOM_EMBED_PDL (kernels/sweep_embed.py times it
// against this one) launches the vector path with programmatic dependent
// launch: the kernel may start while the one before it on the stream
// drains, and waits for it (griddepcontrol.wait) before its first load.
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
#include "bloom_hash.cuh"

namespace {

constexpr int kMaxThreads = 128;
constexpr int kMaxVecK = 8;   // the vector path's template k: 1 to 8

// storage and output dtype codes of the C interface
enum Dtype { kF32 = 0, kBF16 = 1, kI8 = 2, kFP8 = 3 };
// where the indices come from: a (T, k) int32 matrix, or the tokens through
// the double hash, the (d, k) hash matrix or the identity spec
enum Src { kIdx = 0, kHash = 1, kHMat = 2, kIdent = 3 };

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

struct Fwd {
  const void* table;     // (rows, D) stored as S: rows [lo, lo + rows)
  const float* scales;   // (m,) f32 for int8, else null
  const void* ids;       // kIdx: (T, k) int32; else (T,) tokens
  const int* H;          // kHMat: (d, k) int32, else null
  int* idx_out;          // null, or (T, k) int32: indices_for's indices
  void* out;             // (T, D) as O
  int T, D, k, m, d, src, tok64, lo, rows;
  bloom_hash::Spec hs;
};

__device__ __forceinline__ long long load_token(const Fwd& p, int t) {
  return p.tok64 ? __ldg(static_cast<const long long*>(p.ids) + t)
                 : (long long)__ldg(static_cast<const int*>(p.ids) + t);
}

// The row the identity spec gathers for token tok: torch's indexing of the
// plain version (-1 is row m - 1), clamped into the table.
__device__ __forceinline__ int ident_row(long long tok, int m) {
  const long long r = tok < 0 ? tok + m : tok;
  return (int)(r < 0 ? 0 : (r >= m ? m - 1 : r));
}

__device__ __forceinline__ int clamp_row(long long tok, int d) {
  return (int)(tok < 0 ? 0 : (tok >= d ? d - 1 : tok));
}

// K consecutive int32 from q, with the widest loads q's alignment allows
template <int K>
__device__ __forceinline__ void load_ints(int (&r)[K], const int* q) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(q);
  if constexpr (K % 4 == 0) {
    if (a % 16 == 0) {
#pragma unroll
      for (int j = 0; j < K; j += 4) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(q + j));
        r[j] = v.x; r[j + 1] = v.y; r[j + 2] = v.z; r[j + 3] = v.w;
      }
      return;
    }
  }
  if constexpr (K % 2 == 0) {
    if (a % 8 == 0) {
#pragma unroll
      for (int j = 0; j < K; j += 2) {
        const int2 v = __ldg(reinterpret_cast<const int2*>(q + j));
        r[j] = v.x; r[j + 1] = v.y;
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) r[j] = __ldg(q + j);
}

// Token t's K rows into r (the same value in every thread of a block: the
// loads broadcast, the hash runs once per warp); its token into *tok.
template <int K>
__device__ __forceinline__ void rows_of(const Fwd& p, int t, int (&r)[K],
                                        long long* tok) {
  if (p.src == kIdx) {
    load_ints<K>(r, static_cast<const int*>(p.ids) + (size_t)t * K);
    return;
  }
  *tok = load_token(p, t);
  if (p.src == kHash) {
    unsigned h1, h2;
    bloom_hash::h1h2(p.hs, (unsigned)*tok, &h1, &h2);
#pragma unroll
    for (int j = 0; j < K; ++j)
      r[j] = (int)bloom_hash::hash_j(p.hs, h1, h2, (unsigned)j);
  } else if (p.src == kHMat) {
    load_ints<K>(r, p.H + (size_t)clamp_row(*tok, p.d) * K);
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) r[j] = ident_row(*tok, p.m);   // K == 1
  }
}

// Index j of token t for the one-element path (any k); h1, h2 and tok as
// the caller computed them for the token's source.
__device__ __forceinline__ int row_j(const Fwd& p, int t, int j,
                                     long long tok, unsigned h1,
                                     unsigned h2) {
  switch (p.src) {
    case kIdx:
      return __ldg(static_cast<const int*>(p.ids) + (size_t)t * p.k + j);
    case kHash:
      return (int)bloom_hash::hash_j(p.hs, h1, h2, (unsigned)j);
    case kHMat:
      return __ldg(p.H + (size_t)clamp_row(tok, p.d) * p.k + j);
  }
  return ident_row(tok, p.m);
}

// The indices spec.indices_for returns for token t: the rows, except that
// the identity spec returns the token itself (cut to int32).
__device__ __forceinline__ int index_out(const Fwd& p, int row,
                                         long long tok) {
  return p.src == kIdent ? (int)tok : row;
}

// One element per thread: any D, any alignment, any k.
template <typename S, typename O>
__global__ void __launch_bounds__(kMaxThreads) embed_fwd_scalar(const Fwd p) {
  const int t = blockIdx.x;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  const S* table = static_cast<const S*>(p.table);
  long long tok = 0;
  unsigned h1 = 0, h2 = 0;
  if (p.src != kIdx) tok = load_token(p, t);
  if (p.src == kHash) bloom_hash::h1h2(p.hs, (unsigned)tok, &h1, &h2);
  const bool write_idx = p.idx_out != nullptr && c == 0;
  float acc = 0.0f;
  for (int j = 0; j < p.k; ++j) {
    const int r = row_j(p, t, j, tok, h1, h2);
    if (write_idx) p.idx_out[(size_t)t * p.k + j] = index_out(p, r, tok);
    if (c < p.D) {
      const unsigned rl = (unsigned)(r - p.lo);   // the row in the shard
      const float x = rl < (unsigned)p.rows
                          ? load_scaled(table[(size_t)rl * p.D + c],
                                        row_scale<S>(p.scales, (int)rl))
                          : 0.0f;
      acc = j == 0 ? x : __fadd_rn(acc, x);
    }
  }
  if (c < p.D) from_f32(acc, static_cast<O*>(p.out) + (size_t)t * p.D + c);
}

// One 16-byte chunk of stored elements (kVec of them) per thread, K rows;
// needs D % kVec == 0 and 16-byte aligned table and out.
template <typename S, typename O, int K>
__global__ void __launch_bounds__(kMaxThreads) embed_fwd_vec(const Fwd p) {
  constexpr int kVec = 16 / sizeof(S);
  constexpr int kOutBytes = kVec * sizeof(O);
  // the widest store the output chunk's alignment allows: 16 bytes, or 8
  // for f32 stored and bf16 out (4 columns)
  using W = typename std::conditional<kOutBytes % 16 == 0, uint4,
                                      uint2>::type;
  constexpr int kWords = kOutBytes / sizeof(W);
  const int t = blockIdx.x;
  const int chunk = blockIdx.y * blockDim.x + threadIdx.x;
  int r[K];
  long long tok = 0;
#ifdef BLOOM_EMBED_PDL
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
#endif
  rows_of<K>(p, t, r, &tok);
  if (p.idx_out != nullptr && chunk == 0) {
#pragma unroll
    for (int j = 0; j < K; ++j)
      p.idx_out[(size_t)t * K + j] = index_out(p, r[j], tok);
  }
  if (chunk >= p.D / kVec) return;
  const S* table = static_cast<const S*>(p.table);
  uint4 raw[K];
  float s[K];
  bool in[K];   // the row lies in the shard; if not it adds 0.0
#pragma unroll
  for (int j = 0; j < K; ++j) {
    r[j] -= p.lo;
    in[j] = (unsigned)r[j] < (unsigned)p.rows;
  }
#pragma unroll
  for (int j = 0; j < K; ++j)
    raw[j] = in[j] ? __ldg(reinterpret_cast<const uint4*>(
                               table + (size_t)r[j] * p.D) + chunk)
                   : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int j = 0; j < K; ++j)
    s[j] = in[j] ? row_scale<S>(p.scales, r[j]) : 0.0f;
  float acc[kVec];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const S* v = reinterpret_cast<const S*>(&raw[j]);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float x = load_scaled(v[e], s[j]);
      acc[e] = j == 0 ? x : __fadd_rn(acc[e], x);
    }
  }
  W packed[kWords];
  O* o = reinterpret_cast<O*>(packed);
#pragma unroll
  for (int e = 0; e < kVec; ++e) from_f32(acc[e], o + e);
  W* dst = reinterpret_cast<W*>(static_cast<O*>(p.out) + (size_t)t * p.D +
                                (size_t)chunk * kVec);
#pragma unroll
  for (int w = 0; w < kWords; ++w) dst[w] = packed[w];
}

__global__ void empty_kernel() {}

int round_up_warp(int n) { return (n + 31) / 32 * 32; }

template <typename S, typename O, int K>
void launch_vec(const Fwd& p, dim3 grid, int threads, cudaStream_t s) {
#ifdef BLOOM_EMBED_PDL
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // its error reaches the caller's cudaGetLastError
  cudaLaunchKernelEx(&cfg, embed_fwd_vec<S, O, K>, p);
#else
  embed_fwd_vec<S, O, K><<<grid, threads, 0, s>>>(p);
#endif
}

template <typename S, typename O>
int launch(const Fwd& p, int n_sm, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(S);
  const bool vec = p.k <= kMaxVecK && p.D % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(p.table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p.out) % 16 == 0;
  const int n = vec ? p.D / kVec : p.D;
  int threads = n < kMaxThreads ? round_up_warp(n) : kMaxThreads;
  // one warp a block when blocks of `threads` would not fill one wave
  if ((long long)p.T * ((n + threads - 1) / threads) < n_sm) threads = 32;
  const dim3 grid(p.T, (n + threads - 1) / threads);
  if (!vec) {
    embed_fwd_scalar<S, O><<<grid, threads, 0, s>>>(p);
  } else {
    switch (p.k) {
      case 1: launch_vec<S, O, 1>(p, grid, threads, s); break;
      case 2: launch_vec<S, O, 2>(p, grid, threads, s); break;
      case 3: launch_vec<S, O, 3>(p, grid, threads, s); break;
      case 4: launch_vec<S, O, 4>(p, grid, threads, s); break;
      case 5: launch_vec<S, O, 5>(p, grid, threads, s); break;
      case 6: launch_vec<S, O, 6>(p, grid, threads, s); break;
      case 7: launch_vec<S, O, 7>(p, grid, threads, s); break;
      case 8: launch_vec<S, O, 8>(p, grid, threads, s); break;
    }
  }
  return (int)cudaGetLastError();
}

template <typename S>
int launch_out(const Fwd& p, int out_dtype, int n_sm, cudaStream_t s) {
  if (out_dtype == kF32) return launch<S, float>(p, n_sm, s);
  if (out_dtype == kBF16) return launch<S, __nv_bfloat16>(p, n_sm, s);
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
                    float* __restrict__ out, int T, int D, int m, int k,
                    int lo) {
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
        idx, e0, n, lo + base, kBwdRows, list, warp_tot);
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
               int k, int lo, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      embed_bwd_dense<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kBwdSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m + kBwdRows - 1) / kBwdRows,
                  (D + kBwdCols - 1) / kBwdCols);
  embed_bwd_dense<G><<<grid, kBwdThreads, kBwdSmem, s>>>(g, idx, out, T, D,
                                                          m, k, lo);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The dense backward: g (T, D) as `g_dtype` (kF32 or kBF16), idx (T, k)
// int32 (entries outside [lo, lo + m), such as -1 pads, never match), out
// (m, D) f32 for the rows [lo, lo + m) (lo = 0: the whole table), all
// contiguous on one device. Launches on `stream` without synchronising;
// returns the CUDA error code of the launch (0 on success).
int bloom_embed_bwd_dense(const void* g, int g_dtype, const int* idx,
                          float* out, int T, int D, int m, int k, int lo,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_dtype == kF32)
    return launch_bwd<float>(static_cast<const float*>(g), idx, out, T, D, m,
                             k, lo, s);
  if (g_dtype == kBF16)
    return launch_bwd<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(g),
                                     idx, out, T, D, m, k, lo, s);
  return (int)cudaErrorInvalidValue;
}


// The forward: table (rows, D) stored as `table_dtype` (a Dtype code), the
// rows [lo, lo + rows) of the full (m, D) table (lo = 0, rows = m: all of
// it), scales (rows,) f32 for int8 and null otherwise, out (T, D) as
// `out_dtype` (kF32 or kBF16), all contiguous on one device. `src` says what `ids` is:
// kIdx, (T, k) int32 indices in [0, m); otherwise (T,) token ids, int64 if
// `tok64` else int32, hashed with the salts c1, c2 and the remainder
// constants (mp, sh) of m and max(m - 1, 1) (kHash), looked up in H (d, k)
// int32 (kHMat), or taken as they are (kIdent, k == 1). idx_out is null or
// (T, k) int32 for the indices spec.indices_for gives (not with kIdx).
// `n_sm` is the card's SM count. Launches on `stream` without
// synchronising; returns the CUDA error code of the launch (0 on success).
int bloom_embed_fwd(const void* table, const float* scales, const void* ids,
                    int tok64, int src, const int* H, int* idx_out,
                    void* out, int T, int D, int k, int m, int d, int lo,
                    int rows, unsigned c1, unsigned c2, unsigned mp_m,
                    unsigned sh_m, unsigned mp_m1, unsigned sh_m1,
                    int table_dtype,
                    int out_dtype, int n_sm, void* stream) {
  if (src < kIdx || src > kIdent || k < 1 || (src == kIdent && k != 1) ||
      (src == kHMat) != (H != nullptr) ||
      (src == kIdx && idx_out != nullptr) ||
      (table_dtype == kI8) != (scales != nullptr) || lo < 0 || rows < 0)
    return (int)cudaErrorInvalidValue;
  Fwd p;
  p.table = table;
  p.scales = scales;
  p.ids = ids;
  p.H = H;
  p.idx_out = idx_out;
  p.out = out;
  p.T = T;
  p.D = D;
  p.k = k;
  p.m = m;
  p.d = d;
  p.src = src;
  p.tok64 = tok64;
  p.lo = lo;
  p.rows = rows;
  p.hs = bloom_hash::Spec{c1, c2, (unsigned)m, mp_m, sh_m, mp_m1, sh_m1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (table_dtype) {
    case kF32: return launch_out<float>(p, out_dtype, n_sm, s);
    case kBF16: return launch_out<__nv_bfloat16>(p, out_dtype, n_sm, s);
    case kI8: return launch_out<int8_t>(p, out_dtype, n_sm, s);
    case kFP8: return launch_out<__nv_fp8_e4m3>(p, out_dtype, n_sm, s);
  }
  return (int)cudaErrorInvalidValue;
}

// One empty kernel on `stream`: the launch floor the forward's decode-shape
// times are read against (chip_smoke.py). Returns the CUDA error code.
int bloom_embed_launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

const char* bloom_embed_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
