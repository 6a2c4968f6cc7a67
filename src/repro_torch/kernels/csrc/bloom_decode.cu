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
// (b_tile, m) logp block in VMEM while the vocab streams through its grid.
// (The dense backward, bloom_decode_bwd_pallas, is ported by
// bloom_decode.py on the kernels of csrc/bloom_csr.cu.)
//
// Bound on the H100: bytes: H once (d*k*2, the 16-bit words the kernel
// reads), each logp row once and the (B, d) f32 scores: 7.04 MB at B = 8,
// d = 151,936, k = 4, m = 30,208, f32, ~2.1 us at 3.35 TB/s; the
// B*d*(k-1) adds are ~0.1 us at 67 TFLOP/s. Under the bytes lie what no
// traffic count shows: every block stages a row tile from L2, every row
// tile reads all of H from L2, and the d*k gathers of a tile are random
// shared-memory reads.
//
// Design:
//   * Row tiles of one 32-bit word an entry: a block stages R = 4 / itemsize
//     rows (1 f32, 2 bf16, 4 int8 or fp8) in shared memory interleaved as
//     [m][R] at the stored width, so one 4-byte read gathers an index's
//     value for every row of the tile and each H entry a block reads serves
//     R rows. A thread stages four columns at a time: 16 / R bytes from each
//     row of the tile, transposed in registers by byte permutes and stored
//     as one 16-byte word group (neighbouring threads on neighbouring
//     words: no bank conflicts), 16 groups' loads in flight a thread, so
//     one round trip stages a tile at m = 30,208. (16-byte loads of each
//     row's 16 / itemsize columns made a thread store 32 or 64 contiguous
//     bytes: 2- and 4-way bank conflicts.) Widening is exact at the gather
//     (bf16 a shift, int8 a byte permute and one subtraction, fp8 through
//     half).
//   * The build with -DBLOOM_DECODE_BULK (kernels/sweep_decode.py times it
//     against this one) stages instead with bulk copies (cp.async.bulk,
//     the 1-D TMA, on an mbarrier) of the tile's rows as stored, [R][m],
//     which a bulk copy cannot transpose; its gather then reads an index's
//     R values one by one.
//   * One wave: the grid is (row tile, id range), tile fastest, so the
//     blocks reading one stretch of H run together; the wrapper's plan
//     (kernels/bloom_decode.py plan) sizes the ranges.
//   * H is read as 16-bit indices (every index is below m <= MAX_M <
//     2^16; the wrapper packs the int32 matrix, once per spec on the
//     ops.bloom_decode path), which halves the H bytes each row tile
//     pulls from L2.
//   * Each thread scores 4 consecutive ids a step: their k indices come
//     in as k / 2 16-byte loads (k odd: k 8-byte loads), the next step's
//     are loaded while this step gathers, k is a template parameter (1 to
//     8; any larger k takes a one-id-a-thread loop) so the
//     gathers unroll, and each row's 4 scores leave as one float4
//     streaming store (__stcs): the (B, d) scores are most of the bytes
//     and should not evict H from L2. The first step's indices load while
//     the rows stage.
// What bounds it then: each block stages a whole tile from L2 (121 KB at
// m = 30,208) before its first gather, the random shared-memory gathers
// conflict on banks, and each row tile reads all of H from L2 (f32: one
// tile a row).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kIds = 4;       // consecutive ids a thread scores a step
// four-column groups a thread stages a pass: 4 * kGroups * kThreads =
// 32,768 columns, so one pass stages a tile at the LM's m = 30,208
constexpr int kGroups = 16;

#ifdef BLOOM_DECODE_PROFILE
// kernels/sweep_decode.py's timers build: each block's %globaltimer (ns)
// at its start, after staging and at its end
constexpr int kProfBlocks = 4096;
__device__ long long g_prof[kProfBlocks][3];
__device__ __forceinline__ void prof(int slot) {
  if (threadIdx.x == 0 && blockIdx.x < kProfBlocks) {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_prof[blockIdx.x][slot] = t;
  }
}
#else
__device__ __forceinline__ void prof(int) {}
#endif

// logp storage dtype codes of the C interface
enum Dtype { kF32 = 0, kBF16 = 1, kI8 = 2, kFP8 = 3 };

template <int DT>
struct Store {
  static constexpr int isz = DT == kF32 ? 4 : DT == kBF16 ? 2 : 1;
  static constexpr int rows = 4 / isz;   // R: rows of a tile
};

struct Params {
  const unsigned char* logp;   // (B, m) stored as DT
  const float* scales;         // (B,) f32 for int8, else null
  const unsigned short* H;     // (d, k) H's indices as 16-bit words
  float* out;                  // (B, d) f32
  int B, m, d, k;
  int tiles, chunk;            // row tiles; ids a block scores
  int vec_rows;                // rows 16-byte aligned: vector staging
  int vec_h;                   // H aligned: 4 ids' indices in k / 2 int4
                               // (k even) or k uint2 loads
  int vec_out;                 // d % 4 == 0: float4 stores
};

// Row r's value from the tile's word w for index h, as f32 (int8: the
// raw q, exactly).
template <int DT>
__device__ __forceinline__ float value(uint32_t w, int r) {
  if constexpr (DT == kF32) {
    return __uint_as_float(w);
  } else if constexpr (DT == kBF16) {
    return __uint_as_float(r ? (w & 0xffff0000u) : (w << 16));
  } else if constexpr (DT == kI8) {
    // 0x4B000000 | (q + 128) is the float 2^23 + q + 128
    const uint32_t x = __byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7650 | r);
    return __fsub_rn(__uint_as_float(x), 8388736.0f);
  } else {
    const __nv_fp8_storage_t b =
        (__nv_fp8_storage_t)((w >> (8 * r)) & 0xffu);
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(b, __NV_E4M3)));
  }
}

// Four columns of R rows (in[r * (4 / R) + w]: word w of row r, zero past
// the tile) as the four words of the [m][R] layout, one column each.
template <int DT>
__device__ __forceinline__ void transpose(const uint32_t (&in)[4],
                                          uint32_t (&out)[4]) {
  if constexpr (DT == kF32) {
#pragma unroll
    for (int w = 0; w < 4; ++w) out[w] = in[w];
  } else if constexpr (DT == kBF16) {
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      out[2 * w] = __byte_perm(in[w], in[2 + w], 0x5410);
      out[2 * w + 1] = __byte_perm(in[w], in[2 + w], 0x7632);
    }
  } else {
    const uint32_t t0 = __byte_perm(in[0], in[1], 0x5140);
    const uint32_t t1 = __byte_perm(in[2], in[3], 0x5140);
    const uint32_t t2 = __byte_perm(in[0], in[1], 0x7362);
    const uint32_t t3 = __byte_perm(in[2], in[3], 0x7362);
    out[0] = __byte_perm(t0, t1, 0x5410);
    out[1] = __byte_perm(t0, t1, 0x7632);
    out[2] = __byte_perm(t2, t3, 0x5410);
    out[3] = __byte_perm(t2, t3, 0x7632);
  }
}

// The 16 / R bytes of one row's four columns at q, as 4 / R words.
template <int R>
__device__ __forceinline__ void load_cols(uint32_t* in,
                                          const unsigned char* q) {
  if constexpr (R == 1) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(q));
    in[0] = v.x; in[1] = v.y; in[2] = v.z; in[3] = v.w;
  } else if constexpr (R == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(q));
    in[0] = v.x; in[1] = v.y;
  } else {
    in[0] = __ldg(reinterpret_cast<const uint32_t*>(q));
  }
}

// Rows b0 .. b0 + nr - 1 of logp into tile as [m][R] words (zeros for the
// rows past nr); the caller synchronises the block after it. A thread
// takes four columns at a time: 16 / R bytes from each row (coalesced
// across the warp), one 16-byte store (neighbouring threads on
// neighbouring words: no bank conflicts).
template <int DT>
__device__ void stage(uint32_t* tile, const Params& p, int b0, int nr) {
  constexpr int ISZ = Store<DT>::isz, R = Store<DT>::rows;
  const int m = p.m;
  const size_t row_bytes = (size_t)m * ISZ;
  const unsigned char* base = p.logp + (size_t)b0 * row_bytes;
  const int n_vec = p.vec_rows ? m / 4 : 0;    // whole four-column groups
  // kGroups groups a pass, all their loads (16 to 64) issued before any is
  // stored
  constexpr int NB = kGroups;
  for (int g = threadIdx.x; g < n_vec; g += NB * kThreads) {
    uint32_t in[NB][4];
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      const int gq = g + q * kThreads;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        uint32_t* w = in[q] + r * (4 / R);
#pragma unroll
        for (int x = 0; x < 4 / R; ++x) w[x] = 0;
        if (r < nr && gq < n_vec)
          load_cols<R>(w, base + r * row_bytes + (size_t)gq * 4 * ISZ);
      }
    }
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      const int gq = g + q * kThreads;
      if (gq >= n_vec) continue;
      uint32_t out[4];
      transpose<DT>(in[q], out);
      reinterpret_cast<uint4*>(tile)[gq] =
          make_uint4(out[0], out[1], out[2], out[3]);
    }
  }
  // the columns past the whole groups (all of them when the rows are not
  // 16-byte aligned), one word each
  for (int c = n_vec * 4 + threadIdx.x; c < m; c += kThreads) {
    uint32_t w = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nr) {
        const unsigned char* q = base + r * row_bytes + (size_t)c * ISZ;
        uint32_t x;
        if constexpr (ISZ == 4) x = __ldg(reinterpret_cast<const uint32_t*>(q));
        else if constexpr (ISZ == 2)
          x = __ldg(reinterpret_cast<const unsigned short*>(q));
        else x = __ldg(q);
        w |= x << (8 * ISZ * r);
      }
    }
    tile[c] = w;
  }
}

#ifdef BLOOM_DECODE_BULK
// Rows b0 .. b0 + nr - 1 of logp into tile as stored, [R][m], by bulk
// copies of at most 32 KB on the mbarrier bar, issued by thread 0 (16-byte
// aligned rows; otherwise one element a thread a step); every thread waits.
template <int DT>
__device__ void stage(uint32_t* tile, const Params& p, int b0, int nr,
                      unsigned long long* bar) {
  constexpr int ISZ = Store<DT>::isz;
  const size_t row_bytes = (size_t)p.m * ISZ;
  const unsigned char* src = p.logp + (size_t)b0 * row_bytes;
  unsigned char* dst = reinterpret_cast<unsigned char*>(tile);
  if (!p.vec_rows) {
    for (size_t e = threadIdx.x; e < nr * row_bytes; e += kThreads)
      dst[e] = __ldg(src + e);
    return;
  }
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  const unsigned bytes = (unsigned)(nr * row_bytes);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(b)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(b), "r"(bytes) : "memory");
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    for (unsigned off = 0; off < bytes; off += 32768u) {
      const unsigned n = bytes - off < 32768u ? bytes - off : 32768u;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n"
          :: "r"(d + off), "l"(src + off), "r"(n), "r"(b) : "memory");
    }
  }
  __syncthreads();   // the mbarrier is initialised before anyone waits
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], 0;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(b) : "memory");
}

// The tile's word for index h in the [m][R] layout value() reads,
// gathered from the [R][m] rows one value at a time.
template <int DT>
__device__ __forceinline__ uint32_t word(const uint32_t* tile, int h,
                                         int m) {
  constexpr int ISZ = Store<DT>::isz, R = Store<DT>::rows;
  if constexpr (R == 1) {
    return tile[h];
  } else {
    uint32_t w = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      uint32_t x;
      if constexpr (ISZ == 2)
        x = reinterpret_cast<const unsigned short*>(tile)[r * m + h];
      else
        x = reinterpret_cast<const unsigned char*>(tile)[r * m + h];
      w |= x << (8 * ISZ * r);
    }
    return w;
  }
}
#else
template <int DT>
__device__ __forceinline__ uint32_t word(const uint32_t* tile, int h, int) {
  return tile[h];
}
#endif

// The k indices of ids i0 .. i0 + 3 into h[u * K + j] (zeros past d).
template <int K>
__device__ __forceinline__ void load_h(int (&h)[kIds * K], const Params& p,
                                       int i0) {
  if (p.vec_h && i0 + kIds <= p.d) {
    // 4 ids' K indices are 8K bytes at an 8K-byte multiple of H
    const unsigned char* q =
        reinterpret_cast<const unsigned char*>(p.H + (size_t)i0 * K);
    uint32_t w[2 * K];
    if constexpr (K % 2 == 0) {
#pragma unroll
      for (int x = 0; x < K / 2; ++x) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(q) + x);
        w[4 * x] = v.x; w[4 * x + 1] = v.y; w[4 * x + 2] = v.z;
        w[4 * x + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int x = 0; x < K; ++x) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(q) + x);
        w[2 * x] = v.x; w[2 * x + 1] = v.y;
      }
    }
#pragma unroll
    for (int e = 0; e < kIds * K; ++e)
      h[e] = (int)((w[e >> 1] >> (16 * (e & 1))) & 0xffffu);
    return;
  }
#pragma unroll
  for (int u = 0; u < kIds; ++u)
#pragma unroll
    for (int j = 0; j < K; ++j)
      h[u * K + j] = i0 + u < p.d ? __ldg(p.H + (size_t)(i0 + u) * K + j) : 0;
}

// Row r's scores of ids i0 .. i0 + kIds - 1 (those below i_end) to out.
__device__ __forceinline__ void store4(const Params& p, int b, int i0,
                                       int i_end, const float (&s)[kIds]) {
  float* o = p.out + (size_t)b * p.d + i0;
  if (p.vec_out && i0 + kIds <= i_end) {
#pragma unroll
    for (int u = 0; u < kIds; u += 4)
      __stcs(reinterpret_cast<float4*>(o + u),
             make_float4(s[u], s[u + 1], s[u + 2], s[u + 3]));
  } else {
#pragma unroll
    for (int u = 0; u < kIds; ++u)
      if (i0 + u < i_end) __stcs(o + u, s[u]);
  }
}

// Block (tile, g) = (blockIdx.x % tiles, blockIdx.x / tiles) scores ids
// [g * chunk, (g + 1) * chunk) of the tile's rows, K = k (1 to 8).
template <int DT, int K>
__global__ void __launch_bounds__(kThreads, 1) decode_fwd(const Params p) {
  constexpr int R = Store<DT>::rows;
  extern __shared__ __align__(16) uint32_t tile[];   // [m][R]
  const int t = blockIdx.x % p.tiles, g = blockIdx.x / p.tiles;
  const int b0 = t * R;
  const int nr = min(R, p.B - b0);
  const int i_begin = g * p.chunk;
  const int i_end = min(p.d, i_begin + p.chunk);
  float scale[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    scale[r] = DT == kI8 && r < nr ? __ldg(p.scales + b0 + r) : 1.0f;
  int i0 = i_begin + kIds * threadIdx.x;
  int h[kIds * K];
  prof(0);
  load_h<K>(h, p, i0);   // the first step's indices, while the rows stage
#ifdef BLOOM_DECODE_BULK
  __shared__ __align__(8) unsigned long long bar;
  stage<DT>(tile, p, b0, nr, &bar);
#else
  stage<DT>(tile, p, b0, nr);
#endif
  __syncthreads();
  prof(1);
  for (; i0 < i_end; i0 += kIds * kThreads) {
    int hn[kIds * K];
    if (i0 + kIds * kThreads < i_end) load_h<K>(hn, p, i0 + kIds * kThreads);
    float acc[R][kIds];
#pragma unroll
    for (int u = 0; u < kIds; ++u) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const uint32_t w = word<DT>(tile, h[u * K + j], p.m);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float v = value<DT>(w, r);
          acc[r][u] = j == 0 ? v : __fadd_rn(acc[r][u], v);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nr) {
        if constexpr (DT == kI8) {
#pragma unroll
          for (int u = 0; u < kIds; ++u)
            acc[r][u] = __fmul_rn(acc[r][u], scale[r]);
        }
        store4(p, b0 + r, i0, i_end, acc[r]);
      }
    }
#pragma unroll
    for (int q = 0; q < kIds * K; ++q) h[q] = hn[q];
  }
#ifdef BLOOM_DECODE_PROFILE
  __syncthreads();
  prof(2);
#endif
}

// Any k: one id a thread a step, its indices loaded one by one.
template <int DT>
__global__ void __launch_bounds__(kThreads, 1) decode_fwd_any(const Params p) {
  constexpr int R = Store<DT>::rows;
  extern __shared__ __align__(16) uint32_t tile[];
  const int t = blockIdx.x % p.tiles, g = blockIdx.x / p.tiles;
  const int b0 = t * R;
  const int nr = min(R, p.B - b0);
  const int i_end = min(p.d, g * p.chunk + p.chunk);
#ifdef BLOOM_DECODE_BULK
  __shared__ __align__(8) unsigned long long bar;
  stage<DT>(tile, p, b0, nr, &bar);
#else
  stage<DT>(tile, p, b0, nr);
#endif
  __syncthreads();
  for (int i = g * p.chunk + threadIdx.x; i < i_end; i += kThreads) {
    const unsigned short* hi = p.H + (size_t)i * p.k;
    float acc[R];
    for (int j = 0; j < p.k; ++j) {
      const uint32_t w = word<DT>(tile, __ldg(hi + j), p.m);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float v = value<DT>(w, r);
        acc[r] = j == 0 ? v : __fadd_rn(acc[r], v);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < nr)
        __stcs(p.out + (size_t)(b0 + r) * p.d + i,
               DT == kI8 ? __fmul_rn(acc[r], __ldg(p.scales + b0 + r))
                         : acc[r]);
  }
}

// Sets the kernel's dynamic shared memory limit once per device.
int prepare(void (*fn)(const Params), unsigned* ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 32 && (*ready >> dev & 1u)) return 0;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - (int)attr.sharedSizeBytes);
  if (err != cudaSuccess) return (int)err;
  if (dev < 32) *ready |= 1u << dev;
  return 0;
}

template <int DT, int K>
int launch_k(const Params& p, int grid, cudaStream_t s) {
  static unsigned ready = 0;   // devices whose attribute is set
  void (*fn)(const Params);
  if constexpr (K == 0)
    fn = decode_fwd_any<DT>;
  else
    fn = decode_fwd<DT, K>;
  const int err = prepare(fn, &ready);
  if (err != 0) return err;
  fn<<<grid, kThreads, (size_t)p.m * 4, s>>>(p);
  return (int)cudaGetLastError();
}

template <int DT>
int launch(const Params& p, int grid, cudaStream_t s) {
  switch (p.k) {
    case 1: return launch_k<DT, 1>(p, grid, s);
    case 2: return launch_k<DT, 2>(p, grid, s);
    case 3: return launch_k<DT, 3>(p, grid, s);
    case 4: return launch_k<DT, 4>(p, grid, s);
    case 5: return launch_k<DT, 5>(p, grid, s);
    case 6: return launch_k<DT, 6>(p, grid, s);
    case 7: return launch_k<DT, 7>(p, grid, s);
    case 8: return launch_k<DT, 8>(p, grid, s);
  }
  return launch_k<DT, 0>(p, grid, s);
}

}  // namespace

extern "C" {

// logp (B, m) stored as `dtype` (a Dtype code), scales (B,) f32 for int8
// and null otherwise, H (d, k) of 16-bit indices in [0, m) (m <= 2^16),
// out (B, d) f32, all contiguous on one device. The plan
// (kernels/bloom_decode.py plan):
// `tiles` row tiles of 4 / itemsize rows, blocks of `chunk` ids (a
// multiple of 4), `grid` = tiles * ceil(d / chunk) blocks; shared memory
// m * 4 bytes a block. Launches on `stream` without synchronising; returns
// the CUDA error code (0 on success).
int bloom_decode_fwd(const void* logp, int dtype, const float* scales,
                     const unsigned short* H, float* out, int B, int m,
                     int d, int k, int tiles, int chunk, int grid,
                     void* stream) {
  if (dtype < kF32 || dtype > kFP8 || (dtype == kI8) != (scales != nullptr) ||
      m < 1 || m > 65536 || k < 1 || chunk < 1 || chunk % kIds != 0 ||
      tiles < 1 || grid < 1)
    return (int)cudaErrorInvalidValue;
  const int isz = dtype == kF32 ? 4 : dtype == kBF16 ? 2 : 1;
  Params p;
  p.logp = static_cast<const unsigned char*>(logp);
  p.scales = scales;
  p.H = H;
  p.out = out;
  p.B = B;
  p.m = m;
  p.d = d;
  p.k = k;
  p.tiles = tiles;
  p.chunk = chunk;
  p.vec_rows = (uintptr_t)logp % 16 == 0 && (size_t)m * isz % 16 == 0;
  p.vec_h = (uintptr_t)H % (k % 2 ? 8 : 16) == 0;
  p.vec_out = (uintptr_t)out % 16 == 0 && d % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<kF32>(p, grid, s);
    case kBF16: return launch<kBF16>(p, grid, s);
    case kI8: return launch<kI8>(p, grid, s);
    case kFP8: return launch<kFP8>(p, grid, s);
  }
  return (int)cudaErrorInvalidValue;
}

#ifdef BLOOM_DECODE_PROFILE
// The timers of the last launch's first n_blocks blocks, 3 a block.
int bloom_decode_profile(long long* out, int n_blocks) {
  return (int)cudaMemcpyFromSymbol(out, g_prof,
                                   sizeof(long long) * 3 * n_blocks);
}
#endif

const char* bloom_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
