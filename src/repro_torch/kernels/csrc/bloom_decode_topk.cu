// Fused Bloom Eq. 3 decode + top-k for Hopper (sm_90a): logp rows stored in
// f32, bf16, int8 with one f32 scale per row, or fp8 e4m3, and the hash
// indices read from an explicit (d, k) matrix or re-derived in the kernel.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bloom_decode_topk.py ::
// bloom_decode_topk_pallas: its dense grid (_kernel) and its row-skipping
// grid (_kernel_skip) are one kernel here, with an optional `active` mask,
// and so are its quantized variants (has_scales: _fold_tile's per-row scale
// multiply; hash_spec: _tile_scores' in-kernel double hashing).
//
// What it computes, for each row b with active[b] != 0 (or every row when
// active is null): the topk ids over i in [0, d) of
//     score[b, i] = row_b[h_0(i)] + row_b[h_1(i)] + ...
// summed in f32 in j order, ranked by the total order (score descending,
// id ascending), so equal scores resolve to the lowest id. row_b is logp
// row b widened to f32 (times scales[b] for int8, rounded on its own: the
// reference's `logp * s` before the gather). h_j(i) is H[i, j], or, with H
// null, the enhanced double hash of core/hashing.double_hash:
//     h1 = splitmix32(i ^ c1) % m,  h2 = splitmix32(i ^ c2) % max(m-1, 1) + 1
//     h_j = (h1 + j*h2 + ((j^3 - j)/6 % m)) % m
// in uint32 arithmetic, so it equals the cached hash matrix of an
// on-the-fly spec bit for bit. A row with active[b] == 0 does no work and
// returns (-inf, 0). A NaN score never enters the answer.
//
// Bound on the H100: with H, bytes. The least traffic is H once (d*k*4
// bytes), each live logp row once (m*itemsize) and the outputs
// (B*topk*8): at d = 1e7, k = 2, m = 8192, B = 8, f32 that is ~80.3 MB,
// ~24 us at 3.35 TB/s. Without H the bytes are a few KB and the bound is the
// hash's integer operations, once per id (kernels/bloom_decode_topk.py
// hash_ops). Under both lie the d * k random shared-memory reads of each
// row tile, which no traffic count shows.
//
// Design. Blocks run in no order, so the TPU kernel's running top-k in VMEM
// becomes candidate lists merged at the end:
//   * Row tiles. A block stages up to RP live rows in shared memory at their
//     stored width, interleaved [m][RP], so one 1- to 32-byte read fetches an
//     index's entry for every row of the tile, and every H index, or every
//     hash, is computed once per tile. The wrapper's plan picks RP (a power
//     of two <= 8) to fit 227 KB and to be repaid by the block's share of
//     the catalog. The kernel counts the live rows itself and spreads its
//     fixed grid (one block per SM) over the live row tiles only, balanced,
//     so a part-full pool uses the whole card with no host sync, and a CUDA
//     graph of a call stays valid whatever the mask.
//   * Staging: a one-row tile is one bulk copy (cp.async.bulk, the 1-D TMA,
//     completing on an mbarrier); a tile of more rows is 16-byte loads from
//     each row, several in flight, transposed in registers into [m][RP] and
//     stored 16 bytes at a time (a bulk copy cannot transpose). Narrow rows
//     are widened exactly, at the gather (the int8 path: a byte permute
//     gives 2^23 + q + 128, one subtraction q, then the reference's scale
//     multiply) or, where the plan finds the catalog share long enough to
//     repay 4 bytes a value, once while staging (then DT is kF32).
//   * Scan. A warp scores kU ids per lane per step for every row of its
//     tile. After the first step the block's threshold per row is the
//     topk-th largest of its 32 * nw lanes' best scores (each the score of
//     another id, so topk real ids reach it; topk <= 32): each warp sorts
//     its lanes' bests, one warp merges the sorted runs. The threshold is a
//     64-bit key (ordered score, then the id's complement) in shared memory.
//     A score is kept only when it beats it in the total order, which a
//     warp-wide OR of the lanes' hits tests per step; kept scores go to the
//     warp's per-row list in shared memory at slots a ballot assigns; a full
//     list is cut to its topk best by rank, and its topk-th entry raises the
//     threshold (integer atomicMax). After steps 3, 7 and 15 the block
//     refreshes the threshold to the topk-th best entry of all its lists and
//     the warps drop what it beats. Only ids that topk real ids beat are
//     dropped, so the result is exact.
//   * Merge. The block ranks its warps' lists per row (eight threads count
//     each entry's betters) into a sorted partial top-k in global scratch;
//     the last block of a tile (an integer ticket, reset by that block)
//     takes the topk-th best of the tile's G partial heads as a threshold
//     and ranks the entries that reach it. One launch, no float atomics;
//     because the ranking is a total order, no result depends on which
//     block ran first.
// The in-kernel hash walks h_j incrementally, adding h2 and j(j-1)/2 mod m
// with one conditional subtraction each, which equals the formula above
// because no uint32 sum in it wraps (k <= kMaxHashK, m <= the kernel's
// shared-memory row). Its two remainders by m and max(m-1, 1) are exact
// multiply-shift divisions with constants the wrapper computes once
// (Granlund & Montgomery's round-up method, valid for every uint32).
// Measured times are in PERF.md (chip_smoke.py, sweep_decode_topk.py).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "bloom_hash.cuh"

namespace {

constexpr int kMaxWarps = 16;
constexpr int kMaxRows = 8;
constexpr int kMaxTopk = 64;
// most hash functions the in-kernel hash takes (the wrapper raises above)
constexpr int kMaxHashK = 32;
// ids a lane scores per step of the scan (-D to tune it, see
// kernels/sweep_decode_topk.py)
#ifndef BLOOM_DECODE_TOPK_IDS
#define BLOOM_DECODE_TOPK_IDS 4
#endif
constexpr int kU = BLOOM_DECODE_TOPK_IDS;
// the block refreshes its thresholds after steps 3, 7 and 15 (each
// refresh waits for the block's slowest warp)
constexpr int kLastRefresh = 16;
constexpr unsigned kSentinelId = 0x7fffffffu;  // loses every tie to a real id
// an entry (score bits low, id high) that every real entry beats
constexpr unsigned long long kSentinel =
    ((unsigned long long)kSentinelId << 32) | 0xff800000ull;
// entries a warp list holds at most (the plan's cw)
constexpr int kMaxList = 96;

// logp storage dtype codes of the C interface
enum Dtype { kF32 = 0, kBF16 = 1, kI8 = 2, kFP8 = 3 };
// where h_j(i) comes from: the hash, H with k <= 4 (one load per id), H
// with k > 4 (one row a tile)
enum Kind { kHash = 0, kHVec = 1, kHGen = 2 };

template <int DT>
struct Width {
  static constexpr int v = DT == kF32 ? 4 : DT == kBF16 ? 2 : 1;
};

#ifdef BLOOM_DECODE_TOPK_PROFILE
constexpr int kProfBlocks = 4096;
constexpr int kProfSlots = 6;
__device__ long long g_prof[kProfBlocks][kProfSlots];
#define PROF(slot)                                                        \
  do {                                                                    \
    __syncthreads();                                                      \
    if (threadIdx.x == 0 && blockIdx.x < kProfBlocks)                     \
      g_prof[blockIdx.x][slot] = clock64();                               \
  } while (0)
// warp 0's cycles scoring, offering and refreshing, its slow paths, (u, r)
// hits and steps; and each block's list compactions
constexpr int kProfCounts = 6;
__device__ long long g_prof_scan[kProfBlocks][kProfCounts];
__device__ int g_compactions[kProfBlocks];
#define SCAN_T0() long long t0_ = clock64()
#define SCAN_ADD(k)                   \
  do {                                \
    const long long t1_ = clock64();  \
    acc_[k] += t1_ - t0_;             \
    t0_ = t1_;                        \
  } while (0)
#else
#define PROF(slot)
#define SCAN_T0()
#define SCAN_ADD(k)
#endif

struct Params {
  const unsigned char* logp;
  const float* scales;
  const int* H;
  const int* active;
  int* tickets;
  unsigned long long* part;
  float* vals;
  int* ids;
  int B, m, d, k, topk;
  int rows_bytes, cw;
  unsigned c1, c2;
  unsigned mp_m, sh_m, mp_m1, sh_m1;  // sh: sh1 | sh2 << 8
  int vec_rows;  // logp rows 16-byte aligned: vector staging
  int vec_h4;    // k == 4 and H 16-byte aligned: one int4 per id
  int src_dt;    // logp's stored dtype; a narrow one under DT = kF32 is
                 // widened while staging
};

using bloom_hash::fastmod;
using bloom_hash::splitmix32;

__device__ __forceinline__ bool better(float v, unsigned i, float ov,
                                       unsigned oi) {
  return v > ov || (v == ov && i < oi);
}

__device__ __forceinline__ unsigned long long pack(float v, unsigned i) {
  return ((unsigned long long)i << 32) | __float_as_uint(v);
}
__device__ __forceinline__ float ent_v(unsigned long long e) {
  return __uint_as_float((unsigned)e);
}
__device__ __forceinline__ unsigned ent_i(unsigned long long e) {
  return (unsigned)(e >> 32);
}
__device__ __forceinline__ bool ent_better(unsigned long long a,
                                           unsigned long long b) {
  return better(ent_v(a), ent_i(a), ent_v(b), ent_i(b));
}

// Threshold keys, larger is better in the total order: the score's bits in
// an order-preserving form (-0 as +0, which compare equal), then the id's
// complement; "(v, no id)" has low bits 0 and loses to every id scoring v.
__device__ __forceinline__ unsigned long long tkey(float v, unsigned i) {
  unsigned u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0;
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (0xffffffffu - i);
}
__device__ __forceinline__ float tkey_v(unsigned long long key) {
  const unsigned u = (unsigned)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}
__device__ __forceinline__ unsigned tkey_i(unsigned long long key) {
  return 0xffffffffu - (unsigned)key;
}
// no threshold: (-inf, no id), which every score but NaN beats
constexpr unsigned long long kNoTheta = 0x007fffffull << 32;

// ---------------------------------------------------------------------------
// staging: rows[r] of logp into srows as [m][RP] at the stored width
// ---------------------------------------------------------------------------

template <int NB>
__device__ __forceinline__ void load_bytes(uint32_t* w,
                                           const unsigned char* q) {
  if constexpr (NB == 16) {
    const uint4 t = *reinterpret_cast<const uint4*>(q);
    w[0] = t.x; w[1] = t.y; w[2] = t.z; w[3] = t.w;
  } else if constexpr (NB == 8) {
    const uint2 t = *reinterpret_cast<const uint2*>(q);
    w[0] = t.x; w[1] = t.y;
  } else if constexpr (NB == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(q);
  } else if constexpr (NB == 2) {
    w[0] = *reinterpret_cast<const uint16_t*>(q);
  } else {
    w[0] = *q;
  }
}

// the ISZ bytes at byte offset off of w, and their placing into w
template <int ISZ>
__device__ __forceinline__ uint32_t get_elem(const uint32_t* w, int off) {
  if constexpr (ISZ == 4) return w[off >> 2];
  const uint32_t x = w[off >> 2] >> (8 * (off & 3));
  return ISZ == 2 ? (x & 0xffffu) : (x & 0xffu);
}
template <int ISZ>
__device__ __forceinline__ void put_elem(uint32_t* w, int off, uint32_t x) {
  if constexpr (ISZ == 4) {
    w[off >> 2] = x;
  } else {
    w[off >> 2] |= x << (8 * (off & 3));
  }
}

// One logp row into shared memory by bulk copies (the TMA, 1-D), which
// complete on the mbarrier bar; thread 0 issues them, every thread waits
// for `phase`. dst, src and bytes are multiples of 16.
__device__ __forceinline__ void bulk_row(unsigned char* dst,
                                         const unsigned char* src,
                                         unsigned bytes, unsigned bar,
                                         unsigned phase) {
  if (threadIdx.x == 0) {
    // the last block's merge wrote this area through the generic proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    for (unsigned off = 0; off < bytes; off += 32768u) {
      const unsigned n = bytes - off < 32768u ? bytes - off : 32768u;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n"
          :: "r"(d + off), "l"(src + off), "r"(n), "r"(bar) : "memory");
    }
  }
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(bar), "r"(phase) : "memory");
}

template <int ISZ, int RP>
__device__ void stage_tile(unsigned char* srows, const Params& p,
                           const int* rows, int nr) {
  constexpr int V = 16 / ISZ;                 // columns of a 16-byte load
  constexpr int EB = ISZ * RP;                // bytes of one index's entry
  constexpr int OW = V * EB / 4;              // words stored per group
  constexpr int NB = 8 / RP;                  // groups a thread loads at once
  const int m = p.m;
  const int groups = (m + V - 1) / V;
  const size_t row_bytes = (size_t)m * ISZ;
  for (int g0 = threadIdx.x; g0 < groups; g0 += blockDim.x * NB) {
    uint32_t in[NB][RP][4];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int c0 = (g0 + b * (int)blockDim.x) * V;
      const bool full = p.vec_rows && c0 + V <= m;
#pragma unroll
      for (int r = 0; r < RP; ++r) {
#pragma unroll
        for (int w = 0; w < 4; ++w) in[b][r][w] = 0;
        if (r < nr && c0 < m) {
          const unsigned char* src =
              p.logp + (size_t)rows[r] * row_bytes + (size_t)c0 * ISZ;
          if (full) {
            load_bytes<16>(in[b][r], src);
          } else {
#pragma unroll
            for (int v = 0; v < V; ++v) {
              if (c0 + v < m) {
                uint32_t x[1];
                load_bytes<ISZ>(x, src + v * ISZ);
                put_elem<ISZ>(in[b][r], v * ISZ, x[0]);
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int c0 = (g0 + b * (int)blockDim.x) * V;
      if (c0 >= m) continue;
      uint32_t out[OW];
#pragma unroll
      for (int w = 0; w < OW; ++w) out[w] = 0;
#pragma unroll
      for (int v = 0; v < V; ++v)
#pragma unroll
        for (int r = 0; r < RP; ++r)
          put_elem<ISZ>(out, v * EB + r * ISZ,
                        get_elem<ISZ>(in[b][r], v * ISZ));
      unsigned char* dst = srows + (size_t)c0 * EB;
      if (c0 + V <= m) {
#pragma unroll
        for (int w = 0; w < OW; w += 4)
          *reinterpret_cast<uint4*>(dst + 4 * w) =
              make_uint4(out[w], out[w + 1], out[w + 2], out[w + 3]);
      } else {
        // the ragged last group, column by column (compile-time offsets
        // keep out[] in registers)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (c0 + v < m) {
            if constexpr (EB >= 4) {
#pragma unroll
              for (int w = 0; w < EB / 4; ++w)
                reinterpret_cast<uint32_t*>(dst)[v * EB / 4 + w] =
                    out[v * EB / 4 + w];
            } else {
#pragma unroll
              for (int q = 0; q < EB; ++q)
                dst[v * EB + q] =
                    (unsigned char)(out[(v * EB + q) >> 2] >>
                                    (8 * ((v * EB + q) & 3)));
            }
          }
        }
      }
    }
  }
}

// Rows stored narrow (SRC) staged as f32 [m][RP]: each value widened as
// the gather would widen it (int8 times its row's scale, rounded once), so
// the gathers read f32 and the scores are the same bits.
template <int SRC, int RP>
__device__ void stage_widen(unsigned char* srows, const Params& p,
                            const int* rows, int nr) {
  constexpr int ISZ = Width<SRC>::v;          // 2 or 1
  const int m = p.m;
  const int groups = (m + 3) / 4;             // 4 columns a thread step
  const size_t row_bytes = (size_t)m * ISZ;
  for (int g0 = threadIdx.x; g0 < groups; g0 += blockDim.x) {
    const int c0 = g0 * 4;
    uint32_t out[4 * RP];
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      uint32_t w[2] = {0, 0};
      float scale = 1.0f;
      if (r < nr) {
        const unsigned char* src =
            p.logp + (size_t)rows[r] * row_bytes + (size_t)c0 * ISZ;
        if (p.vec_rows && c0 + 4 <= m) {
          load_bytes<4 * ISZ>(w, src);
        } else {
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            if (c0 + v < m) {
              uint32_t x[1];
              load_bytes<ISZ>(x, src + v * ISZ);
              put_elem<ISZ>(w, v * ISZ, x[0]);
            }
          }
        }
        if (SRC == kI8) scale = p.scales[rows[r]];
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const uint32_t e = get_elem<ISZ>(w, v * ISZ);
        float f;
        if constexpr (SRC == kBF16) {
          f = __uint_as_float(e << 16);
        } else if constexpr (SRC == kI8) {
          f = __fmul_rn(static_cast<float>((int8_t)e), scale);
        } else {
          f = __half2float(__half(
              __nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)e, __NV_E4M3)));
        }
        out[v * RP + r] = r < nr ? __float_as_uint(f) : 0u;
      }
    }
    uint32_t* dst = reinterpret_cast<uint32_t*>(srows) + (size_t)c0 * RP;
    if (c0 + 4 <= m) {
#pragma unroll
      for (int q = 0; q < RP; ++q)
        reinterpret_cast<uint4*>(dst)[q] = make_uint4(
            out[4 * q], out[4 * q + 1], out[4 * q + 2], out[4 * q + 3]);
    } else {
#pragma unroll
      for (int v = 0; v < 4; ++v)
        if (c0 + v < m)
#pragma unroll
          for (int r = 0; r < RP; ++r) dst[v * RP + r] = out[v * RP + r];
    }
  }
}

// ---------------------------------------------------------------------------
// gathers: one index's entry for the RP rows, widened to f32
// ---------------------------------------------------------------------------

template <int DT, int RP>
struct Entry {
  static constexpr int EB = Width<DT>::v * RP;
  static constexpr int NW = EB >= 4 ? EB / 4 : 1;
  uint32_t w[NW];

  __device__ __forceinline__ void load(const unsigned char* srows,
                                       unsigned h) {
    const unsigned char* q = srows + (size_t)h * EB;
    if constexpr (EB == 32) {
      const uint4 a = reinterpret_cast<const uint4*>(q)[0];
      const uint4 b = reinterpret_cast<const uint4*>(q)[1];
      w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
      w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
    } else {
      load_bytes<EB>(w, q);
    }
  }

  // row r's value as f32, exactly; int8 then times its scale, rounded once
  __device__ __forceinline__ float get(int r, float scale) const {
    if constexpr (DT == kF32) {
      return __uint_as_float(w[r]);
    } else if constexpr (DT == kBF16) {
      const uint32_t x = w[r >> 1];
      return __uint_as_float((r & 1) ? (x & 0xffff0000u) : (x << 16));
    } else if constexpr (DT == kI8) {
      // 0x4B000000 | (q + 128) is the float 2^23 + q + 128
      const uint32_t x =
          __byte_perm(w[r >> 2] ^ 0x80808080u, 0x4B000000u, 0x7650 | (r & 3));
      return __fmul_rn(__fsub_rn(__uint_as_float(x), 8388736.0f), scale);
    } else {
      const __nv_fp8_storage_t b =
          (__nv_fp8_storage_t)((w[r >> 2] >> (8 * (r & 3))) & 0xffu);
      return __half2float(__half(__nv_cvt_fp8_to_halfraw(b, __NV_E4M3)));
    }
  }
};

// ---------------------------------------------------------------------------
// warp lists and thresholds
// ---------------------------------------------------------------------------

// The warp's 32 values x (no NaN) sorted descending across the lanes, by
// a bitonic network: lane l returns the (l+1)-th largest.
__device__ __forceinline__ float warp_sort_desc(float x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, x, j);
      const bool keep_max = ((lane & j) == 0) == ((lane & k) == 0);
      x = keep_max ? fmaxf(x, y) : fminf(x, y);
    }
  }
  return x;
}

// Cuts the warp's list buf[0, fill) to its topk best, in order, and raises
// the block threshold to the topk-th. Returns the new fill.
__device__ __forceinline__ int compact(unsigned long long* buf, int fill,
                                    int topk, unsigned long long* theta) {
  constexpr int Q = kMaxList / 32;
  const int lane = threadIdx.x & 31;
  unsigned long long mine[Q];
  int rank[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int e = lane + 32 * q;
    mine[q] = e < fill ? buf[e] : kSentinel;
    rank[q] = 0;
  }
  for (int j = 0; j < fill; ++j) {
    const unsigned long long o = buf[j];
#pragma unroll
    for (int q = 0; q < Q; ++q) rank[q] += ent_better(o, mine[q]);
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < Q; ++q)
    if (lane + 32 * q < fill && rank[q] < topk) buf[rank[q]] = mine[q];
  __syncwarp();
  const int n = fill < topk ? fill : topk;
#ifdef BLOOM_DECODE_TOPK_PROFILE
  if (lane == 0 && blockIdx.x < kProfBlocks)
    atomicAdd(&g_compactions[blockIdx.x], 1);
#endif
  if (n == topk && lane == 0) {
    const unsigned long long e = buf[topk - 1];
    atomicMax(theta, tkey(ent_v(e), ent_i(e)));
  }
  __syncwarp();
  return n;
}

// Offers score s of id i (NaN: no score) for one row to the warp's list
// buf with *fill_p entries. Warp-uniform; returns the block threshold's
// score. (One call site: an out-of-line call would save the scan's
// registers to local memory, which the shared-memory carve-out leaves
// uncached.)
__device__ __forceinline__ float offer(float s, unsigned i,
                                    unsigned long long* buf, int* fill_p,
                                    int cw, int topk,
                                    unsigned long long* theta) {
  const int lane = threadIdx.x & 31;
  unsigned long long key =
      *reinterpret_cast<volatile unsigned long long*>(theta);
  bool pass = better(s, i, tkey_v(key), tkey_i(key));
  unsigned mask = __ballot_sync(0xffffffffu, pass);
  if (mask == 0) return tkey_v(key);
  int fill = *reinterpret_cast<volatile int*>(fill_p);
  if (fill + __popc(mask) > cw) {
    fill = compact(buf, fill, topk, theta);
    key = *reinterpret_cast<volatile unsigned long long*>(theta);
    pass = better(s, i, tkey_v(key), tkey_i(key));
    mask = __ballot_sync(0xffffffffu, pass);
  }
  if (pass) buf[fill + __popc(mask & ((1u << lane) - 1u))] = pack(s, i);
  __syncwarp();
  if (lane == 0) *fill_p = fill + __popc(mask);
  __syncwarp();
  return tkey_v(key);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// The H indices of chunk c's ids for a lane (k <= 4): one int2 or int4
// load an id where H's layout allows, zeros past d.
template <int U>
__device__ __forceinline__ void load_h(int4 (&h)[U], const Params& p,
                                       unsigned c, unsigned n_chunks,
                                       int lane) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const unsigned i = c * (32u * U) + u * 32 + lane;
    int4 v = make_int4(0, 0, 0, 0);
    if (c < n_chunks && i < (unsigned)p.d) {
      if (p.k == 2) {
        const int2 t = reinterpret_cast<const int2*>(p.H)[i];
        v.x = t.x;
        v.y = t.y;
      } else if (p.vec_h4) {
        v = reinterpret_cast<const int4*>(p.H)[i];
      } else {
        const int* q = p.H + (size_t)i * p.k;
        v.x = q[0];
        if (p.k > 1) v.y = q[1];
        if (p.k > 2) v.z = q[2];
        if (p.k > 3) v.w = q[3];
      }
    }
    h[u] = v;
  }
}

// Numbers the entries of the rows' warp lists densely: entry q of row r
// (q < off[r][nw]) is slot q - off[r][w] of warp w's list, where
// off[r][w] <= q < off[r][w + 1]; row r's entries are numbers roff[r] to
// roff[r + 1] - 1 of the block. Every thread calls it.
template <int RP>
__device__ void number_lists(const int* fills, int nw, int nr,
                             int (*off)[kMaxWarps + 1], int* roff) {
  __syncthreads();
  // warp r: row r's list offsets by a scan over the lanes (lane w, list
  // w), and the rows above it summed the same way
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < nr; r += blockDim.x >> 5) {
    const int f = lane < nw ? fills[lane * RP + r] : 0;
    int incl = f;
#pragma unroll
    for (int x = 1; x < 32; x <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, x);
      if (lane >= x) incl += y;
    }
    int above = 0;
    for (int r2 = 0; r2 < r; ++r2) above += lane < nw ? fills[lane * RP + r2] : 0;
#pragma unroll
    for (int x = 16; x > 0; x >>= 1)
      above += __shfl_xor_sync(0xffffffffu, above, x);
    if (lane < nw) off[r][lane] = incl - f;
    if (lane == nw - 1) off[r][nw] = incl;
    if (lane == 0) roff[r] = above;
  }
  __syncthreads();
  if (threadIdx.x == 0) roff[nr] = roff[nr - 1] + off[nr - 1][nw];
  __syncthreads();
}

// Each numbered entry's rank in its row (the number of the row's entries
// that beat it), counted by kRankLanes neighbouring threads, each over
// every kRankLanes-th warp list; calls f(r, e, rank) once per entry.
// Every thread calls it; f runs on one thread of the group.
constexpr int kRankLanes = 8;
template <int RP, typename F>
__device__ __forceinline__ void rank_entries(const unsigned long long* bufs,
                                             int nw, int cw, int nr,
                                             const int (*off)[kMaxWarps + 1],
                                             const int* roff, F f) {
  const int n = roff[nr] * kRankLanes;
  const int part = threadIdx.x % kRankLanes;
  for (int base = 0; base < n; base += blockDim.x) {
    const int t = base + threadIdx.x;
    int r = 0, rank = 0;
    unsigned long long e = kSentinel;
    if (t < n) {
      const int q0 = t / kRankLanes;
      while (r + 1 < nr && roff[r + 1] <= q0) ++r;
      const int q = q0 - roff[r];
      int w = 0;   // the last list that starts at or before q
      for (int step = kMaxWarps / 2; step > 0; step >>= 1)
        if (w + step < nw && off[r][w + step] <= q) w += step;
      e = bufs[((size_t)w * RP + r) * cw + (q - off[r][w])];
      for (int w2 = part; w2 < nw; w2 += kRankLanes) {
        const unsigned long long* o = bufs + ((size_t)w2 * RP + r) * cw;
        const int fl = off[r][w2 + 1] - off[r][w2];
        for (int j = 0; j < fl; ++j) rank += ent_better(o[j], e);
      }
    }
#pragma unroll
    for (int x = 1; x < kRankLanes; x <<= 1)
      rank += __shfl_xor_sync(0xffffffffu, rank, x);
    if (t < n && part == 0) f(r, e, rank);
  }
}

// Raises each row's block threshold to the topk-th best entry of all the
// warps' lists, when they hold topk; every thread of the block calls it.
template <int RP>
__device__ __forceinline__ void block_refresh(const unsigned long long* bufs,
                                              const int* fills, int nw,
                                              int cw, int nr, int topk,
                                              unsigned long long* theta,
                                              int (*off)[kMaxWarps + 1],
                                              int* roff) {
  number_lists<RP>(fills, nw, nr, off, roff);
  rank_entries<RP>(bufs, nw, cw, nr, off, roff,
                   [&](int r, unsigned long long e, int rank) {
                     if (rank == topk - 1)
                       atomicMax(&theta[r], tkey(ent_v(e), ent_i(e)));
                   });
  __syncthreads();
}

// Drops the entries of the warp's list buf[0, fill) that the threshold
// key beats; returns the new fill. Warp-uniform.
__device__ __forceinline__ int prune(unsigned long long* buf, int fill,
                                  unsigned long long key) {
  constexpr int Q = kMaxList / 32;
  const int lane = threadIdx.x & 31;
  unsigned long long e[Q];
  bool keep[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int j = lane + 32 * q;
    e[q] = j < fill ? buf[j] : kSentinel;
    keep[q] = j < fill &&
              !better(tkey_v(key), tkey_i(key), ent_v(e[q]), ent_i(e[q]));
  }
  __syncwarp();
  int n = 0;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const unsigned bal = __ballot_sync(0xffffffffu, keep[q]);
    if (keep[q]) buf[n + __popc(bal & ((1u << lane) - 1u))] = e[q];
    n += __popc(bal);
  }
  __syncwarp();
  return n;
}

// The live rows of live rank lo..hi-1 into rows[]; every thread calls it.
__device__ void find_rows(const Params& p, int lo, int hi, int* rows,
                          int* wcount) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  if (p.active == nullptr) {
    if ((int)threadIdx.x < hi - lo) rows[threadIdx.x] = lo + threadIdx.x;
    return;
  }
  int base = 0;
  for (int c0 = 0; c0 < p.B; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    const bool live = c < p.B && p.active[c] != 0;
    const unsigned bal = __ballot_sync(0xffffffffu, live);
    if (lane == 0) wcount[warp] = __popc(bal);
    __syncthreads();
    int before = base, total = 0;
    for (int w = 0; w < nw; ++w) {
      const int n = wcount[w];
      before += w < warp ? n : 0;
      total += n;
    }
    if (live) {
      const int rank = before + __popc(bal & ((1u << lane) - 1u));
      if (rank >= lo && rank < hi) rows[rank - lo] = c;
    }
    base += total;
    __syncthreads();
  }
}

template <int DT, int RP, int KIND>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    decode_topk(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long s_theta[kMaxRows];
  __shared__ int s_rows[kMaxRows];
  __shared__ float s_scale[kMaxRows];
  __shared__ unsigned s_step[kMaxHashK];
  __shared__ int s_wcount[kMaxWarps];
  __shared__ int s_n[kMaxRows];
  __shared__ int s_off[kMaxRows][kMaxWarps + 1];
  __shared__ int s_roff[kMaxRows + 1];
  __shared__ int s_last;
  __shared__ __align__(8) unsigned long long s_bar;   // the row copies' mbarrier

  const int nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int B = p.B, topk = p.topk, cw = p.cw;
  unsigned char* srows = smem;
  unsigned long long* bufs =
      reinterpret_cast<unsigned long long*>(smem + p.rows_bytes);
  int* fills = reinterpret_cast<int*>(bufs + (size_t)nw * RP * cw);

  // the live-row count, and the dead rows' outputs
  int n_live = 0;
  for (int c0 = 0; c0 < B; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    n_live += __syncthreads_count(
        c < B && (p.active == nullptr || p.active[c] != 0));
  }
  if (p.active != nullptr) {
    const size_t n_out = (size_t)B * topk;
    for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n_out;
         e += (size_t)gridDim.x * blockDim.x) {
      if (p.active[e / topk] == 0) {
        p.vals[e] = -CUDART_INF_F;
        p.ids[e] = 0;
      }
    }
  }
  if (n_live == 0) return;
  // live rows in tiles of at most RP, balanced; G blocks per tile, no
  // more than give each warp a step of the catalog (a block costs its
  // staging, whatever its share)
  const unsigned chunk = 32u * kU;
  const unsigned n_chunks = ((unsigned)p.d + chunk - 1) / chunk;
  const int n_tiles = (n_live + RP - 1) / RP;
  const int g_need = (int)((n_chunks + nw - 1) / nw);
  const int G = min(n_tiles <= (int)gridDim.x ? (int)gridDim.x / n_tiles : 1,
                    g_need);
  const int n_units = n_tiles * G;
  if (KIND == kHash && (int)threadIdx.x < p.k) {
    const unsigned long long j = threadIdx.x;   // j(j-1)/2 is 0 at j = 0
    s_step[j] = (unsigned)(j * (j - 1) / 2 % (unsigned)p.m);
  }
  const unsigned m = (unsigned)p.m;
  const unsigned m1 = m > 1 ? m - 1 : 1;
  const unsigned bar = (unsigned)__cvta_generic_to_shared(&s_bar);
  unsigned phase = 0;
  if (RP == 1 && threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  for (int unit = blockIdx.x; unit < n_units; unit += gridDim.x) {
    const int tile = unit % n_tiles, g = unit / n_tiles;
    const int lo = (int)((long long)tile * n_live / n_tiles);
    const int hi = (int)((long long)(tile + 1) * n_live / n_tiles);
    const int nr = hi - lo;
    PROF(0);
    find_rows(p, lo, hi, s_rows, s_wcount);
    __syncthreads();
    if ((int)threadIdx.x < RP) {
      s_theta[threadIdx.x] = kNoTheta;
      s_scale[threadIdx.x] = (DT == kI8 && (int)threadIdx.x < nr)
                                 ? p.scales[s_rows[threadIdx.x]] : 1.0f;
    }
    for (int e = threadIdx.x; e < nw * RP; e += blockDim.x) fills[e] = 0;
    // the first step's H indices load while the rows stage
    int4 hnext[kU];
    if constexpr (KIND == kHVec)
      load_h<kU>(hnext, p, (unsigned)(g * nw + warp), n_chunks, lane);
    bool widened = false;
    if constexpr (DT == kF32) {
      widened = p.src_dt != kF32;
      if (p.src_dt == kBF16) stage_widen<kBF16, RP>(srows, p, s_rows, nr);
      if (p.src_dt == kI8) stage_widen<kI8, RP>(srows, p, s_rows, nr);
      if (p.src_dt == kFP8) stage_widen<kFP8, RP>(srows, p, s_rows, nr);
    }
    if (!widened && RP == 1 && p.vec_rows) {
      // one row, no transpose: a bulk copy
      bulk_row(srows, p.logp + (size_t)s_rows[0] * p.m * Width<DT>::v,
               (unsigned)p.m * Width<DT>::v, bar, phase);
      phase ^= 1u;
    } else if (!widened) {
      stage_tile<Width<DT>::v, RP>(srows, p, s_rows, nr);
    }
    __syncthreads();
    PROF(1);

    float scale[RP];
#pragma unroll
    for (int r = 0; r < RP; ++r) scale[r] = s_scale[r];
    unsigned long long* wbuf = bufs + (size_t)warp * RP * cw;
    int* wfill = fills + warp * RP;

    // chunk c holds ids c * chunk + u * 32 + lane (u < kU); warp gw of the
    // tile's G * nw warps takes chunks gw, gw + G * nw, ... Every warp of
    // the block runs the same number of steps (one past the catalog scores
    // nothing): after the first, the block threshold comes from the lanes'
    // best scores; after steps 3, 7 and 15 a block refresh raises it to
    // the topk-th best of all lists, so each period adds about topk
    // entries a row and later steps rarely leave the fast path
    const unsigned tw = (unsigned)(G * nw);
    const unsigned first = (unsigned)(g * nw);
    const int n_steps =
        first < n_chunks ? (int)((n_chunks - first + tw - 1) / tw) : 1;
    unsigned c = first + warp;
    float thv[RP];
#ifdef BLOOM_DECODE_TOPK_PROFILE
    long long acc_[kProfCounts] = {0, 0, 0, 0, 0, 0};
#endif
    for (int st = 0, next = 4; st < n_steps; ++st, c += tw) {
      SCAN_T0();
      // s[u][r]: the scores of chunk c's ids, NaN past d
      float s[kU][RP];
      int4 hcur[kU];
      if constexpr (KIND == kHVec) {
#pragma unroll
        for (int u = 0; u < kU; ++u) hcur[u] = hnext[u];
        load_h<kU>(hnext, p, c + tw, n_chunks, lane);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const unsigned i = c * chunk + u * 32 + lane;
        const bool valid = c < n_chunks && i < (unsigned)p.d;
        float acc[RP];
        Entry<DT, RP> e;
        if constexpr (KIND == kHash) {
          unsigned x = fastmod(splitmix32(i ^ p.c1), m, p.mp_m, p.sh_m);
          const unsigned h2 =
              fastmod(splitmix32(i ^ p.c2), m1, p.mp_m1, p.sh_m1) + 1u;
          e.load(srows, x);
#pragma unroll
          for (int r = 0; r < RP; ++r) acc[r] = e.get(r, scale[r]);
          for (int j = 1; j < p.k; ++j) {
            x += h2;
            if (x >= m) x -= m;
            x += s_step[j];
            if (x >= m) x -= m;
            e.load(srows, x);
#pragma unroll
            for (int r = 0; r < RP; ++r)
              acc[r] = __fadd_rn(acc[r], e.get(r, scale[r]));
          }
        } else if constexpr (KIND == kHVec) {
          e.load(srows, (unsigned)hcur[u].x);
#pragma unroll
          for (int r = 0; r < RP; ++r) acc[r] = e.get(r, scale[r]);
          if (p.k > 1) {
            e.load(srows, (unsigned)hcur[u].y);
#pragma unroll
            for (int r = 0; r < RP; ++r)
              acc[r] = __fadd_rn(acc[r], e.get(r, scale[r]));
          }
          if (p.k > 2) {
            e.load(srows, (unsigned)hcur[u].z);
#pragma unroll
            for (int r = 0; r < RP; ++r)
              acc[r] = __fadd_rn(acc[r], e.get(r, scale[r]));
          }
          if (p.k > 3) {
            e.load(srows, (unsigned)hcur[u].w);
#pragma unroll
            for (int r = 0; r < RP; ++r)
              acc[r] = __fadd_rn(acc[r], e.get(r, scale[r]));
          }
        } else {
          const int* q = p.H + (size_t)(valid ? i : 0u) * p.k;
          e.load(srows, (unsigned)q[0]);
#pragma unroll
          for (int r = 0; r < RP; ++r) acc[r] = e.get(r, scale[r]);
          for (int j = 1; j < p.k; ++j) {
            e.load(srows, (unsigned)q[j]);
#pragma unroll
            for (int r = 0; r < RP; ++r)
              acc[r] = __fadd_rn(acc[r], e.get(r, scale[r]));
          }
        }
#pragma unroll
        for (int r = 0; r < RP; ++r) s[u][r] = valid ? acc[r] : CUDART_NAN_F;
      }
#ifdef BLOOM_DECODE_TOPK_PROFILE
      {
        float z = 0.0f;
#pragma unroll
        for (int u = 0; u < kU; ++u)
#pragma unroll
          for (int r = 0; r < RP; ++r) z += s[u][r];
        if (z == 12345.0f) acc_[5] += 1;   // waits for the scores
      }
      SCAN_ADD(0);
#endif

      if (st == 0) {
        // the topk-th largest of the block's lane bests (each the score
        // of another id, so topk real ids reach it; topk <= 32): each warp
        // sorts its 32 into the (empty) list area, then warp r merges the
        // nw sorted runs of row r, topk heads deep
        float* runs = reinterpret_cast<float*>(bufs);   // [RP][nw][32]
        if (topk <= 32) {
#pragma unroll
          for (int r = 0; r < RP; ++r) {
            if (r < nr) {
              float x = -CUDART_INF_F;
#pragma unroll
              for (int u = 0; u < kU; ++u) x = s[u][r] > x ? s[u][r] : x;
              runs[(r * nw + warp) * 32 + lane] = warp_sort_desc(x);
            }
          }
        }
        __syncthreads();
        if (topk <= 32) {
          for (int r = warp; r < nr; r += nw) {
            const float* run = runs + (size_t)r * nw * 32;
            int pos = 0;   // lane w's place in run w
            float x = -CUDART_INF_F;
            for (int q = 0; q < topk; ++q) {
              const float h = lane < nw && pos < 32 ? run[lane * 32 + pos]
                                                    : -CUDART_INF_F;
              x = h;
              int who = lane;
#pragma unroll
              for (int off = 16; off > 0; off >>= 1) {
                const float ox = __shfl_xor_sync(0xffffffffu, x, off);
                const int ow = __shfl_xor_sync(0xffffffffu, who, off);
                if (ox > x || (ox == x && ow < who)) {
                  x = ox;
                  who = ow;
                }
              }
              if (lane == who) ++pos;
            }
            if (lane == 0 && x > -CUDART_INF_F)
              s_theta[r] = tkey(x, 0xffffffffu);
          }
        }
        __syncthreads();
        PROF(2);
#pragma unroll
        for (int r = 0; r < RP; ++r) thv[r] = tkey_v(s_theta[r]);
      }

      // the scores that beat the block threshold into the lists: a
      // warp-wide OR of each lane's (u, r) hits, then only those pairs
      unsigned long long bits = 0;
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int r = 0; r < RP; ++r)
          if (r < nr && s[u][r] >= thv[r]) bits |= 1ull << (u * RP + r);
      const unsigned any_lo = __reduce_or_sync(0xffffffffu, (unsigned)bits);
      unsigned any_hi = 0;
      if constexpr (kU * RP > 32)
        any_hi = __reduce_or_sync(0xffffffffu, (unsigned)(bits >> 32));
      if ((any_lo | any_hi) != 0) {
#ifdef BLOOM_DECODE_TOPK_PROFILE
        acc_[3] += 1;
        acc_[4] += __popcll(((unsigned long long)any_hi << 32) | any_lo);
#endif
        // one (u, r) hit at a time; the selects keep s and thv in
        // registers (an index into them would move them to local memory)
        bits = ((unsigned long long)any_hi << 32) | any_lo;
        while (bits != 0) {
          const int b = __ffsll((long long)bits) - 1;
          bits &= bits - 1;
          const int ub = b / RP, rb = b % RP;
          float sv = 0.0f;
#pragma unroll
          for (int u = 0; u < kU; ++u)
#pragma unroll
            for (int r = 0; r < RP; ++r)
              if (u * RP + r == b) sv = s[u][r];
          const float t = offer(sv, c * chunk + ub * 32 + lane,
                                wbuf + rb * cw, wfill + rb, cw, topk,
                                &s_theta[rb]);
#pragma unroll
          for (int r = 0; r < RP; ++r)
            if (r == rb) thv[r] = t;
        }
      }

#ifdef BLOOM_DECODE_TOPK_PROFILE
      SCAN_ADD(1);
#endif
      if (st + 1 == next && st + 1 < n_steps && next <= kLastRefresh) {
        next *= 2;
        block_refresh<RP>(bufs, fills, nw, cw, nr, topk, s_theta, s_off,
                          s_roff);
#pragma unroll 1
        for (int r = 0; r < nr; ++r) {
          const int n = prune(wbuf + r * cw, wfill[r], s_theta[r]);
          if (lane == 0) wfill[r] = n;
          __syncwarp();
        }
#pragma unroll
        for (int r = 0; r < RP; ++r) thv[r] = tkey_v(s_theta[r]);
#ifdef BLOOM_DECODE_TOPK_PROFILE
        SCAN_ADD(2);
#endif
      }
    }
#ifdef BLOOM_DECODE_TOPK_PROFILE
    if (threadIdx.x == 0 && blockIdx.x < kProfBlocks) {
      for (int q = 0; q < kProfCounts; ++q) g_prof_scan[blockIdx.x][q] = acc_[q];
      g_prof_scan[blockIdx.x][5] = n_steps;
    }
#endif
    __syncthreads();
    PROF(3);

    // the block's partial top-k per row, in order: its warps' entries that
    // reach the block threshold, each placed at its rank
    unsigned long long* part = p.part + (size_t)tile * RP * G * topk;
    if ((int)threadIdx.x < RP) s_n[threadIdx.x] = 0;
    number_lists<RP>(fills, nw, nr, s_off, s_roff);
    rank_entries<RP>(bufs, nw, cw, nr, s_off, s_roff,
                     [&](int r, unsigned long long e, int rank) {
                       const unsigned long long key = s_theta[r];
                       if (better(tkey_v(key), tkey_i(key), ent_v(e),
                                  ent_i(e)))
                         return;
                       atomicAdd(&s_n[r], 1);
                       if (rank < topk)
                         part[((size_t)r * G + g) * topk + rank] = e;
                     });
    __syncthreads();
    for (int t = threadIdx.x; t < nr * topk; t += blockDim.x) {
      const int r = t / topk, q = t % topk;
      if (q >= s_n[r]) part[((size_t)r * G + g) * topk + q] = kSentinel;
    }
    PROF(4);

    // the last block of the tile merges its G partials
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) s_last = atomicAdd(&p.tickets[tile], 1) == G - 1;
    __syncthreads();
    if (s_last) {
      __threadfence();
      // scratch in the staging area: the partial heads (RP * G), then per
      // row up to cap entries that reach the topk-th best head
      unsigned long long* heads = reinterpret_cast<unsigned long long*>(srows);
      unsigned long long* surv = heads + (size_t)RP * G;
      const int cap = (int)(((size_t)p.rows_bytes / 8 - (size_t)RP * G) / RP);
      if ((int)threadIdx.x < RP) {
        s_n[threadIdx.x] = 0;
        s_theta[threadIdx.x] = kNoTheta;
      }
      for (int t = threadIdx.x; t < nr * G; t += blockDim.x)
        heads[t] = __ldcg(part + (size_t)t * topk);
      __syncthreads();
      for (int t = threadIdx.x; t < nr * G; t += blockDim.x) {
        const int r = t / G;
        const unsigned long long e = heads[t];
        if (ent_i(e) == kSentinelId) continue;
        int rank = 0;
        for (int g2 = 0; g2 < G; ++g2) rank += ent_better(heads[r * G + g2], e);
        if (rank == topk - 1) s_theta[r] = tkey(ent_v(e), ent_i(e));
      }
      __syncthreads();
      for (int t = threadIdx.x; t < nr * G * topk; t += blockDim.x) {
        const int r = t / (G * topk);
        const unsigned long long e = __ldcg(part + t);
        const unsigned long long key = s_theta[r];
        if (ent_i(e) == kSentinelId ||
            better(tkey_v(key), tkey_i(key), ent_v(e), ent_i(e)))
          continue;
        const int slot = atomicAdd(&s_n[r], 1);
        if (slot < cap) surv[(size_t)r * cap + slot] = e;
      }
      __syncthreads();
      for (int r = 0; r < nr; ++r) {
        const int n = s_n[r];
        if (n > cap) continue;
        const unsigned long long* o = surv + (size_t)r * cap;
        for (int q = threadIdx.x; q < n; q += blockDim.x) {
          const unsigned long long e = o[q];
          int rank = 0;
          for (int q2 = 0; q2 < n; ++q2) rank += ent_better(o[q2], e);
          if (rank < topk) {
            const size_t out = (size_t)s_rows[r] * topk + rank;
            p.vals[out] = ent_v(e);
            p.ids[out] = (int)ent_i(e);
          }
        }
      }
      // a row whose survivors overflow the scratch: one warp picks the best
      // partial head topk times (positions in the row's survivor area)
      for (int r = warp; r < nr; r += nw) {
        if (s_n[r] <= cap) continue;
        int* pos = reinterpret_cast<int*>(surv + (size_t)r * cap);
        for (int g2 = lane; g2 < G; g2 += 32) pos[g2] = 0;
        __syncwarp();
        for (int q = 0; q < topk; ++q) {
          unsigned long long best = kSentinel;
          int bg = -1;
          for (int g2 = lane; g2 < G; g2 += 32) {
            const unsigned long long e = heads[r * G + g2];
            if (bg < 0 || ent_better(e, best)) {
              best = e;
              bg = g2;
            }
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            const unsigned long long ob =
                __shfl_xor_sync(0xffffffffu, best, off);
            const int og = __shfl_xor_sync(0xffffffffu, bg, off);
            if (og >= 0 && (bg < 0 || ent_better(ob, best) ||
                            (ob == best && og < bg))) {
              best = ob;
              bg = og;
            }
          }
          if (lane == 0) {
            const size_t out = (size_t)s_rows[r] * topk + q;
            p.vals[out] = ent_v(best);
            p.ids[out] = (int)ent_i(best);
            const int np = ++pos[bg];
            heads[r * G + bg] =
                np < topk ? __ldcg(part + ((size_t)r * G + bg) * topk + np)
                          : kSentinel;
          }
          __syncwarp();
        }
      }
      // fewer than topk scores that are not NaN: sentinels fill the rest
      for (int t = threadIdx.x; t < nr * topk; t += blockDim.x) {
        const int r = t / topk, q = t % topk;
        if (s_n[r] <= cap && q >= s_n[r]) {
          const size_t out = (size_t)s_rows[r] * topk + q;
          p.vals[out] = -CUDART_INF_F;
          p.ids[out] = (int)kSentinelId;
        }
      }
      if (threadIdx.x == 0) p.tickets[tile] = 0;
    }
    __syncthreads();
    PROF(5);
  }
}

template <int DT, int RP, int KIND>
int launch_one(const Params& p, int warps, int grid, cudaStream_t stream) {
  static unsigned ready = 0;   // devices whose attribute is set
  auto fn = decode_topk<DT, RP, KIND>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32 || !(ready >> dev & 1u)) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)attr.sharedSizeBytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < 32) ready |= 1u << dev;
  }
  const size_t smem = (size_t)p.rows_bytes +
                      (size_t)warps * RP * p.cw * 8 + (size_t)warps * RP * 4;
  fn<<<grid, warps * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int DT, int RP>
int launch_kind(const Params& p, int warps, int grid, cudaStream_t s) {
  if (p.H == nullptr) return launch_one<DT, RP, kHash>(p, warps, grid, s);
  if (p.k <= 4) return launch_one<DT, RP, kHVec>(p, warps, grid, s);
  // H with k > 4 (no path of the port has one) takes one row a tile
  if constexpr (RP == 1) return launch_one<DT, RP, kHGen>(p, warps, grid, s);
  return (int)cudaErrorInvalidValue;
}

template <int DT>
int launch_rows(const Params& p, int rows, int warps, int grid,
                cudaStream_t s) {
  switch (rows) {
    case 1: return launch_kind<DT, 1>(p, warps, grid, s);
    case 2: return launch_kind<DT, 2>(p, warps, grid, s);
    case 4: return launch_kind<DT, 4>(p, warps, grid, s);
    case 8: return launch_kind<DT, 8>(p, warps, grid, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Largest topk the kernel takes; the Python wrapper raises above it.
int bloom_decode_topk_max_topk() { return kMaxTopk; }

// Largest k the in-kernel hash takes; the Python wrapper raises above it.
int bloom_decode_topk_max_hash_k() { return kMaxHashK; }

// Launches the kernel on `stream` without synchronising. logp is (B, m)
// stored as `dtype` (a Dtype code); scales (B,) f32 for int8, else null;
// H (d, k) int32, or null to hash in the kernel with the salts c1, c2 and
// the remainder constants (mp, sh) of m and max(m - 1, 1); active is null
// or (B,) int32. tickets is (>= B,) int32 of zeros, left zero; part is
// (>= max(grid, B) * rows * topk,) 8-byte scratch; vals/ids are (B, topk).
// The plan: `rows` live rows per tile (1, 2, 4 or 8; 1 for H with k > 4),
// `warps` per block, `grid` blocks, `rows_bytes` of shared memory for the
// staged rows, `cw` entries per warp list, and `widen`: stage narrow logp
// as f32 (rows_bytes then counts 4 bytes a value). Returns the CUDA error
// code of the launch.
int bloom_decode_topk(const void* logp, int dtype, const float* scales,
                      const int* H, unsigned c1, unsigned c2,
                      unsigned mp_m, unsigned sh_m, unsigned mp_m1,
                      unsigned sh_m1, const int* active, int* tickets,
                      void* part, float* vals, int* ids, int B, int m, int d,
                      int k, int topk, int rows, int warps, int grid,
                      int rows_bytes, int cw, int widen, void* stream) {
  if (dtype < kF32 || dtype > kFP8 || (dtype == kI8) != (scales != nullptr) ||
      (H == nullptr && k > kMaxHashK) || topk < 1 || topk > kMaxTopk ||
      warps < 1 || warps > kMaxWarps || cw < topk + 32 || cw > kMaxList ||
      grid < 1 || rows_bytes % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t isz = dtype == kF32 ? 4 : dtype == kBF16 ? 2 : 1;
  Params p;
  p.logp = static_cast<const unsigned char*>(logp);
  p.scales = scales;
  p.H = H;
  p.active = active;
  p.tickets = tickets;
  p.part = static_cast<unsigned long long*>(part);
  p.vals = vals;
  p.ids = ids;
  p.B = B;
  p.m = m;
  p.d = d;
  p.k = k;
  p.topk = topk;
  p.rows_bytes = rows_bytes;
  p.cw = cw;
  p.c1 = c1;
  p.c2 = c2;
  p.mp_m = mp_m;
  p.sh_m = sh_m;
  p.mp_m1 = mp_m1;
  p.sh_m1 = sh_m1;
  p.vec_rows = (uintptr_t)logp % 16 == 0 && (size_t)m * isz % 16 == 0;
  p.vec_h4 = H != nullptr && k == 4 && (uintptr_t)H % 16 == 0;
  p.src_dt = dtype;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (widen) return launch_rows<kF32>(p, rows, warps, grid, s);
  switch (dtype) {
    case kF32: return launch_rows<kF32>(p, rows, warps, grid, s);
    case kBF16: return launch_rows<kBF16>(p, rows, warps, grid, s);
    case kI8: return launch_rows<kI8>(p, rows, warps, grid, s);
    case kFP8: return launch_rows<kFP8>(p, rows, warps, grid, s);
  }
  return (int)cudaErrorInvalidValue;
}

#ifdef BLOOM_DECODE_TOPK_PROFILE
// Section timers of the profiling build (kernels/sweep_decode_topk.py
// --profile): clock64() of each block at its phase boundaries.
const char* bloom_decode_topk_profile_names() {
  return "rows,first step,scan,block merge,last-block merge";
}
int bloom_decode_topk_profile(long long* out, int n_blocks) {
  return (int)cudaMemcpyFromSymbol(
      out, g_prof, sizeof(long long) * kProfSlots * n_blocks);
}
int bloom_decode_topk_profile_reset() {
  static long long zeros[kProfBlocks][kProfSlots];
  static int izeros[kProfBlocks];
  const cudaError_t err =
      cudaMemcpyToSymbol(g_compactions, izeros, sizeof(izeros));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(g_prof, zeros, sizeof(zeros));
}
int bloom_decode_topk_profile_slots() { return kProfSlots; }
// warp 0's cycles scoring / offering / refreshing, slow paths, (u, r) hits
// and steps (kProfCounts per block), and each block's compactions
int bloom_decode_topk_profile_scan(long long* out, int* comp, int n_blocks) {
  cudaError_t err = cudaMemcpyFromSymbol(
      out, g_prof_scan, sizeof(long long) * kProfCounts * n_blocks);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyFromSymbol(comp, g_compactions,
                                   sizeof(int) * n_blocks);
}
int bloom_decode_topk_clock_khz() {
  int v = 0;
  cudaDeviceGetAttribute(&v, cudaDevAttrClockRate, 0);
  return v;
}
#endif

const char* bloom_decode_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
