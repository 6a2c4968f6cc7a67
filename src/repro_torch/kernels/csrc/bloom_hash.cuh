// The enhanced double hash of core/hashing.double_hash in uint32
// arithmetic, for kernels that re-derive an id's k hash indices instead of
// reading a hash matrix (csrc/bloom_embed.cu, csrc/bloom_decode_topk.cu):
//     h1 = splitmix32(i ^ c1) % m,  h2 = splitmix32(i ^ c2) % max(m-1, 1) + 1
//     h_j = (h1 + j*h2 + ((j^3 - j)/6 % m)) % m
// with the salts c1, c2 of hashing.double_hash_salts and the remainders by
// m and max(m-1, 1) taken by multiply-shift (kernels/common.magic_divisor).
#pragma once

#include <stdint.h>

namespace bloom_hash {

__device__ __forceinline__ unsigned splitmix32(unsigned z) {
  z += 0x9E3779B9u;
  z = (z ^ (z >> 16)) * 0x85EBCA6Bu;
  z = (z ^ (z >> 13)) * 0xC2B2AE35u;
  return z ^ (z >> 16);
}

// n % d for every uint32 n, from (mp, sh = sh1 | sh2 << 8) of
// kernels/common.magic_divisor
__device__ __forceinline__ unsigned fastmod(unsigned n, unsigned d,
                                            unsigned mp, unsigned sh) {
  const unsigned t = __umulhi(n, mp);
  const unsigned q = (t + ((n - t) >> (sh & 0xffu))) >> (sh >> 8);
  return n - q * d;
}

// The constants of one spec's hash: the salts and the remainder constants
// of m and max(m - 1, 1).
struct Spec {
  unsigned c1, c2, m, mp_m, sh_m, mp_m1, sh_m1;
};

// h1 and h2 of id i (any uint32: a negative id hashes by its bit pattern)
__device__ __forceinline__ void h1h2(const Spec& s, unsigned i, unsigned* h1,
                                     unsigned* h2) {
  const unsigned m1 = s.m > 1 ? s.m - 1 : 1;
  *h1 = fastmod(splitmix32(i ^ s.c1), s.m, s.mp_m, s.sh_m);
  *h2 = fastmod(splitmix32(i ^ s.c2), m1, s.mp_m1, s.sh_m1) + 1u;
}

// h_j from h1, h2 by the formula, wrapping in uint32 as double_hash does,
// so it holds for every m < 2^32 and every j.
__device__ __forceinline__ unsigned hash_j(const Spec& s, unsigned h1,
                                           unsigned h2, unsigned j) {
  const unsigned long long jj = j;
  const unsigned long long t = (jj * jj * jj - jj) / 6;
  const unsigned tri = (unsigned)(t < s.m ? t : t % s.m);
  return fastmod(h1 + j * h2 + tri, s.m, s.mp_m, s.sh_m);
}

}  // namespace bloom_hash
