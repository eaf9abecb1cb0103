// Multi-precision Montgomery arithmetic over 8 × 32-bit words, R = 2^256.
//
// The device counterpart of fields/mont_mul.py::mont_mul_plain and
// fields/ops.py (add/sub/neg): every function takes and returns fully
// reduced values (< p), generic over any odd modulus below 2^256, which the
// caller passes in a `Mod` (a curve's base field for coordinates, its group
// order for scalars). Words are little-endian; a field element in memory is eight
// consecutive uint32 (the int32 bit patterns of the PyTorch tensors).
#pragma once

#include <cstdint>

namespace bpp {

constexpr int NL = 8;

struct Mod {
  uint32_t p[NL];
  uint32_t np0;  // -p^{-1} mod 2^32
};

__device__ __forceinline__ void fe_copy(uint32_t r[NL], const uint32_t a[NL]) {
#pragma unroll
  for (int i = 0; i < NL; ++i) r[i] = a[i];
}

__device__ __forceinline__ void fe_set_zero(uint32_t r[NL]) {
#pragma unroll
  for (int i = 0; i < NL; ++i) r[i] = 0;
}

// r = t - p if (top·2^256 + t) >= p, else t.  Requires the value < 2p.
__device__ __forceinline__ void fe_reduce_once(uint32_t r[NL], const uint32_t t[NL],
                                               uint32_t top, const Mod& M) {
  uint32_t d[NL];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    uint64_t s = (uint64_t)t[i] - M.p[i] - borrow;
    d[i] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const bool ge = (top != 0) || (borrow == 0);
#pragma unroll
  for (int i = 0; i < NL; ++i) r[i] = ge ? d[i] : t[i];
}

// r = a + b mod p.  a + b < 2p may pass 2^256 (secp256k1's moduli lie above
// 2^255): the carry out of the top word is the top bit fe_reduce_once takes.
__device__ __forceinline__ void fe_add(uint32_t r[NL], const uint32_t a[NL],
                                       const uint32_t b[NL], const Mod& M) {
  uint32_t s[NL];
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    uint64_t v = (uint64_t)a[i] + b[i] + c;
    s[i] = (uint32_t)v;
    c = (uint32_t)(v >> 32);
  }
  fe_reduce_once(r, s, c, M);
}

// r = a - b mod p.
__device__ __forceinline__ void fe_sub(uint32_t r[NL], const uint32_t a[NL],
                                       const uint32_t b[NL], const Mod& M) {
  uint32_t d[NL];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    uint64_t v = (uint64_t)a[i] - b[i] - borrow;
    d[i] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  uint32_t c = 0;
  const uint32_t mask = 0u - borrow;  // add p back only on borrow
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    uint64_t v = (uint64_t)d[i] + (M.p[i] & mask) + c;
    r[i] = (uint32_t)v;
    c = (uint32_t)(v >> 32);
  }
}

__device__ __forceinline__ void fe_neg(uint32_t r[NL], const uint32_t a[NL], const Mod& M) {
  uint32_t z[NL];
  fe_set_zero(z);
  fe_sub(r, z, a, M);
}

// r = a·b·2^-256 mod p: word-serial CIOS Montgomery multiplication
// (Koc et al. 1996), 32×32→64 multiplies; the result before the final
// conditional subtraction is < 2p.  r may alias a or b.
__device__ __forceinline__ void fe_mul(uint32_t r[NL], const uint32_t a[NL],
                                       const uint32_t b[NL], const Mod& M) {
  uint32_t t[NL + 2];
#pragma unroll
  for (int i = 0; i < NL + 2; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[NL] + c;
    t[NL] = (uint32_t)s;
    t[NL + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * M.np0;
    s = (uint64_t)m * M.p[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < NL; ++j) {
      s = (uint64_t)m * M.p[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[NL] + c;
    t[NL - 1] = (uint32_t)s;
    t[NL] = t[NL + 1] + (uint32_t)(s >> 32);
  }
  fe_reduce_once(r, t, t[NL], M);
}

}  // namespace bpp
