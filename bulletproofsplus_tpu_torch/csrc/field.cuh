// Multi-precision Montgomery arithmetic over N × 32-bit words, R = 2^(32N).
//
// The device counterpart of fields/mont_mul.py::mont_mul_plain and
// fields/ops.py (add/sub/neg): every function takes and returns fully
// reduced values (< p), generic over any odd modulus below 2^(32N), which
// the caller passes in a `Mod<N>` (a curve's base field for coordinates, its
// group order for scalars). N is a template parameter, deduced from the
// `Mod`: 8 words (R = 2^256) for every scalar field and the 256-bit base
// fields, 12 (R = 2^384) for bls12-381's 381-bit Fq. Words are
// little-endian; a field element in memory is N consecutive uint32 (the
// int32 bit patterns of the PyTorch tensors).
#pragma once

#include <cstdint>

namespace bpp {

// Words of a scalar: every curve's group order lies below 2^256, so the
// kernels read scalars at this width whatever the width of a coordinate.
constexpr int SW = 8;

template <int N>
struct Mod {
  uint32_t p[N];
  uint32_t np0;  // -p^{-1} mod 2^32
};

template <int N>
__device__ __forceinline__ void fe_copy(uint32_t (&r)[N], const uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = a[i];
}

template <int N>
__device__ __forceinline__ void fe_set_zero(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0;
}

// r = t - p if (top·R + t) >= p, else t.  Requires the value < 2p.
template <int N>
__device__ __forceinline__ void fe_reduce_once(uint32_t* r, const uint32_t* t, uint32_t top,
                                               const Mod<N>& M) {
  uint32_t d[N];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t s = (uint64_t)t[i] - M.p[i] - borrow;
    d[i] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const bool ge = (top != 0) || (borrow == 0);
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = ge ? d[i] : t[i];
}

// r = a + b mod p.  a + b < 2p may pass R (secp256k1's moduli lie above
// 2^255): the carry out of the top word is the top bit fe_reduce_once takes.
template <int N>
__device__ __forceinline__ void fe_add(uint32_t* r, const uint32_t* a, const uint32_t* b,
                                       const Mod<N>& M) {
  uint32_t s[N];
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t v = (uint64_t)a[i] + b[i] + c;
    s[i] = (uint32_t)v;
    c = (uint32_t)(v >> 32);
  }
  fe_reduce_once(r, s, c, M);
}

// r = a - b mod p.
template <int N>
__device__ __forceinline__ void fe_sub(uint32_t* r, const uint32_t* a, const uint32_t* b,
                                       const Mod<N>& M) {
  uint32_t d[N];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t v = (uint64_t)a[i] - b[i] - borrow;
    d[i] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  uint32_t c = 0;
  const uint32_t mask = 0u - borrow;  // add p back only on borrow
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t v = (uint64_t)d[i] + (M.p[i] & mask) + c;
    r[i] = (uint32_t)v;
    c = (uint32_t)(v >> 32);
  }
}

template <int N>
__device__ __forceinline__ void fe_neg(uint32_t* r, const uint32_t* a, const Mod<N>& M) {
  uint32_t z[N];
  fe_set_zero(z);
  fe_sub(r, z, a, M);
}

// r = a·b·R^-1 mod p: word-serial CIOS Montgomery multiplication
// (Koc et al. 1996), 32×32→64 multiplies; the result before the final
// conditional subtraction is < 2p.  r may alias a or b.
template <int N>
__device__ __forceinline__ void fe_mul(uint32_t* r, const uint32_t* a, const uint32_t* b,
                                       const Mod<N>& M) {
  uint32_t t[N + 2];
#pragma unroll
  for (int i = 0; i < N + 2; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[N] + c;
    t[N] = (uint32_t)s;
    t[N + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * M.np0;
    s = (uint64_t)m * M.p[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < N; ++j) {
      s = (uint64_t)m * M.p[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[N] + c;
    t[N - 1] = (uint32_t)s;
    t[N] = t[N + 1] + (uint32_t)(s >> 32);
  }
  fe_reduce_once(r, t, t[N], M);
}

}  // namespace bpp
