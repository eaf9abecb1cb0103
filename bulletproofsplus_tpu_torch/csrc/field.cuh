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
//
// The carries run through PTX's condition code: the word primitives below
// are one add.cc / addc / sub.cc / mad.lo.cc / madc.hi.cc instruction each,
// each its own `asm volatile` statement, so nvcc keeps them in program order
// and nothing between two of them touches the carry flag (ptxas then
// schedules the independent chains of a product side by side). Each
// primitive also has a portable C body under `#ifndef __CUDA_ARCH__`, with
// the carry held in the `Carry` the caller threads through; nvcc's device
// pass never compiles those bodies. They exist so that the kernels can be
// compiled and run on a host with g++ against the plain versions (a
// rehearsal without a card), and are no fallback of the device build.
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

// -- word primitives --------------------------------------------------------
// `_cc` sets the carry (borrow) flag, `c` reads it: addc_cc(a, b) is
// a + b + carry and leaves the new carry. On the card the flag is PTX's
// condition code and `Carry` is empty.
#ifdef __CUDA_ARCH__
struct Carry {};
#define BPP_OP2(name, ins)                                                          \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b, Carry&) {        \
    uint32_t r;                                                                     \
    asm volatile(ins " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));                    \
    return r;                                                                       \
  }
#define BPP_OP3(name, ins)                                                          \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b, uint32_t c, Carry&) { \
    uint32_t r;                                                                     \
    asm volatile(ins " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));        \
    return r;                                                                       \
  }
BPP_OP2(add_cc, "add.cc.u32")
BPP_OP2(addc_cc, "addc.cc.u32")
BPP_OP2(addc, "addc.u32")
BPP_OP2(sub_cc, "sub.cc.u32")
BPP_OP2(subc_cc, "subc.cc.u32")
BPP_OP2(subc, "subc.u32")
BPP_OP3(mad_lo_cc, "mad.lo.cc.u32")
BPP_OP3(madc_lo_cc, "madc.lo.cc.u32")
BPP_OP3(madc_hi_cc, "madc.hi.cc.u32")
#undef BPP_OP2
#undef BPP_OP3
#else
struct Carry {
  uint32_t c = 0;
};
#define BPP_OP(name, params, value, sets)                                           \
  __device__ __forceinline__ uint32_t name params {                                 \
    const uint64_t v = value;                                                       \
    if (sets) cc.c = (uint32_t)(v >> 32) & 1u;                                      \
    return (uint32_t)v;                                                             \
  }
#define BPP_HI(a, b) (((uint64_t)(a) * (b)) >> 32)
#define BPP_LO(a, b) (uint32_t)((uint64_t)(a) * (b))
BPP_OP(add_cc, (uint32_t a, uint32_t b, Carry& cc), (uint64_t)a + b, true)
BPP_OP(addc_cc, (uint32_t a, uint32_t b, Carry& cc), (uint64_t)a + b + cc.c, true)
BPP_OP(addc, (uint32_t a, uint32_t b, Carry& cc), (uint64_t)a + b + cc.c, false)
// a borrow is bit 32 of the 64-bit difference (1 exactly when it wraps)
BPP_OP(sub_cc, (uint32_t a, uint32_t b, Carry& cc), (uint64_t)a - b, true)
BPP_OP(subc_cc, (uint32_t a, uint32_t b, Carry& cc), (uint64_t)a - b - cc.c, true)
BPP_OP(subc, (uint32_t a, uint32_t b, Carry& cc), (uint64_t)a - b - cc.c, false)
BPP_OP(mad_lo_cc, (uint32_t a, uint32_t b, uint32_t c, Carry& cc),
       (uint64_t)BPP_LO(a, b) + c, true)
BPP_OP(madc_lo_cc, (uint32_t a, uint32_t b, uint32_t c, Carry& cc),
       (uint64_t)BPP_LO(a, b) + c + cc.c, true)
BPP_OP(madc_hi_cc, (uint32_t a, uint32_t b, uint32_t c, Carry& cc),
       BPP_HI(a, b) + c + cc.c, true)
#undef BPP_OP
#undef BPP_HI
#undef BPP_LO
#endif

__device__ __forceinline__ uint32_t mul_hi(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) >> 32);
}

// -- field operations -------------------------------------------------------

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

// r = t - p if top·R + t >= p, else t.  Requires top ∈ {0, 1} and the
// value < 2p.
template <int N>
__device__ __forceinline__ void fe_reduce_once(uint32_t* r, const uint32_t* t, uint32_t top,
                                               const Mod<N>& M) {
  Carry cc;
  uint32_t d[N];
  d[0] = sub_cc(t[0], M.p[0], cc);
#pragma unroll
  for (int i = 1; i < N; ++i) d[i] = subc_cc(t[i], M.p[i], cc);
  // top - borrow is 2^32 - 1 exactly when top·R + t < p
  const bool below = (int32_t)subc(top, 0, cc) < 0;
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = below ? t[i] : d[i];
}

// r = a + b mod p.  a + b < 2p may pass R (secp256k1's moduli lie above
// 2^255): the carry out of the top word is the top fe_reduce_once takes.
template <int N>
__device__ __forceinline__ void fe_add(uint32_t* r, const uint32_t* a, const uint32_t* b,
                                       const Mod<N>& M) {
  Carry cc;
  uint32_t s[N];
  s[0] = add_cc(a[0], b[0], cc);
#pragma unroll
  for (int i = 1; i < N; ++i) s[i] = addc_cc(a[i], b[i], cc);
  fe_reduce_once(r, s, addc(0, 0, cc), M);
}

// r = a - b mod p: p is added back when the difference borrows.
template <int N>
__device__ __forceinline__ void fe_sub(uint32_t* r, const uint32_t* a, const uint32_t* b,
                                       const Mod<N>& M) {
  Carry cc;
  uint32_t d[N];
  d[0] = sub_cc(a[0], b[0], cc);
#pragma unroll
  for (int i = 1; i < N; ++i) d[i] = subc_cc(a[i], b[i], cc);
  const uint32_t mask = subc(0, 0, cc);  // 2^32 - 1 on borrow, else 0
  r[0] = add_cc(d[0], M.p[0] & mask, cc);
#pragma unroll
  for (int i = 1; i < N - 1; ++i) r[i] = addc_cc(d[i], M.p[i] & mask, cc);
  r[N - 1] = addc(d[N - 1], M.p[N - 1] & mask, cc);
}

template <int N>
__device__ __forceinline__ void fe_neg(uint32_t* r, const uint32_t* a, const Mod<N>& M) {
  uint32_t z[N];
  fe_set_zero(z);
  fe_sub(r, z, a, M);
}

// One CIOS reduction step on the split accumulator of fe_mul: x[0] becomes
// 0.  T = x + 2^32·y + 2^(32(N+1))·hb gains m·p, m = x[0]·(-p^-1) mod 2^32;
// the odd words of p go into y and the even ones into x, two independent
// carry chains, each carry out kept (into y's top word and hb).
template <int N>
__device__ __forceinline__ void mont_reduce_step(uint32_t (&x)[N], uint32_t (&y)[N],
                                                 uint32_t& hb, const Mod<N>& M, Carry& cc) {
  const uint32_t m = x[0] * M.np0;
  y[0] = mad_lo_cc(M.p[1], m, y[0], cc);
  y[1] = madc_hi_cc(M.p[1], m, y[1], cc);
#pragma unroll
  for (int j = 2; j < N; j += 2) {
    y[j] = madc_lo_cc(M.p[j + 1], m, y[j], cc);
    y[j + 1] = madc_hi_cc(M.p[j + 1], m, y[j + 1], cc);
  }
  hb = addc(hb, 0, cc);
  x[0] = mad_lo_cc(M.p[0], m, x[0], cc);
  x[1] = madc_hi_cc(M.p[0], m, x[1], cc);
#pragma unroll
  for (int j = 2; j < N; j += 2) {
    x[j] = madc_lo_cc(M.p[j], m, x[j], cc);
    x[j + 1] = madc_hi_cc(M.p[j], m, x[j + 1], cc);
  }
  y[N - 1] = addc_cc(y[N - 1], 0, cc);
  hb = addc(hb, 0, cc);
}

// r = a·b·R^-1 mod p: word-serial CIOS Montgomery multiplication (Koc et
// al. 1996) with the reduction interleaved, a < p.  The running sum T (< 2p
// between rows) is split in two: x holds the words at even offsets of each
// row's products (a[j]·b[i] for even j: low word at j, high at j + 1) and y,
// one word up, those at odd offsets, so each row is two independent carry
// chains of N multiply-adds, and the same for m·p.  The one-word shift of a
// row swaps the halves: y becomes the new x (plus x[1] at word 0, whose
// carry enters the next chain), x from word 2 on the new y.  hb keeps the
// bit above word N + 1 that moduli above 2^(32N-1) (secp256k1's) can set.
// The result is fully reduced, word for word that of mont_mul_plain.
// r may alias a or b.
template <int N>
__device__ __forceinline__ void fe_mul(uint32_t* r, const uint32_t* a, const uint32_t* b,
                                       const Mod<N>& M) {
  static_assert(N % 2 == 0, "the even/odd split needs an even word count");
  Carry cc;
  uint32_t x[N], y[N], hb = 0;
#pragma unroll
  for (int j = 0; j < N; j += 2) {  // row 0: products in place, no carries
    x[j] = a[j] * b[0];
    x[j + 1] = mul_hi(a[j], b[0]);
    y[j] = a[j + 1] * b[0];
    y[j + 1] = mul_hi(a[j + 1], b[0]);
  }
  mont_reduce_step(x, y, hb, M, cc);
#pragma unroll
  for (int i = 1; i < N; ++i) {
    const uint32_t bi = b[i];
    uint32_t nx[N], ny[N];
    nx[0] = add_cc(y[0], x[1], cc);
#pragma unroll
    for (int j = 0; j < N - 2; j += 2) {  // odd products + (x >> 64), carry of nx[0] in
      ny[j] = madc_lo_cc(a[j + 1], bi, x[j + 2], cc);
      ny[j + 1] = madc_hi_cc(a[j + 1], bi, x[j + 3], cc);
    }
    ny[N - 2] = madc_lo_cc(a[N - 1], bi, 0, cc);
    ny[N - 1] = madc_hi_cc(a[N - 1], bi, hb, cc);
    hb = addc(0, 0, cc);
    nx[0] = mad_lo_cc(a[0], bi, nx[0], cc);  // even products + y
    nx[1] = madc_hi_cc(a[0], bi, y[1], cc);
#pragma unroll
    for (int j = 2; j < N; j += 2) {
      nx[j] = madc_lo_cc(a[j], bi, y[j], cc);
      nx[j + 1] = madc_hi_cc(a[j], bi, y[j + 1], cc);
    }
    ny[N - 1] = addc_cc(ny[N - 1], 0, cc);
    hb = addc(hb, 0, cc);
    fe_copy(x, nx);
    fe_copy(y, ny);
    mont_reduce_step(x, y, hb, M, cc);
  }
  // T / 2^32 = x[1..N-1] + y + 2^(32N)·hb, < 2p
  uint32_t t[N];
  t[0] = add_cc(y[0], x[1], cc);
#pragma unroll
  for (int j = 1; j < N - 1; ++j) t[j] = addc_cc(y[j], x[j + 1], cc);
  t[N - 1] = addc_cc(y[N - 1], 0, cc);
  fe_reduce_once(r, t, addc(hb, 0, cc), M);
}

}  // namespace bpp
