// The SHA-256 compression (FIPS 180-4 §6.2.2), shared by the hash kernel
// (sha256.cu) and the fs256 chain kernel (fs256_chain.cu): the one
// compression of the tree, whole or split in two.
//
// A compression runs in registers: the state, the sixteen-word schedule
// window and the 64 rounds, unrolled through a template parameter, so every
// index into the window is known when the kernel is compiled and every
// round constant is an immediate of its round's add (reading them from
// constant memory measured 4-7 % slower). Rotates are funnel shifts.
//
// On the card a round's integer operations (14: six rotates, four
// three-input logic ops, four adds; and 10 a schedule step) issue from one
// warp on one scheduler, whose integer pipe takes a warp's instruction every
// other cycle, so a lone warp's compression is bound by issue (about 1,400
// operations a block), not by the round's dependent path (3 operations).
// Split in two, a block's message schedule (W_t + K_t for its 64 rounds,
// `schedule_wk`) runs on another warp, on another scheduler, and the
// rounds (`compress_wk`) read it from shared memory: the chain's warp then
// issues about 900 integer operations a block instead of 1,400.
#pragma once

#include <cstdint>
#include <utility>

namespace bpp {
namespace sha {

constexpr uint32_t ROUND_K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1, 0x923f82a4,
    0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe,
    0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc, 0x2de92c6f,
    0x4a7484aa, 0x5cb0a9dc, 0x76f988da, 0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7,
    0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc,
    0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070, 0x19a4c116,
    0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
    0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208, 0x90befffa, 0xa4506ceb, 0xbef9a3f7,
    0xc67178f2};

// Round constant t as a constant expression (device code may read a host
// constexpr array only so).
__host__ __device__ constexpr uint32_t round_k(int t) { return ROUND_K[t]; }

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(x, x, n);
#else
  return (x >> n) | (x << (32 - n));
#endif
}

// §5.3.3's initial hash value.
__device__ __forceinline__ void init(uint32_t (&s)[8]) {
  s[0] = 0x6a09e667u; s[1] = 0xbb67ae85u; s[2] = 0x3c6ef372u; s[3] = 0xa54ff53au;
  s[4] = 0x510e527fu; s[5] = 0x9b05688cu; s[6] = 0x1f83d9abu; s[7] = 0x5be0cd19u;
}

template <int T>
struct RoundK {
  static constexpr uint32_t value = round_k(T);
};

// W_T of the block whose window is w: word T for T < 16, else the
// schedule step, which replaces word T & 15 of the window.
template <int T>
__device__ __forceinline__ uint32_t schedule_word(uint32_t (&w)[16]) {
  if constexpr (T < 16) {
    return w[T];
  } else {
    const uint32_t w15 = w[(T - 15) & 15], w2 = w[(T - 2) & 15];
    const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
    const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
    const uint32_t wt = w[T & 15] + s0 + w[(T - 7) & 15] + s1;
    w[T & 15] = wt;
    return wt;
  }
}

// One round on v = (a, ..., h) with wk = W_t + K_t.
__device__ __forceinline__ void round_core(uint32_t (&v)[8], uint32_t wk) {
  const uint32_t a = v[0], b = v[1], c = v[2], e = v[4], f = v[5], g = v[6];
  const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
  const uint32_t ch = (e & f) ^ (~e & g);
  const uint32_t t1 = v[7] + S1 + ch + wk;
  const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
  const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
  v[7] = g;
  v[6] = f;
  v[5] = e;
  v[4] = v[3] + t1;
  v[3] = c;
  v[2] = b;
  v[1] = a;
  v[0] = t1 + S0 + maj;
}

template <int... T>
__device__ __forceinline__ void rounds(uint32_t (&v)[8], uint32_t (&w)[16],
                                       std::integer_sequence<int, T...>) {
  (round_core(v, schedule_word<T>(w) + RoundK<T>::value), ...);
}

template <int STRIDE, int... T>
__device__ __forceinline__ void rounds_wk(uint32_t (&v)[8], const uint32_t* wk,
                                          std::integer_sequence<int, T...>) {
  (round_core(v, wk[T * STRIDE]), ...);
}

template <int STRIDE, int... T>
__device__ __forceinline__ void schedule_all(uint32_t (&w)[16], uint32_t* wk,
                                             std::integer_sequence<int, T...>) {
  ((wk[T * STRIDE] = schedule_word<T>(w) + RoundK<T>::value), ...);
}

// One compression of block w into st (w is consumed: it becomes the
// schedule window).
__device__ __forceinline__ void compress(uint32_t (&st)[8], uint32_t (&w)[16]) {
  uint32_t v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = st[i];
  rounds(v, w, std::make_integer_sequence<int, 64>{});
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] += v[i];
}

// The first half of a split compression: W_t + K_t of block w (consumed)
// into wk[t * STRIDE], t < 64.
template <int STRIDE>
__device__ __forceinline__ void schedule_wk(uint32_t (&w)[16], uint32_t* wk) {
  schedule_all<STRIDE>(w, wk, std::make_integer_sequence<int, 64>{});
}

// The second half: the 64 rounds into st from wk[t * STRIDE].
template <int STRIDE>
__device__ __forceinline__ void compress_wk(uint32_t (&st)[8], const uint32_t* wk) {
  uint32_t v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = st[i];
  rounds_wk<STRIDE>(v, wk, std::make_integer_sequence<int, 64>{});
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] += v[i];
}

}  // namespace sha
}  // namespace bpp
