// SHA-256 of B word-aligned messages of one byte length, one digest each:
// the hash of the fs256 Fiat-Shamir transcript (protocol/fs256.py).
//
// Replaces no Pallas kernel. The JAX package hashes fs256's transcript as
// plain jnp (bulletproofsplus_tpu/hashers_device.py::sha256_words :123, the
// compression :58-94 as two lax.scan loops that XLA fuses into the prover's
// and verifier's programs). Eager PyTorch fuses nothing: a compression there
// is some 3,000 tiny launches (48 schedule steps and 64 rounds of rotates,
// xors and adds), and the verifier's replay at K = 256 needs about 90
// compressions a proof at edwards25519 and over 400 at bls12-381, so the
// plain version (hashers_device.py::sha256_words_plain) takes seconds of
// host time where a verify takes tens of milliseconds. Here a whole batch
// of hashes is one launch.
//
// One thread hashes one message: SHA-256 is a chain of compressions, each
// depending on the last, so a message has no parallelism to spread, and the
// batch (K or 2K messages: one a proof, or a challenge's two halves) is the
// grid. Padding (FIPS 180-4 §5.1.1) is applied here from the byte length,
// so the caller passes the bare message words. A compression runs in
// registers: the state, the sixteen-word schedule window (indices fixed by
// the unrolled rounds) and the next block's sixteen words, loaded before
// the current block is compressed so their latency hides behind its 64
// rounds. Rotates are funnel shifts, the round constants sit in constant
// memory, read by every thread of a warp at once.
//
// What bounds it: at a few hundred messages the card is nearly idle, and a
// launch takes as long as one thread's dependent chain of compressions,
// about 4 dependent integer operations a round (the longest path runs from e
// through Σ1, the round sum and the new e), 64 rounds a block. 32-thread
// blocks spread the messages over as many SMs as there are warps.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 32;

__constant__ uint32_t K256[64] = {
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

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return __funnelshift_r(x, x, n); }

// Word g of the padded message of nw words in `total` words: the message,
// then 0x80000000 (the 1 bit after a word-aligned message), zeros, and the
// bit length as the last two words.
__device__ __forceinline__ uint32_t padded_word(const uint32_t* m, long long g, long long nw,
                                                long long total, unsigned long long bits) {
  if (g < nw) return m[g];
  if (g == nw) return 0x80000000u;
  if (g == total - 2) return (uint32_t)(bits >> 32);
  if (g == total - 1) return (uint32_t)bits;
  return 0u;
}

// One compression of block w (consumed: it becomes the schedule window).
__device__ __forceinline__ void compress(uint32_t st[8], uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
      w[t & 15] = wt;
    }
    const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + S1 + ch + K256[t] + wt;
    const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + S0 + maj;
  }
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
  st[4] += e;
  st[5] += f;
  st[6] += g;
  st[7] += h;
}

__global__ void __launch_bounds__(THREADS)
    sha256_words_kernel(const uint32_t* __restrict__ msgs, uint32_t* __restrict__ out,
                        long long B, long long nw, int nblocks) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= B) return;
  const uint32_t* m = msgs + i * nw;
  const long long total = 16LL * nblocks;
  const unsigned long long bits = (unsigned long long)nw * 32ULL;
  uint32_t st[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  uint32_t w[16], next[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) w[k] = padded_word(m, k, nw, total, bits);
  for (int blk = 0; blk < nblocks; ++blk) {
    const bool more = blk + 1 < nblocks;
    if (more) {
#pragma unroll
      for (int k = 0; k < 16; ++k) next[k] = padded_word(m, 16LL * (blk + 1) + k, nw, total, bits);
    }
    compress(st, w);
    if (more) {
#pragma unroll
      for (int k = 0; k < 16; ++k) w[k] = next[k];
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) out[i * 8 + k] = st[k];
}

}  // namespace

// msgs: B rows of msg_bytes / 4 big-endian words (msg_bytes a multiple of
// 4); out: B rows of 8 digest words.
extern "C" int bpp_sha256_words(const void* msgs, void* out, long long B, int msg_bytes,
                                void* stream) {
  if (B <= 0) return 0;
  if (msg_bytes < 0 || msg_bytes % 4) return (int)cudaErrorInvalidValue;
  const int nblocks = (msg_bytes + 9 + 63) / 64;
  const unsigned grid = (unsigned)((B + THREADS - 1) / THREADS);
  sha256_words_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)msgs, (uint32_t*)out, B, msg_bytes / 4, nblocks);
  return (int)cudaGetLastError();
}
