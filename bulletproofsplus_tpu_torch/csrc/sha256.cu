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
// rounds. The compression is sha256.cuh's, which the fs256 chain kernel
// (fs256_chain.cu) shares; the fs256 paths run that kernel, and this one
// stays as the hash of a batch of messages.
//
// What bounds it: at a few hundred messages the card is nearly idle, and a
// launch takes as long as one thread's dependent chain of compressions,
// about 4 dependent integer operations a round (the longest path runs from e
// through Σ1, the round sum and the new e), 64 rounds a block. 32-thread
// blocks spread the messages over as many SMs as there are warps.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sha256.cuh"

using namespace bpp;

namespace {

constexpr int THREADS = 32;

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

__global__ void __launch_bounds__(THREADS)
    sha256_words_kernel(const uint32_t* __restrict__ msgs, uint32_t* __restrict__ out,
                        long long B, long long nw, int nblocks) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= B) return;
  const uint32_t* m = msgs + i * nw;
  const long long total = 16LL * nblocks;
  const unsigned long long bits = (unsigned long long)nw * 32ULL;
  uint32_t st[8];
  sha::init(st);
  uint32_t w[16], next[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) w[k] = padded_word(m, k, nw, total, bits);
  for (int blk = 0; blk < nblocks; ++blk) {
    const bool more = blk + 1 < nblocks;
    if (more) {
#pragma unroll
      for (int k = 0; k < 16; ++k) next[k] = padded_word(m, 16LL * (blk + 1) + k, nw, total, bits);
    }
    sha::compress(st, w);
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
