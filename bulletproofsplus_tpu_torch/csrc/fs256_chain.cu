// The fs256 Fiat-Shamir chain of K transcripts in one launch: every absorb,
// every challenge's state step, both halves of its 512-bit digest and the
// digest's reduction into the scalar field, from each transcript's own start
// state and counter (protocol/fs256.py, hashers_device.py::fs256_chain).
//
// Replaces no Pallas kernel. The JAX package runs the chain as XLA-fused jnp
// (bulletproofsplus_tpu/protocol/fs256.py, over hashers_device.py's
// sha256_words :123 and digest_to_field_mont :209). Eager PyTorch fuses
// nothing: as SHA-256 launches (sha256.cu) with field launches and torch
// ops between them, a challenge took 2 hash launches, 2 field launches and
// 7 torch ops, and the verifier's replay 184-240 launches whose host time
// the card idled through. Here the whole replay is one launch.
//
// The byte protocol is transcript.py::Fs256Transcript's, word for word:
//   absorb:    state = SHA256(state ‖ tag ‖ the step's coordinate rows)
//   challenge: state = SHA256(state ‖ "chal" ‖ tag ‖ be32(counter));
//              c = SHA256(state ‖ be32(1)) ‖ SHA256(state ‖ be32(2)) mod p,
//              0 mapped to 1.
// Each message is built in registers from the state, the tag, the counter
// and the transcript's row of coordinate words, and padded from its byte
// length: no message is ever written to memory.
//
// The reduction: with the digest's halves hi and lo as 256-bit numbers
// (their words reversed into little-endian limbs, each below R = 2^256),
// the Montgomery form of hi·2^256 + lo is
//   fe_mul(c_hi, hi) + fe_mul(c_lo, lo),  c_hi = 2^256·R² mod p, c_lo = R² mod p,
// two of field.cuh's products (constant first: with a < p and any b < R the
// CIOS sum stays below 2p) and one add, where the plain version takes 16
// products against 2^{32(15-j)}·R² and a sum. The result is fully reduced,
// so it equals the plain version word for word.
//
// Design for the card. A transcript is one dependent sequence of
// compressions (about 90 / 150 / 500 blocks at K = 256 on edwards25519 /
// secp256k1 / bls12-381), so the launch is bound by one warp's issue of
// that chain, not by the card's rate; K transcripts spread over the SMs,
// sixteen to a block of two warps.
//
// - Two lanes a transcript. An aligned pair of lanes runs the shared chain
//   in lockstep (the same instructions on the same data: no cost over one
//   lane); then lane h hashes half h + 1 and takes its one product, and one
//   __shfl_xor_sync and a field add join the two. A challenge's critical
//   path is 2 compressions and 1 product, not 3 and 2. Lanes past K copy
//   transcript K - 1, so every lane reaches the full-mask shuffle and every
//   barrier; only live lanes store.
// - A producer warp. Warp 0 runs the chain; warp 1, on another scheduler,
//   runs ahead through every absorb's blocks after the first (those hold
//   only coordinate words and padding, known before the chain reaches
//   them) and writes each one's W_t + K_t to a shared-memory slot,
//   lane-major so every access is conflict-free; the chain's warp takes
//   the rounds alone (sha::compress_wk), some 900 integer operations a
//   block instead of 1,400. Two slots and four named barriers (a slot full,
//   a slot empty) pace the pair: the producer refills a slot only after the
//   chain has released it, and the chain releases only slots the producer
//   will refill, so every barrier phase meets its 64 threads. An absorb's
//   first block (it holds the state), the challenges and the halves stay
//   whole on the chain's warp.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"
#include "sha256.cuh"

using namespace bpp;

#ifndef __CUDA_ARCH__
// A host build of the kernels (g++, no card) supplies the named barriers.
__device__ void bpp_host_barrier(int id, int threads, bool wait);
#endif

namespace {

constexpr int WARP = 32;
constexpr int MAX_STEPS = 64;
constexpr int MAX_CHAL = 2;
// a step's words in the schedule argument: absorb (0/1), tag, row0, nrows,
// nchal, then (tag, counter offset) per challenge
constexpr int STEP_WORDS = 5 + 2 * MAX_CHAL;
constexpr int FIELD_WORDS = 4 * SW + 1;   // p, -p^-1 mod 2^32, c_hi, c_lo, one
constexpr uint32_t CHAL = 0x6368616cu;    // "chal"

struct Step {
  int absorb, row0, nrows, nchal;
  uint32_t tag;
  uint32_t ctag[MAX_CHAL];
  int coff[MAX_CHAL];
};

struct Schedule {
  int nsteps;
  Step s[MAX_STEPS];
};

struct Field {
  Mod<SW> M;
  uint32_t c_hi[SW], c_lo[SW], one[SW];
};

// The producer's shared-memory handoff, seen by one lane: slot s's
// W_t + K_t at wk[(s · 64 + t) · WARP]; `fill` counts the blocks passed so
// far, `fills` those of the whole schedule.
struct Pipe {
  uint32_t* wk;
  int slot, fill, fills;
};

constexpr int FULL = 1, EMPTY = 3;    // named barrier ids, + slot (0 is __syncthreads')

// Wait at named barrier `id` until `threads` threads have reached it.
__device__ __forceinline__ void bar_sync(int id, int threads) {
#ifdef __CUDA_ARCH__
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
#else
  bpp_host_barrier(id, threads, true);
#endif
}

// Count this warp at named barrier `id` without waiting.
__device__ __forceinline__ void bar_arrive(int id, int threads) {
#ifdef __CUDA_ARCH__
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
#else
  bpp_host_barrier(id, threads, false);
#endif
}

// Blocks of an absorb of n coordinate words.
__host__ __device__ __forceinline__ int absorb_blocks(int n) { return (4 * (9 + n) + 9 + 63) / 64; }

// Word g >= 9 of the padded absorb message of nw words in `total` (a
// multiple of 16): the coordinate words, 0x80000000, zeros, and the bit
// length as the last word (the one before it, its high half, is 0).
__device__ __forceinline__ uint32_t absorb_word(const uint32_t* __restrict__ rest, int g,
                                                int nw, int total) {
  if (g < nw) return rest[g - 9];
  if (g == nw) return 0x80000000u;
  if (g == total - 1) return (uint32_t)(32 * nw);
  return 0u;
}

// Words [g0, g0 + 16) of that message into b: straight loads where all of
// them are coordinate words.
__device__ __forceinline__ void load_block(uint32_t (&b)[16], const uint32_t* __restrict__ rest,
                                           int g0, int nw, int total) {
  if (g0 + 16 <= nw) {
#pragma unroll
    for (int k = 0; k < 16; ++k) b[k] = rest[g0 - 9 + k];
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k) b[k] = absorb_word(rest, g0 + k, nw, total);
  }
}

// st = SHA256(st ‖ tag ‖ rest[0, n)): the first block here, the rest from
// the producer's schedules.
__device__ __forceinline__ void absorb(uint32_t (&st)[8], uint32_t tag,
                                       const uint32_t* __restrict__ rest, int n, Pipe& p) {
  const int nw = 9 + n;
  const int nblocks = absorb_blocks(n);
  uint32_t a[16];
#pragma unroll
  for (int k = 0; k < 16; ++k)
    a[k] = k < 8 ? st[k] : k == 8 ? tag : absorb_word(rest, k, nw, 16 * nblocks);
  sha::init(st);
  sha::compress(st, a);
  for (int blk = 1; blk < nblocks; ++blk) {
    bar_sync(FULL + p.slot, 2 * WARP);
    sha::compress_wk<WARP>(st, p.wk + p.slot * 64 * WARP);
    if (p.fill < p.fills - 2) bar_arrive(EMPTY + p.slot, 2 * WARP);
    p.slot ^= 1;
    ++p.fill;
  }
}

// The producer warp: every absorb's blocks after the first, in the chain's
// order, each block's W_t + K_t into the next slot once the chain has
// released it (the first two slots are free).
__device__ __forceinline__ void produce(const Schedule& sc, const uint32_t* __restrict__ mine,
                                        int row_words, Pipe& p) {
  for (int s = 0; s < sc.nsteps; ++s) {
    if (!sc.s[s].absorb) continue;
    const uint32_t* rest = mine + (long long)sc.s[s].row0 * row_words;
    const int n = sc.s[s].nrows * row_words;
    const int nblocks = absorb_blocks(n);
    for (int blk = 1; blk < nblocks; ++blk) {
      uint32_t w[16];
      load_block(w, rest, 16 * blk, 9 + n, 16 * nblocks);
      if (p.fill >= 2) bar_sync(EMPTY + p.slot, 2 * WARP);
      sha::schedule_wk<WARP>(w, p.wk + p.slot * 64 * WARP);
      __threadfence_block();
      bar_arrive(FULL + p.slot, 2 * WARP);
      p.slot ^= 1;
      ++p.fill;
    }
  }
}

// d = SHA256(st ‖ be32(i)), a 36-byte message.
__device__ __forceinline__ void half_digest(uint32_t (&d)[8], const uint32_t (&st)[8],
                                            uint32_t i) {
  uint32_t w[16] = {st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
                    i, 0x80000000u, 0u, 0u, 0u, 0u, 0u, 36u * 8u};
  sha::init(d);
  sha::compress(d, w);
}

// r = fe_mul(c, d as a little-endian 256-bit number): d·c·R^-1 mod p.
__device__ __forceinline__ void weigh(uint32_t (&r)[SW], const uint32_t (&d)[8],
                                      const uint32_t (&c)[SW], const Mod<SW>& M) {
  uint32_t x[SW];
#pragma unroll
  for (int i = 0; i < SW; ++i) x[i] = d[SW - 1 - i];
  fe_mul(r, c, x, M);
}

__global__ void __launch_bounds__(2 * WARP)
    chain_kernel(const uint32_t* __restrict__ start, const int32_t* __restrict__ base,
                 const uint32_t* __restrict__ cw, uint32_t* __restrict__ chal,
                 uint32_t* __restrict__ state_out, long long K, int rows, int row_words,
                 int nchal, int fills, Schedule sc, Field F) {
  __shared__ uint32_t wk[2 * 64 * WARP];
  const int l = threadIdx.x % WARP;
  const long long lane = (long long)blockIdx.x * WARP + l;
  const bool live = lane / 2 < K;
  const long long k = live ? lane / 2 : K - 1;
  const uint32_t half = (uint32_t)(l & 1);
  const uint32_t* mine = cw + k * rows * row_words;
  Pipe p{wk + l, 0, 0, fills};
  if (threadIdx.x >= WARP) {
    produce(sc, mine, row_words, p);
    return;
  }
  uint32_t st[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = start[k * 8 + i];
  const uint32_t ctr = base ? (uint32_t)base[k] : 0u;
  int out = 0;
  for (int s = 0; s < sc.nsteps; ++s) {
    if (sc.s[s].absorb)
      absorb(st, sc.s[s].tag, mine + (long long)sc.s[s].row0 * row_words,
             sc.s[s].nrows * row_words, p);
    for (int c = 0; c < sc.s[s].nchal; ++c) {
      uint32_t w[16] = {st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], CHAL,
                        sc.s[s].ctag[c], ctr + (uint32_t)sc.s[s].coff[c], 0x80000000u,
                        0u, 0u, 0u, 44u * 8u};
      sha::init(st);
      sha::compress(st, w);
      uint32_t e[SW], d[8], cst[SW], other[SW];
      half_digest(d, st, half + 1);
#pragma unroll
      for (int i = 0; i < SW; ++i) cst[i] = half ? F.c_lo[i] : F.c_hi[i];
      weigh(e, d, cst, F.M);
#pragma unroll
      for (int i = 0; i < SW; ++i) other[i] = __shfl_xor_sync(0xffffffffu, e[i], 1);
      fe_add(e, e, other, F.M);
      uint32_t any = 0;
#pragma unroll
      for (int i = 0; i < SW; ++i) any |= e[i];
      if (live && half == 0) {
#pragma unroll
        for (int i = 0; i < SW; ++i) chal[(k * nchal + out) * SW + i] = any ? e[i] : F.one[i];
      }
      ++out;
    }
  }
  if (live && half == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) state_out[k * 8 + i] = st[i];
  }
}

}  // namespace

// start: K rows of 8 state words; base: K int32 counters or null (all 0);
// cw: K × rows × row_words coordinate words; chal: K × (the schedule's
// challenges) × 8 Montgomery words; state_out: K × 8. sched: nsteps ×
// STEP_WORDS words; field: FIELD_WORDS words (p, -p^-1 mod 2^32, c_hi, c_lo,
// R mod p).
extern "C" int bpp_fs256_chain(const void* start, const void* base, const void* cw, void* chal,
                               void* state_out, long long K, int rows, int row_words,
                               const uint32_t* sched, int nsteps, const uint32_t* field,
                               void* stream) {
  if (K <= 0 || rows < 0 || row_words < 0 || nsteps < 0 || nsteps > MAX_STEPS)
    return (int)cudaErrorInvalidValue;
  Schedule sc;
  sc.nsteps = nsteps;
  int nchal = 0, fills = 0;
  for (int i = 0; i < nsteps; ++i) {
    const uint32_t* w = sched + i * STEP_WORDS;
    Step& st = sc.s[i];
    st.absorb = (int)w[0];
    st.tag = w[1];
    st.row0 = (int)w[2];
    st.nrows = (int)w[3];
    st.nchal = (int)w[4];
    if (st.row0 < 0 || st.nrows < 0 || st.row0 + st.nrows > rows || st.nchal < 0 ||
        st.nchal > MAX_CHAL)
      return (int)cudaErrorInvalidValue;
    for (int c = 0; c < MAX_CHAL; ++c) {
      st.ctag[c] = w[5 + 2 * c];
      st.coff[c] = (int)w[6 + 2 * c];
    }
    nchal += st.nchal;
    if (st.absorb) fills += absorb_blocks(st.nrows * row_words) - 1;
  }
  Field F;
  for (int i = 0; i < SW; ++i) {
    F.M.p[i] = field[i];
    F.c_hi[i] = field[SW + 1 + i];
    F.c_lo[i] = field[2 * SW + 1 + i];
    F.one[i] = field[3 * SW + 1 + i];
  }
  F.M.np0 = field[SW];
  const unsigned grid = (unsigned)((2 * K + WARP - 1) / WARP);
  chain_kernel<<<grid, 2 * WARP, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)start, (const int32_t*)base, (const uint32_t*)cw, (uint32_t*)chal,
      (uint32_t*)state_out, K, rows, row_words, nchal, fills, sc, F);
  return (int)cudaGetLastError();
}
