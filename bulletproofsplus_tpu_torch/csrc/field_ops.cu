// K1 and the field layer around it: the Montgomery product, add, sub and
// neg elementwise, a field sum along one axis, a power by a constant
// exponent and the inverse, over tensors of N-word elements, each one
// launch.
//
// Replaces bulletproofsplus_tpu/fields/pallas_ops.py::_mont_mul_call (the
// pl.pallas_call at :369), which does the JAX package's products. Its other
// field ops (fields/ops.py: add, sub, neg :206-216, pow_const :298-337,
// inv :339, sum :389-403) are jnp carry chains that XLA fuses into the
// program around them. Eager PyTorch fuses nothing: there each add was
// some 50 torch launches over int64 copies of its operands, a sum a tree of
// such adds, and a Fermat inversion about 330 product launches. Here each
// is one kernel.
// N = 8 (every scalar field, the 256-bit base fields) or 12 (bls12-381's
// Fq), two template instances of each kernel behind one entry point that
// takes the width. All arithmetic but the inverse's is field.cuh's carry
// chains on fully reduced values, so every result equals its plain version
// word for word, whatever the order of a sum; the inverse's plain version
// runs its divsteps step for step.
//
// - mont_mul (K1), fe_add, fe_sub, fe_neg: one thread an output element.
//   An operand is read through a two-level index (Operand), so a broadcast
//   one, (K, 1, N) or (N,) against (K, W, N), is read in place with stride
//   0 and never materialized. Bound by memory: 12·N bytes an element at
//   most (less for a broadcast operand) against the product's 4N² + N
//   multiply-adds, so the product runs near the byte bound and the adds
//   well inside it, once the launch is not host-bound.
// - fe_sum: x of (B, R, C) elements summed over R. A block of 256 threads
//   covers tc columns of one b with 256/tc row lanes; each lane adds a
//   strided slice of the rows, then the block reduces its lanes through
//   shared memory. tc shrinks from 32 until there are blocks for every SM:
//   the verifier's sum over K = 256 proofs of (K, mn) runs 2-8 columns a
//   block, the prover's sum over one row of (K, half) one. Bound by
//   reading x once.
// - fe_pow: one thread an element runs the whole 4-bit fixed-window chain of
//   FieldOps.pow_const in registers, its 16-entry table in local memory
//   (the digit indexes it at run time). Bound by the latency of one
//   thread's chain of dependent products (~330 for p − 2 at 8 words), not
//   by the card's rate. No path of the port calls it since fe_inv.
// - fe_inv: a⁻¹ (0 ↦ 0) by Bernstein–Yang divsteps (eprint 2019/266, the
//   constant-time form of libsecp256k1's modinv32), one thread an element,
//   FieldOps.inv. What bounds it is the same as fe_pow's, one thread's
//   dependent chain at a batch inversion's few hundred values; the design
//   shortens that chain: a Fermat inversion is ~330 (8 words) or ~490 (12)
//   dependent products, each itself a chain of carries, this one is the
//   modulus's divsteps (⌊(49d + 57)/17⌋ for d bits: 741 at 256 bits, 1,101
//   at 381) at ~5 dependent operations each, in blocks of 30 on the low
//   30 bits of f and g, plus a 2 × 2 matrix product a block over the full
//   width. The values are signed 30-bit limbs (9 at 8 words, 13 at 12) so
//   that each matrix entry (|u| + |v| ≤ 2^30) times a limb, plus two more
//   such terms, fits a 64-bit accumulator. A step selects among
//   candidates computed beside its tests (g ± f, q ± u, r ± v), and only
//   the next block's low limbs of (f, g) follow a block's divsteps on the
//   dependent path: the full-width (f, g) and (d, e) updates of a block
//   overlap the next block's divsteps (on an H100 at 256 values, 0.044 →
//   0.035 ms at 12 words and 0.028 → 0.026-0.027 at 8 against a masked
//   step without the overlap; scripts/bench_torch_inv_reduce.py). Fixed
//   count, no data-dependent branch, so a warp never diverges. (d, e)
//   start at (0, R² mod p), so the last d is ±(aR)⁻¹R² = ±a⁻¹R, already
//   Montgomery form: no product at the end.
#include <cuda_runtime.h>

#include <cstring>

#include "field.cuh"

using namespace bpp;

namespace {

constexpr int THREADS = 256;
constexpr int SUM_THREADS = 256;
constexpr int SMS = 132;          // an H100 SXM's SMs; only fe_sum's block shape reads it
constexpr int MAX_EXP_WORDS = 16;  // fe_pow takes exponents below 2^512
constexpr int DIVSTEP_BLOCK = 30;  // fe_inv: divsteps a block, bits of a limb
constexpr int INV_LIMBS_MAX = 13;  // signed 30-bit limbs of a 12-word value and its sign
constexpr int32_t M30 = (1 << DIVSTEP_BLOCK) - 1;

// Element i of an operand lies at p + (i / inner)·s_outer + (i % inner)·s_inner
// words: a contiguous tensor has inner = n, s_inner = N; a (K, 1, N) operand
// broadcast over (K, W, N) has inner = W, s_inner = 0, s_outer = N. Every
// element starts 16-byte aligned (the wrapper checks it).
struct Operand {
  const uint32_t* p;
  unsigned inner;
  long long s_inner, s_outer;
};

template <int N>
struct Elem {
  uint32_t w[N];
};

// fe_inv's constants (fields/spec.py, FieldSpec.inv_consts): the divsteps
// that invert every element, p^-1 mod 2^30, then p and R^2 mod p in 30-bit
// limbs.
struct InvConsts {
  int steps;
  uint32_t inv30;
  int32_t p[INV_LIMBS_MAX];
  int32_t r2[INV_LIMBS_MAX];
};

struct Exponent {
  uint32_t w[MAX_EXP_WORDS];  // little-endian words
  int nwin;                   // 4-bit windows, 0 for e = 0
};

__device__ __forceinline__ const uint32_t* element(const Operand& o, unsigned i) {
  const unsigned q = i / o.inner, r = i - q * o.inner;
  return o.p + q * o.s_outer + r * o.s_inner;
}

template <int N>
__device__ __forceinline__ void load(uint32_t (&x)[N], const uint32_t* p) {
  const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    const uint4 q = v[k];
    x[4 * k] = q.x; x[4 * k + 1] = q.y; x[4 * k + 2] = q.z; x[4 * k + 3] = q.w;
  }
}

template <int N>
__device__ __forceinline__ void store(uint32_t* p, const uint32_t (&x)[N]) {
  uint4* v = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int k = 0; k < N / 4; ++k)
    v[k] = make_uint4(x[4 * k], x[4 * k + 1], x[4 * k + 2], x[4 * k + 3]);
}

enum Op { MUL, ADD, SUB, NEG };

template <int N, int OP>
__global__ void elementwise_kernel(Operand a, Operand b, uint32_t* __restrict__ out,
                                   unsigned n, Mod<N> M) {
  static_assert(N % 4 == 0, "an element is whole 16-byte words");
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[N], y[N], r[N];
  load(x, element(a, i));
  if constexpr (OP != NEG) load(y, element(b, i));
  if constexpr (OP == MUL) fe_mul(r, x, y, M);
  if constexpr (OP == ADD) fe_add(r, x, y, M);
  if constexpr (OP == SUB) fe_sub(r, x, y, M);
  if constexpr (OP == NEG) fe_neg(r, x, M);
  store(out + (long long)i * N, r);
}

// out[b, c] = Σ_r x[b, r, c], x contiguous (B, R, C, N); tc columns a block.
template <int N>
__global__ void sum_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                           long long R, long long C, int tc, long long ctiles, Mod<N> M) {
  __shared__ uint32_t sh[SUM_THREADS * N];
  const int tr = SUM_THREADS / tc;
  const int tx = threadIdx.x % tc, ty = threadIdx.x / tc;
  const long long b = blockIdx.x / ctiles;
  const long long c = (blockIdx.x % ctiles) * tc + tx;
  uint32_t acc[N], cur[N];
  fe_set_zero(acc);
  if (c < C) {
    const uint32_t* col = x + (b * R * C + c) * N;
    for (long long r = ty; r < R; r += tr) {
      load(cur, col + r * C * N);
      fe_add(acc, acc, cur, M);
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) sh[threadIdx.x * N + k] = acc[k];
  __syncthreads();
  for (int s = tr / 2; s > 0; s >>= 1) {
    if (ty < s) {
#pragma unroll
      for (int k = 0; k < N; ++k) cur[k] = sh[(threadIdx.x + s * tc) * N + k];
      fe_add(acc, acc, cur, M);
#pragma unroll
      for (int k = 0; k < N; ++k) sh[threadIdx.x * N + k] = acc[k];
    }
    __syncthreads();
  }
  if (ty == 0 && c < C) store(out + (b * C + c) * N, acc);
}

// out[i] = a[i]^e, the window chain of FieldOps.pow_const: a table of
// a^0..a^15 (14 products), the top digit's entry, then per lower window 4
// squarings and, for a nonzero digit, one product (a zero digit's product
// by 1 changes no word, so it is skipped). e = 0 gives one = R mod p.
template <int N>
__global__ void pow_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out,
                           unsigned n, Mod<N> M, Exponent e, Elem<N> one) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t acc[N];
  if (e.nwin == 0) {
    fe_copy(acc, one.w);
  } else {
    uint32_t tab[16][N];
    load(tab[1], a + (long long)i * N);
#pragma unroll 1
    for (int d = 2; d < 16; ++d) fe_mul(tab[d], tab[d - 1], tab[1], M);
    auto digit = [&](int w) { return (e.w[w >> 3] >> ((w & 7) * 4)) & 15u; };
    fe_copy(acc, tab[digit(e.nwin - 1)]);
#pragma unroll 1
    for (int w = e.nwin - 2; w >= 0; --w) {
#pragma unroll 1
      for (int k = 0; k < 4; ++k) fe_mul(acc, acc, acc, M);
      const unsigned d = digit(w);
      if (d) fe_mul(acc, acc, tab[d], M);
    }
  }
  store(out + (long long)i * N, acc);
}

// -- fe_inv -------------------------------------------------------------
// Signed 30-bit limbs: S of them, limbs 0..S-2 in [0, 2^30), the top one
// signed; the same steps as fields/field_kernels.py::fe_inv_plain.

template <int N>
constexpr int S30 = 32 * N / DIVSTEP_BLOCK + 1;

template <int N>
__device__ __forceinline__ void words_to_s30(int32_t (&x)[S30<N>],
                                             const uint32_t (&w)[N]) {
#pragma unroll
  for (int j = 0; j < S30<N>; ++j) {
    const int k = DIVSTEP_BLOCK * j / 32, s = DIVSTEP_BLOCK * j % 32;
    uint32_t v = w[k] >> s;
    if (s > 32 - DIVSTEP_BLOCK && k + 1 < N) v |= w[k + 1] << (32 - s);
    x[j] = (int32_t)(v & (uint32_t)M30);
  }
}

template <int N>
__device__ __forceinline__ void s30_to_words(uint32_t (&w)[N],
                                             const int32_t (&x)[S30<N>]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int j = 32 * i / DIVSTEP_BLOCK, s = 32 * i % DIVSTEP_BLOCK;
    w[i] = ((uint32_t)x[j] >> s) | ((uint32_t)x[j + 1] << (DIVSTEP_BLOCK - s));
  }
}

// DIVSTEP_BLOCK divsteps on the low bits of f and g (libsecp256k1's
// modinv32_divsteps_30 with the original δ, as selects): t = (u, v, q, r),
// the block's matrix scaled by 2^30, 2^30·(f', g') = (u·f + v·g, q·f +
// r·g). A step with δ > 0 and g odd swaps, (1 − δ, g, (g − f)/2);
// otherwise (1 + δ, f, (g + (g mod 2)·f)/2). Halving g is doubling (u, v)
// instead.
__device__ __forceinline__ int32_t divsteps(int32_t delta, uint32_t f, uint32_t g,
                                            int32_t (&t)[4]) {
  uint32_t u = 1, v = 0, q = 0, r = 1;
#pragma unroll
  for (int i = 0; i < DIVSTEP_BLOCK; ++i) {
    const bool odd = g & 1u, swap = odd && delta > 0;
    // every candidate computed beside the tests, then selected
    const uint32_t g1 = swap ? g - f : odd ? g + f : g;
    const uint32_t q1 = swap ? q - u : odd ? q + u : q;
    const uint32_t r1 = swap ? r - v : odd ? r + v : r;
    f = swap ? g : f;
    u = swap ? q : u;
    v = swap ? r : v;
    delta = swap ? 1 - delta : 1 + delta;
    g = g1 >> 1;
    q = q1;
    r = r1;
    u <<= 1;
    v <<= 1;
  }
  t[0] = (int32_t)u; t[1] = (int32_t)v; t[2] = (int32_t)q; t[3] = (int32_t)r;
  return delta;
}

// (f, g) <- (u·f + v·g, q·f + r·g) / 2^30, exact.
template <int S>
__device__ __forceinline__ void update_fg(int32_t (&f)[S], int32_t (&g)[S],
                                          const int32_t (&t)[4]) {
  const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
  int64_t cf = (int64_t)u * f[0] + (int64_t)v * g[0];
  int64_t cg = (int64_t)q * f[0] + (int64_t)r * g[0];
  cf >>= DIVSTEP_BLOCK;
  cg >>= DIVSTEP_BLOCK;
#pragma unroll
  for (int i = 1; i < S; ++i) {
    cf += (int64_t)u * f[i] + (int64_t)v * g[i];
    cg += (int64_t)q * f[i] + (int64_t)r * g[i];
    f[i - 1] = (int32_t)cf & M30;
    cf >>= DIVSTEP_BLOCK;
    g[i - 1] = (int32_t)cg & M30;
    cg >>= DIVSTEP_BLOCK;
  }
  f[S - 1] = (int32_t)cf;
  g[S - 1] = (int32_t)cg;
}

// The low 30 bits of (u·f + v·g, q·f + r·g) / 2^30: what the next block's
// divsteps read, from limbs 0 and 1 alone.
template <int S>
__device__ __forceinline__ void low_limbs(uint32_t& f0, uint32_t& g0, const int32_t (&f)[S],
                                          const int32_t (&g)[S], const int32_t (&t)[4]) {
  int64_t cf = (int64_t)t[0] * f[0] + (int64_t)t[1] * g[0];
  int64_t cg = (int64_t)t[2] * f[0] + (int64_t)t[3] * g[0];
  cf = (cf >> DIVSTEP_BLOCK) + (int64_t)t[0] * f[1] + (int64_t)t[1] * g[1];
  cg = (cg >> DIVSTEP_BLOCK) + (int64_t)t[2] * f[1] + (int64_t)t[3] * g[1];
  f0 = (uint32_t)cf & (uint32_t)M30;
  g0 = (uint32_t)cg & (uint32_t)M30;
}

// (d, e) <- (u·d + v·e, q·d + r·e) / 2^30 mod p, each kept in (−2p, p)
// (libsecp256k1's modinv32_update_de_30): md·p and me·p are added, md and
// me chosen to clear the low 30 bits, after p·(u, q) where d < 0 and
// p·(v, r) where e < 0.
template <int S>
__device__ __forceinline__ void update_de(int32_t (&d)[S], int32_t (&e)[S],
                                          const int32_t (&t)[4], const InvConsts& C) {
  const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
  const int32_t sd = d[S - 1] >> 31, se = e[S - 1] >> 31;
  int32_t md = (u & sd) + (v & se), me = (q & sd) + (r & se);
  int64_t cd = (int64_t)u * d[0] + (int64_t)v * e[0];
  int64_t ce = (int64_t)q * d[0] + (int64_t)r * e[0];
  md -= (int32_t)((C.inv30 * (uint32_t)cd + (uint32_t)md) & (uint32_t)M30);
  me -= (int32_t)((C.inv30 * (uint32_t)ce + (uint32_t)me) & (uint32_t)M30);
  cd += (int64_t)C.p[0] * md;
  ce += (int64_t)C.p[0] * me;
  cd >>= DIVSTEP_BLOCK;
  ce >>= DIVSTEP_BLOCK;
#pragma unroll
  for (int i = 1; i < S; ++i) {
    cd += (int64_t)u * d[i] + (int64_t)v * e[i] + (int64_t)C.p[i] * md;
    ce += (int64_t)q * d[i] + (int64_t)r * e[i] + (int64_t)C.p[i] * me;
    d[i - 1] = (int32_t)cd & M30;
    cd >>= DIVSTEP_BLOCK;
    e[i - 1] = (int32_t)ce & M30;
    ce >>= DIVSTEP_BLOCK;
  }
  d[S - 1] = (int32_t)cd;
  e[S - 1] = (int32_t)ce;
}

// d in (−2p, p) times the sign of f (±1) -> its residue in [0, p), limbs
// in [0, 2^30): add p where negative, negate where f < 0, carry, add p
// where still negative, carry.
template <int S>
__device__ __forceinline__ void normalize(int32_t (&d)[S], int32_t sign, const InvConsts& C) {
  int32_t neg = d[S - 1] >> 31;
#pragma unroll
  for (int i = 0; i < S; ++i) d[i] += C.p[i] & neg;
  const int32_t flip = sign >> 31;
#pragma unroll
  for (int i = 0; i < S; ++i) d[i] = (d[i] ^ flip) - flip;
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    d[i + 1] += d[i] >> DIVSTEP_BLOCK;
    d[i] &= M30;
  }
  neg = d[S - 1] >> 31;
#pragma unroll
  for (int i = 0; i < S; ++i) d[i] += C.p[i] & neg;
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    d[i + 1] += d[i] >> DIVSTEP_BLOCK;
    d[i] &= M30;
  }
}

// out[i] = a[i]^-1 (0 -> 0), Montgomery form in and out: f = p, g = a·R,
// (d, e) = (0, R^2 mod p), C.steps divsteps in whole blocks.
template <int N>
__global__ void inv_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out,
                           unsigned n, InvConsts C) {
  constexpr int S = S30<N>;
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t w[N];
  load(w, a + (long long)i * N);
  int32_t f[S], g[S], d[S], e[S];
  words_to_s30<N>(g, w);
#pragma unroll
  for (int j = 0; j < S; ++j) {
    f[j] = C.p[j];
    d[j] = 0;
    e[j] = C.r2[j];
  }
  // (f0, g0): the low limbs of (f, g) one block ahead of the full (f, g),
  // so a block's full-width update overlaps the next block's divsteps
  int32_t t[4], next[4];
  int32_t delta = divsteps(1, (uint32_t)f[0], (uint32_t)g[0], t);
  uint32_t f0, g0;
  low_limbs(f0, g0, f, g, t);
  const int blocks = (C.steps + DIVSTEP_BLOCK - 1) / DIVSTEP_BLOCK;
#pragma unroll 1
  for (int b = 1; b < blocks; ++b) {
    delta = divsteps(delta, f0, g0, next);
    update_de(d, e, t, C);
    update_fg(f, g, t);
    low_limbs(f0, g0, f, g, next);
#pragma unroll
    for (int k = 0; k < 4; ++k) t[k] = next[k];
  }
  update_fg(f, g, t);
  update_de(d, e, t, C);
  normalize(d, f[S - 1], C);
  s30_to_words<N>(w, d);
  store(out + (long long)i * N, w);
}

// consts: the N words of p, -p^-1 mod 2^32, then the N words of R mod p.
template <int N>
Mod<N> modulus(const uint32_t* consts) {
  Mod<N> M;
  for (int k = 0; k < N; ++k) M.p[k] = consts[k];
  M.np0 = consts[N];
  return M;
}

template <int N>
Elem<N> one_of(const uint32_t* consts) {
  Elem<N> one;
  for (int k = 0; k < N; ++k) one.w[k] = consts[N + 1 + k];
  return one;
}

unsigned blocks_of(long long n, int threads) { return (unsigned)((n + threads - 1) / threads); }

template <int N, int OP>
int elementwise(const Operand& a, const Operand& b, void* out, long long n,
                const uint32_t* consts, cudaStream_t stream) {
  const unsigned blocks = blocks_of(n, THREADS);
  elementwise_kernel<N, OP><<<blocks, THREADS, 0, stream>>>(a, b, (uint32_t*)out, (unsigned)n,
                                                            modulus<N>(consts));
  return (int)cudaGetLastError();
}

template <int OP>
int elementwise_entry(const Operand& a, const Operand& b, void* out, long long n, int nl,
                      const uint32_t* consts, cudaStream_t stream) {
  if (n <= 0 || n > 0x7FFFFFFF || a.inner == 0 || b.inner == 0)
    return (int)cudaErrorInvalidValue;
  switch (nl) {
    case 8: return elementwise<8, OP>(a, b, out, n, consts, stream);
    case 12: return elementwise<12, OP>(a, b, out, n, consts, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int N>
int sum(const void* x, void* out, long long B, long long R, long long C,
        const uint32_t* consts, cudaStream_t stream) {
  int tc = 32;
  while (tc > 1 && (tc / 2 >= C || B * ((C + tc - 1) / tc) < 2 * SMS)) tc /= 2;
  const long long ctiles = (C + tc - 1) / tc;
  const unsigned blocks = (unsigned)(B * ctiles);
  sum_kernel<N><<<blocks, SUM_THREADS, 0, stream>>>(
      (const uint32_t*)x, (uint32_t*)out, R, C, tc, ctiles, modulus<N>(consts));
  return (int)cudaGetLastError();
}

template <int N>
int power(const void* a, void* out, long long n, const Exponent& e, const uint32_t* consts,
          cudaStream_t stream) {
  // a batch inversion's few hundred values: one warp a block spreads them
  // over as many SMs as there are warps
  const int threads = n <= 4 * 32 * SMS ? 32 : 128;
  const unsigned blocks = blocks_of(n, threads);
  pow_kernel<N><<<blocks, threads, 0, stream>>>(
      (const uint32_t*)a, (uint32_t*)out, (unsigned)n, modulus<N>(consts), e, one_of<N>(consts));
  return (int)cudaGetLastError();
}

template <int N>
int inverse(const void* a, void* out, long long n, const InvConsts& C, cudaStream_t stream) {
  // as power(): a batch inversion's few hundred values one warp a block
  const int threads = n <= 4 * 32 * SMS ? 32 : 128;
  inv_kernel<N><<<blocks_of(n, threads), threads, 0, stream>>>(
      (const uint32_t*)a, (uint32_t*)out, (unsigned)n, C);
  return (int)cudaGetLastError();
}

Operand operand(const void* p, long long inner, long long s_inner, long long s_outer) {
  return Operand{(const uint32_t*)p, (unsigned)inner, s_inner, s_outer};
}

}  // namespace

// Each elementwise entry point takes its operands as (pointer, inner,
// s_inner, s_outer) (see Operand), then the contiguous output, the element
// count n < 2^31, the width nl and the field's consts.
#define BPP_BINARY(name, op)                                                                \
  extern "C" int name(const void* a, long long a_inner, long long a_sin, long long a_sout,  \
                      const void* b, long long b_inner, long long b_sin, long long b_sout,  \
                      void* out, long long n, int nl, const uint32_t* consts,               \
                      void* stream) {                                                       \
    return elementwise_entry<op>(operand(a, a_inner, a_sin, a_sout),                        \
                                 operand(b, b_inner, b_sin, b_sout), out, n, nl, consts,    \
                                 (cudaStream_t)stream);                                     \
  }
BPP_BINARY(bpp_mont_mul, MUL)
BPP_BINARY(bpp_fe_add, ADD)
BPP_BINARY(bpp_fe_sub, SUB)
#undef BPP_BINARY

extern "C" int bpp_fe_neg(const void* a, long long a_inner, long long a_sin, long long a_sout,
                          void* out, long long n, int nl, const uint32_t* consts, void* stream) {
  const Operand o = operand(a, a_inner, a_sin, a_sout);
  return elementwise_entry<NEG>(o, o, out, n, nl, consts, (cudaStream_t)stream);
}

// x contiguous (B, R, C) elements, R >= 1 → out (B, C).
extern "C" int bpp_fe_sum(const void* x, void* out, long long B, long long R, long long C,
                          int nl, const uint32_t* consts, void* stream) {
  if (B <= 0 || R <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  switch (nl) {
    case 8: return sum<8>(x, out, B, R, C, consts, (cudaStream_t)stream);
    case 12: return sum<12>(x, out, B, R, C, consts, (cudaStream_t)stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// a contiguous (n) elements; exp_words: MAX_EXP_WORDS little-endian words
// of e, nwin = ceil(bits(e) / 4).
extern "C" int bpp_fe_pow(const void* a, void* out, long long n, int nl,
                          const uint32_t* exp_words, int nwin, const uint32_t* consts,
                          void* stream) {
  if (n <= 0 || n > 0x7FFFFFFF || nwin < 0 || nwin > 8 * MAX_EXP_WORDS)
    return (int)cudaErrorInvalidValue;
  Exponent e;
  for (int k = 0; k < MAX_EXP_WORDS; ++k) e.w[k] = exp_words[k];
  e.nwin = nwin;
  switch (nl) {
    case 8: return power<8>(a, out, n, e, consts, (cudaStream_t)stream);
    case 12: return power<12>(a, out, n, e, consts, (cudaStream_t)stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// a contiguous (n) elements; consts: FieldSpec.inv_consts (InvConsts).
extern "C" int bpp_fe_inv(const void* a, void* out, long long n, int nl,
                          const uint32_t* consts, void* stream) {
  InvConsts C;
  memcpy(&C, consts, sizeof(C));
  if (n <= 0 || n > 0x7FFFFFFF || C.steps < 1) return (int)cudaErrorInvalidValue;
  switch (nl) {
    case 8: return inverse<8>(a, out, n, C, (cudaStream_t)stream);
    case 12: return inverse<12>(a, out, n, C, (cudaStream_t)stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* bpp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
