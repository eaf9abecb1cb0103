// K1 and the field layer around it: the Montgomery product, add, sub and
// neg elementwise, a field sum along one axis, and a power by a constant
// exponent, over tensors of N-word elements, each one launch.
//
// Replaces bulletproofsplus_tpu/fields/pallas_ops.py::_mont_mul_call (the
// pl.pallas_call at :369), which does the JAX package's products. Its other
// field ops (fields/ops.py: add, sub, neg :206-216, pow_const :298-337,
// sum :389-403) are jnp carry chains that XLA fuses into the program around
// them. Eager PyTorch fuses nothing: there each add was some 50 torch
// launches over int64 copies of its operands, a sum a tree of such adds, and
// a Fermat inversion about 330 product launches. Here each is one kernel.
// N = 8 (every scalar field, the 256-bit base fields) or 12 (bls12-381's
// Fq), two template instances of each kernel behind one entry point that
// takes the width. All arithmetic is field.cuh's carry chains on fully
// reduced values, so every result equals its plain version word for word,
// whatever the order of a sum.
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
//   (the digit indexes it at run time). On the K = 256 values of a batch
//   inversion it is bound by the latency of one thread's ~330 dependent
//   products, not by the card's rate.
#include <cuda_runtime.h>

#include "field.cuh"

using namespace bpp;

namespace {

constexpr int THREADS = 256;
constexpr int SUM_THREADS = 256;
constexpr int SMS = 132;          // an H100 SXM's SMs; only fe_sum's block shape reads it
constexpr int MAX_EXP_WORDS = 16;  // fe_pow takes exponents below 2^512

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

extern "C" const char* bpp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
