// Microbenchmark of field.cuh's Montgomery product, built and driven by
// scripts/bench_torch_fe_mul.py: one unit, compiled with -I at the
// directory of the field.cuh under test, so two versions of the header
// time side by side.
//
// chain: each thread runs `reps` dependent products x = x·y·R^-1 mod p, as
//   a K2 thread does, at the card's full occupancy.
// check: one product, sum and difference of a pair a thread, for the
//   script's comparison with Python integers.
// one_mul: a single product, for the SASS instruction mix of one fe_mul.
#include <cuda_runtime.h>

#include "field.cuh"

using namespace bpp;

namespace {

template <int N>
__device__ __forceinline__ void load(uint32_t (&r)[N], const uint32_t* src, long long i) {
#pragma unroll
  for (int k = 0; k < N; ++k) r[k] = src[i * N + k];
}

template <int N>
__device__ __forceinline__ void store(uint32_t* dst, long long i, const uint32_t (&r)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) dst[i * N + k] = r[k];
}

template <int N>
__global__ void chain_kernel(const uint32_t* x0, const uint32_t* y0, uint32_t* out, long long n,
                             int reps, Mod<N> M) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[N], y[N];
  load(x, x0, i);
  load(y, y0, i);
#pragma unroll 1
  for (int r = 0; r < reps; ++r) fe_mul(x, x, y, M);
  store(out, i, x);
}

template <int N>
__global__ void check_kernel(const uint32_t* a0, const uint32_t* b0, uint32_t* out, long long n,
                             Mod<N> M) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t a[N], b[N], r[N];
  load(a, a0, i);
  load(b, b0, i);
  fe_mul(r, a, b, M);
  store(out, 3 * i, r);
  fe_add(r, a, b, M);
  store(out, 3 * i + 1, r);
  fe_sub(r, a, b, M);
  store(out, 3 * i + 2, r);
}

template <int N>
__global__ void one_mul_kernel(const uint32_t* a0, const uint32_t* b0, uint32_t* out, Mod<N> M) {
  uint32_t a[N], b[N], r[N];
  load(a, a0, threadIdx.x);
  load(b, b0, threadIdx.x);
  fe_mul(r, a, b, M);
  store(out, threadIdx.x, r);
}

template <int N>
Mod<N> modulus(const uint32_t* words) {
  Mod<N> M;
  for (int k = 0; k < N; ++k) M.p[k] = words[k];
  M.np0 = words[N];
  return M;
}

template <int N>
int run(int what, const void* a, const void* b, void* out, long long n, int reps,
        const uint32_t* mod_words, cudaStream_t s) {
  const Mod<N> M = modulus<N>(mod_words);
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  const uint32_t *pa = (const uint32_t*)a, *pb = (const uint32_t*)b;
  uint32_t* po = (uint32_t*)out;
  if (what == 0) chain_kernel<N><<<blocks, threads, 0, s>>>(pa, pb, po, n, reps, M);
  else if (what == 1) check_kernel<N><<<blocks, threads, 0, s>>>(pa, pb, po, n, M);
  else one_mul_kernel<N><<<1, 32, 0, s>>>(pa, pb, po, M);
  return (int)cudaGetLastError();
}

}  // namespace

// what: 0 chain (reps products a thread), 1 check (product, sum, difference),
// 2 one product; mod_words: the nl words of p, then -p^-1 mod 2^32.
extern "C" int bench_fe(int what, const void* a, const void* b, void* out, long long n,
                        int reps, int nl, const uint32_t* mod_words, void* stream) {
  switch (nl) {
    case 8: return run<8>(what, a, b, out, n, reps, mod_words, (cudaStream_t)stream);
    case 12: return run<12>(what, a, b, out, n, reps, mod_words, (cudaStream_t)stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
