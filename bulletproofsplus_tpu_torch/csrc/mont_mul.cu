// K1: batched Montgomery product out[i] = a[i]·b[i]·R^-1 mod p, R = 2^(32N).
//
// Replaces bulletproofsplus_tpu/fields/pallas_ops.py::_mont_mul_call (the
// pl.pallas_call at :369). One thread per element: N-word CIOS in registers
// (field.cuh::fe_mul), N = 8 (every scalar field, the 256-bit base fields)
// or N = 12 (bls12-381's Fq), two template instances in this one unit
// behind one entry point that takes the width. Bound by memory traffic
// (12·N bytes per element) and launch latency at the exponent stage's sizes;
// see fields/mont_mul.py.
#include <cuda_runtime.h>

#include "field.cuh"

using namespace bpp;

namespace {

template <int N>
__global__ void mont_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                uint32_t* __restrict__ out, long long n, Mod<N> M) {
  static_assert(N % 4 == 0, "an element is whole 16-byte words");
  constexpr int V = N / 4;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint4* pa = reinterpret_cast<const uint4*>(a + i * N);
  const uint4* pb = reinterpret_cast<const uint4*>(b + i * N);
  uint32_t x[N], y[N], r[N];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const uint4 qa = pa[v], qb = pb[v];
    x[4 * v] = qa.x; x[4 * v + 1] = qa.y; x[4 * v + 2] = qa.z; x[4 * v + 3] = qa.w;
    y[4 * v] = qb.x; y[4 * v + 1] = qb.y; y[4 * v + 2] = qb.z; y[4 * v + 3] = qb.w;
  }
  fe_mul(r, x, y, M);
  uint4* po = reinterpret_cast<uint4*>(out + i * N);
#pragma unroll
  for (int v = 0; v < V; ++v)
    po[v] = make_uint4(r[4 * v], r[4 * v + 1], r[4 * v + 2], r[4 * v + 3]);
}

template <int N>
int launch(const void* a, const void* b, void* out, long long n, const uint32_t* mod_words,
           cudaStream_t stream) {
  Mod<N> M;
  for (int i = 0; i < N; ++i) M.p[i] = mod_words[i];
  M.np0 = mod_words[N];
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  mont_mul_kernel<N><<<(unsigned)blocks, threads, 0, stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, M);
  return (int)cudaGetLastError();
}

}  // namespace

// mod_words: the N words of p, then -p^-1 mod 2^32.
extern "C" int bpp_mont_mul(const void* a, const void* b, void* out, long long n, int nl,
                            const uint32_t* mod_words, void* stream) {
  switch (nl) {
    case 8: return launch<8>(a, b, out, n, mod_words, (cudaStream_t)stream);
    case 12: return launch<12>(a, b, out, n, mod_words, (cudaStream_t)stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* bpp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
