// K1: batched Montgomery product out[i] = a[i]·b[i]·2^-256 mod p.
//
// Replaces bulletproofsplus_tpu/fields/pallas_ops.py::_mont_mul_call (the
// pl.pallas_call at :369). One thread per element: 8-word CIOS in registers
// (field.cuh::fe_mul). Bound by memory traffic (96 bytes per element) and
// launch latency at the exponent stage's sizes; see fields/mont_mul.py.
#include <cuda_runtime.h>

#include "field.cuh"

using namespace bpp;

namespace {

__global__ void mont_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                uint32_t* __restrict__ out, long long n, Mod M) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint4* pa = reinterpret_cast<const uint4*>(a + i * NL);
  const uint4* pb = reinterpret_cast<const uint4*>(b + i * NL);
  uint4 a0 = pa[0], a1 = pa[1], b0 = pb[0], b1 = pb[1];
  uint32_t x[NL] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  uint32_t y[NL] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  uint32_t r[NL];
  fe_mul(r, x, y, M);
  uint4* po = reinterpret_cast<uint4*>(out + i * NL);
  po[0] = make_uint4(r[0], r[1], r[2], r[3]);
  po[1] = make_uint4(r[4], r[5], r[6], r[7]);
}

}  // namespace

extern "C" int bpp_mont_mul(const void* a, const void* b, void* out, long long n,
                            const uint32_t* mod_words, void* stream) {
  Mod M;
  for (int i = 0; i < NL; ++i) M.p[i] = mod_words[i];
  M.np0 = mod_words[NL];
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  mont_mul_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, M);
  return (int)cudaGetLastError();
}

extern "C" const char* bpp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
