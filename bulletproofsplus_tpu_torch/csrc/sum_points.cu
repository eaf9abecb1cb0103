// K3: grouped point sum, out[g] = Σ_w pts[g, w].
//
// Replaces bulletproofsplus_tpu/curves/pallas_curve.py::_sum_points_call
// (the pl.pallas_call at :553), which revisits one output window across a
// sequential grid and finishes with log2(512) rotate-adds. Hopper blocks run
// in no order, so here one block owns one group: each thread adds a strided
// slice of the group, then the block reduces its 256 partial points through
// shared memory (256 × 128 B = 32 KB). Bound by the point-add latency of the
// 8-level tree and, for short groups, by having one block per group.
#include <cuda_runtime.h>

#include "ed25519.cuh"

using namespace bpp;

namespace {

constexpr int THREADS = 256;

__global__ void sum_points_kernel(const uint32_t* __restrict__ pts, uint32_t* __restrict__ out,
                                  long long W, EdConsts K) {
  __shared__ Pt sh[THREADS];
  const long long g = blockIdx.x;
  Pt acc, cur;
  pt_identity(acc, K);
  for (long long i = threadIdx.x; i < W; i += THREADS) {
    pt_load(cur, pts + (g * W + i) * 32);
    pt_add(acc, acc, cur, K);
  }
  pt_block_reduce(sh, acc, K);
  if (threadIdx.x == 0) pt_store(out + g * 32, sh[0]);
}

}  // namespace

extern "C" int bpp_sum_points(const void* pts, void* out, long long G, long long W,
                              const uint32_t* consts, void* stream) {
  EdConsts K;
  memcpy(&K, consts, sizeof(K));
  sum_points_kernel<<<(unsigned)G, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)pts, (uint32_t*)out, W, K);
  return (int)cudaGetLastError();
}
