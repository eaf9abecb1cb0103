// Microbenchmark of one dependent point add, built and driven by
// scripts/bench_torch_k2.py: one unit a point family (-DBPP_FAMILY=0/1/2,
// with -I at bulletproofsplus_tpu_torch/csrc), so each family's pt_add is
// the one the point kernels inline.
//
// add_chain: one block of `threads` threads; each thread loads a point A and
// a point Q and runs `reps` dependent adds A = A + Q, then stores A. With one
// warp on the card, (time at reps − time at 0) / reps is the latency of one
// dependent add: what a tree level of K3 or K4 costs.
#include <cuda_runtime.h>

#include "family.cuh"

using namespace bpp;

namespace {

template <class P>
__global__ void add_chain(const uint32_t* __restrict__ pts, uint32_t* __restrict__ out, int reps,
                          typename P::Consts K) {
  constexpr int WORDS = P::NC * P::NL;
  P acc, q;
  pt_load(acc, pts + (2 * threadIdx.x) * WORDS);
  pt_load(q, pts + (2 * threadIdx.x + 1) * WORDS);
#pragma unroll 1
  for (int i = 0; i < reps; ++i) pt_add(acc, acc, q, K);
  pt_store(out + threadIdx.x * WORDS, acc);
}

}  // namespace

// pts: 2·threads points (A, Q pairs); out: threads points.
extern "C" int BPP_ENTRY(bpp_add_chain)(const void* pts, void* out, int threads, int reps,
                                        const uint32_t* consts, void* stream) {
  FamilyPt::Consts K;
  memcpy(&K, consts, sizeof(K));
  add_chain<FamilyPt><<<1, threads, 0, (cudaStream_t)stream>>>((const uint32_t*)pts,
                                                               (uint32_t*)out, reps, K);
  return (int)cudaGetLastError();
}
