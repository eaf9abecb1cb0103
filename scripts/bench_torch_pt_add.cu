// Microbenchmark of one dependent point operation, built and driven by
// scripts/bench_torch_k2.py: one unit a point family (-DBPP_FAMILY=0/1/2,
// with -I at bulletproofsplus_tpu_torch/csrc), so each family's pt_add,
// pt_dbl, pt_add_quad and pt_dbl_quad are the ones the point kernels inline.
//
// op_chain: one block of `threads` threads, a multiple of 4; the four
// threads of quad q load the same point A and point Q (pair q of `pts`) and
// each runs `reps` dependent operations of one kind, then stores A:
//   0  A = A + Q by pt_add          1  A = 2A by pt_dbl
//   2  A = A + Q by pt_add_quad     3  A = 2A by pt_dbl_quad
// With one warp on the card, (time at reps − time at 0) / reps is the
// latency of one dependent operation: what a tree level of K3 or K4 costs
// (kind 0 or 2), and the steps of K5's chain (kinds 2 and 3). Kinds 2 and 3
// store what kinds 0 and 1 store, word for word.
#include <cuda_runtime.h>

#include "family.cuh"

using namespace bpp;

namespace {

template <class P, int KIND>
__global__ void op_chain(const uint32_t* __restrict__ pts, uint32_t* __restrict__ out, int reps,
                         typename P::Consts K) {
  constexpr int WORDS = P::NC * P::NL;
  P acc, q;
  pt_load(acc, pts + (2 * (threadIdx.x / 4)) * WORDS);
  pt_load(q, pts + (2 * (threadIdx.x / 4) + 1) * WORDS);
#pragma unroll 1
  for (int i = 0; i < reps; ++i) {
    if (KIND == 0) pt_add(acc, acc, q, K);
    if (KIND == 1) pt_dbl(acc, acc, K);
    if (KIND == 2) pt_add_quad(acc, acc, q, K);
    if (KIND == 3) pt_dbl_quad(acc, acc, K);
  }
  pt_store(out + threadIdx.x * WORDS, acc);
}

template <int KIND>
void launch(const void* pts, void* out, int threads, int reps, const FamilyPt::Consts& K,
            cudaStream_t stream) {
  op_chain<FamilyPt, KIND><<<1, threads, 0, stream>>>((const uint32_t*)pts, (uint32_t*)out,
                                                      reps, K);
}

}  // namespace

// pts: threads / 2 points (an (A, Q) pair a quad); out: threads points.
extern "C" int BPP_ENTRY(bpp_op_chain)(const void* pts, void* out, int threads, int reps,
                                       int kind, const uint32_t* consts, void* stream) {
  if (threads % 4 || kind < 0 || kind > 3) return (int)cudaErrorInvalidValue;
  FamilyPt::Consts K;
  memcpy(&K, consts, sizeof(K));
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == 0) launch<0>(pts, out, threads, reps, K, s);
  if (kind == 1) launch<1>(pts, out, threads, reps, K, s);
  if (kind == 2) launch<2>(pts, out, threads, reps, K, s);
  if (kind == 3) launch<3>(pts, out, threads, reps, K, s);
  return (int)cudaGetLastError();
}
