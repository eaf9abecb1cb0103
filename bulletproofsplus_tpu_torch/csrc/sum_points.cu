// K3: grouped point sum, out[g] = Σ_w pts[g, w].
//
// Replaces bulletproofsplus_tpu/curves/pallas_curve.py::_sum_points_call
// (the pl.pallas_call at :553), both of its bodies: Edwards (Pt4) and
// Weierstrass (Pt3<8>, Pt3<12>) points, one template built once per family
// (family.cuh). The TPU kernel revisits one output window across a
// sequential grid and finishes with log2(512) rotate-adds. Hopper blocks run
// in no order, so here one block owns one group: each
// thread adds a strided slice of the group, then the block reduces its 256
// partial points through shared memory (256 × 128 B = 32 KB for Edwards,
// 24 KB for 8-word Weierstrass points, 36 KB for 12-word ones). Bound by
// the point-add latency of the 8-level tree
// and, for short groups, by having one block per group.
#include <cuda_runtime.h>

#include "family.cuh"

using namespace bpp;

namespace {

constexpr int THREADS = 256;

template <class P>
__global__ void sum_points_kernel(const uint32_t* __restrict__ pts, uint32_t* __restrict__ out,
                                  long long W, typename P::Consts K) {
  constexpr int WORDS = P::NC * P::NL;
  __shared__ P sh[THREADS];
  const long long g = blockIdx.x;
  P acc, cur;
  pt_identity(acc, K);
  for (long long i = threadIdx.x; i < W; i += THREADS) {
    pt_load(cur, pts + (g * W + i) * WORDS);
    pt_add(acc, acc, cur, K);
  }
  pt_block_reduce(sh, acc, K);
  if (threadIdx.x == 0) pt_store(out + g * WORDS, sh[0]);
}

template <class P>
int launch(const void* pts, void* out, long long G, long long W,
           const typename P::Consts& K, cudaStream_t stream) {
  sum_points_kernel<P><<<(unsigned)G, THREADS, 0, stream>>>((const uint32_t*)pts,
                                                           (uint32_t*)out, W, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int BPP_ENTRY(bpp_sum_points)(const void* pts, void* out, long long G, long long W,
                                         const uint32_t* consts, void* stream) {
  FamilyPt::Consts K;
  memcpy(&K, consts, sizeof(K));
  return launch<FamilyPt>(pts, out, G, W, K, (cudaStream_t)stream);
}
