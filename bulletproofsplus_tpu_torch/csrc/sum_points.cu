// K3: grouped point sum, out[g] = Σ_w pts[g, w].
//
// Replaces bulletproofsplus_tpu/curves/pallas_curve.py::_sum_points_call
// (the pl.pallas_call at :553), both of its bodies: Edwards (Pt4) and
// Weierstrass (Pt3<8>, Pt3<12>) points, one template built once per family
// (family.cuh). The TPU kernel revisits one output window across a
// sequential grid and finishes with log2(512) rotate-adds; Hopper blocks run
// in no order, so the sum is a tree spread over as many threads as fill the
// card.
//
// What bounds it: G·(W − 1) point adds (9 or 14 Montgomery products each),
// and, for one group, the ⌈log2 W⌉ dependent adds any tree over it needs
// (an add is microseconds in one thread). The layout (chosen by the wrapper,
// curves/cuda_curve.py::sum_layout, from G, W and the blocks the card holds
// at once) has two shapes:
// - many groups (the prover's 256-512 groups): a group gets a segment of
//   `seg` threads (1 to 128) of a 128-thread block, each thread adds a
//   strided run of the group's points, and the segment reduces by shuffles
//   within each warp, then, past 32 threads, across its warps through
//   shared memory (pt_segment_sum);
// - few groups (the verifier's one): a group spreads over `nblk` blocks of
//   128 threads, each writing one partial point to `parts`; the last block
//   of a group to finish (an atomic ticket after __threadfence) reduces the
//   group's partials and writes the sum. A thread then holds one or two
//   points, so the critical path is about ⌈log2 W⌉ dependent adds.
// Past the first two levels of a reduction the adds are quad adds
// (pt_add_quad: four lanes share one add, whose dependent chain is then 3
// or 4 products instead of 9 or 14), which shortens each of those levels
// about threefold. Each thread takes its first point by a copy, not an add
// to the identity.
#include <cuda_runtime.h>

#include "family.cuh"

using namespace bpp;

namespace {

constexpr int THREADS = 128;

template <class P>
__global__ void __launch_bounds__(THREADS)
    sum_points_kernel(const uint32_t* __restrict__ pts, uint32_t* __restrict__ out,
                      uint32_t* __restrict__ parts, unsigned* __restrict__ tickets, long long G,
                      long long W, int seg, int nblk, int quads_first, typename P::Consts K) {
  constexpr int WORDS = P::NC * P::NL;
  __shared__ uint32_t sh[WORDS * THREADS / 2];
  __shared__ bool last;
  const int t = threadIdx.x;
  long long g, lo, hi;
  if (nblk == 1) {
    g = (long long)blockIdx.x * (THREADS / seg) + t / seg;
    lo = 0;
    hi = W;
  } else {
    g = blockIdx.x / nblk;
    const long long chunk = (W + nblk - 1) / nblk;
    lo = (blockIdx.x % nblk) * chunk;
    hi = min(lo + chunk, W);
  }
  P acc;
  long long i = lo + t % seg;
  if (g < G && i < hi) {
    const uint32_t* src = pts + g * W * WORDS;
    pt_load(acc, src + i * WORDS);
#pragma unroll 1
    for (i += seg; i < hi; i += seg) {
      P cur;
      pt_load(cur, src + i * WORDS);
      pt_add(acc, acc, cur, K);
    }
  } else {
    pt_identity(acc, K);
  }
  pt_segment_sum(acc, sh, seg, quads_first, K);
  if (nblk == 1) {
    if (t % seg == 0 && g < G) pt_store(out + g * WORDS, acc);
    return;
  }

  // nblk blocks a group (seg == THREADS): publish this block's partial; the
  // group's last block to take a ticket sums the nblk partials.
  if (t == 0) {
    pt_store(parts + (long long)blockIdx.x * WORDS, acc);
    __threadfence();
    last = atomicAdd(&tickets[g], 1u) == (unsigned)(nblk - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // quad q (its four lanes alike) sums partials q, q + THREADS / 4, ...;
  // then the quads in use reduce by quad adds
  constexpr int QUADS = THREADS / 4;
  if (t / 4 < nblk) {
    pt_load_cg(acc, parts + (g * nblk + t / 4) * WORDS);
#pragma unroll 1
    for (int j = t / 4 + QUADS; j < nblk; j += QUADS) {
      P cur;
      pt_load_cg(cur, parts + (g * nblk + j) * WORDS);
      pt_add(acc, acc, cur, K);
    }
  } else {
    pt_identity(acc, K);
  }
  const int nq = nblk < QUADS ? nblk : QUADS;
  const int span = 4 << (32 - __clz(nq - 1));  // lanes of the quads in use, a power of two
  if (span <= 32) {
    if (t < 32) pt_butterfly(acc, 4, span, K);
  } else {
    pt_butterfly(acc, 4, 32, K);
    pt_across_warps(acc, sh, span / 32, K);
  }
  if (t == 0) pt_store(out + g * WORDS, acc);
}

template <class P>
int launch(const void* pts, void* out, void* scratch, long long G, long long W, int seg,
           int nblk, int quads_first, const typename P::Consts& K, cudaStream_t stream) {
  constexpr int WORDS = P::NC * P::NL;
  if (seg < 1 || seg > THREADS || (seg & (seg - 1)) || nblk < 1 || (nblk > 1 && seg != THREADS))
    return (int)cudaErrorInvalidValue;
  uint32_t* parts = nullptr;
  unsigned* tickets = nullptr;
  if (nblk > 1) {
    // scratch: G·nblk partial points, then G tickets, which start at 0
    parts = (uint32_t*)scratch;
    tickets = (unsigned*)(parts + G * nblk * WORDS);
    const cudaError_t err = cudaMemsetAsync(tickets, 0, G * sizeof(unsigned), stream);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = nblk > 1 ? G * nblk : (G + THREADS / seg - 1) / (THREADS / seg);
  sum_points_kernel<P><<<(unsigned)blocks, THREADS, 0, stream>>>(
      (const uint32_t*)pts, (uint32_t*)out, parts, tickets, G, W, seg, nblk, quads_first, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int BPP_ENTRY(bpp_sum_points)(const void* pts, void* out, void* scratch, long long G,
                                         long long W, int seg, int nblk, int quads_first,
                                         const uint32_t* consts, void* stream) {
  FamilyPt::Consts K;
  memcpy(&K, consts, sizeof(K));
  return launch<FamilyPt>(pts, out, scratch, G, W, seg, nblk, quads_first, K,
                          (cudaStream_t)stream);
}

// Blocks of the kernel that the current device holds at once (blocks an SM
// at THREADS threads × SMs), or -1 on a CUDA error.
extern "C" int BPP_ENTRY(bpp_sum_points_resident)(void) {
  int dev, sms, per_sm;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sum_points_kernel<FamilyPt>,
                                                    THREADS, 0) != cudaSuccess)
    return -1;
  return sms * per_sm;
}
