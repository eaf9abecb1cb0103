// K4: fixed-base (BGMW) lookup-accumulate over precomputed window tables.
//
// Replaces bulletproofsplus_tpu/curves/pallas_curve.py::_fixed_lookup_call
// (the pl.pallas_call at :371), both of its bodies: Edwards (Pt4) and
// Weierstrass (Pt3<8>, Pt3<12>) points, one template built once per family
// (family.cuh); a negative digit negates the
// selected entry the family's way (-X and -T for Edwards, -Y for
// Weierstrass, :324-328). Lanes are (window, point) pairs; lane i selects
// entry dig[i] of tbl[:, i] and all selected entries are summed. Unsigned
// tables hold entries 0..15; signed tables hold 1..8 with digits packed as
// mag | neg << 8, magnitude 0 meaning the identity. The TPU kernel carries
// one accumulator across its sequential grid; Hopper blocks run in no order,
// so each block sums a contiguous range of lanes into one partial point
// (strided over its threads, then a shared-memory tree) and K3 reduces the
// partials in a second pass. Bound by the table reads: one point (128, 96
// or 144 bytes) per lane from a table too large for L2 (268 MB for
// edwards25519 at 2mn = 2048, 805 MB for secp256k1 at 2mn = 8192, 4.83 GB
// for bls12-381 at 2mn = 32768), and by one point add per lane.
#include <cuda_runtime.h>

#include "family.cuh"

using namespace bpp;

namespace {

constexpr int THREADS = 256;

template <class P>
__global__ void fixed_lookup_kernel(const uint32_t* __restrict__ tbl,
                                    const int32_t* __restrict__ dig, uint32_t* __restrict__ out,
                                    long long lanes, int is_signed, typename P::Consts K) {
  constexpr int WORDS = P::NC * P::NL;
  __shared__ P sh[THREADS];
  const long long per = (lanes + gridDim.x - 1) / gridDim.x;
  const long long lo = (long long)blockIdx.x * per;
  const long long hi = min(lo + per, lanes);
  P acc, cur;
  pt_identity(acc, K);
  for (long long i = lo + threadIdx.x; i < hi; i += THREADS) {
    const int d = dig[i];
    if (is_signed) {
      const int mag = d & 0xFF;
      if (mag == 0) continue;
      pt_load(cur, tbl + ((long long)(mag - 1) * lanes + i) * WORDS);
      if ((d >> 8) & 1) pt_neg(cur, K);
    } else {
      pt_load(cur, tbl + ((long long)d * lanes + i) * WORDS);
    }
    pt_add(acc, acc, cur, K);
  }
  pt_block_reduce(sh, acc, K);
  if (threadIdx.x == 0) pt_store(out + (long long)blockIdx.x * WORDS, sh[0]);
}

template <class P>
int launch(const void* tbl, const void* dig, void* out, long long lanes, int is_signed,
           int nblocks, const typename P::Consts& K, cudaStream_t stream) {
  fixed_lookup_kernel<P><<<nblocks, THREADS, 0, stream>>>(
      (const uint32_t*)tbl, (const int32_t*)dig, (uint32_t*)out, lanes, is_signed, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int BPP_ENTRY(bpp_fixed_lookup)(const void* tbl, const void* dig, void* out,
                                           long long lanes, int is_signed, int nblocks,
                                           const uint32_t* consts, void* stream) {
  FamilyPt::Consts K;
  memcpy(&K, consts, sizeof(K));
  return launch<FamilyPt>(tbl, dig, out, lanes, is_signed, nblocks, K, (cudaStream_t)stream);
}
