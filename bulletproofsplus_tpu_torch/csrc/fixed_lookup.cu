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
// so each block writes one partial point and K3 reduces the partials.
//
// What bounds it: operations, one point add a lane (9 or 14 Montgomery
// products). The table is too large for L2 (268 MB for edwards25519 at
// 2mn = 2048, 805 MB for secp256k1 at 2mn = 8192, 4.83 GB for bls12-381 at
// 2mn = 32768), but a lane reads only its one entry (128, 96 or 144 bytes),
// 0.093 ms of reads at bls12-381 against 1.031 ms of adds. So the grid is
// what the card holds at once (the wrapper sizes it from
// bpp_fixed_lookup_resident), each thread adds a long strided run of lanes
// (about lanes ÷ the resident threads: a few at edwards25519, tens at
// bls12-381) in two interleaved chains at 8 words, or in one with the next
// lane's entry in flight at 12, and the block reduces its 128
// points in log2(128) levels, all but the first two by quad adds
// (pt_segment_sum): a few hundred partials.
#include <cuda_runtime.h>

#include "family.cuh"

using namespace bpp;

namespace {

constexpr int THREADS = 128;

// Start the loads of lane i's table entry for digit d; false where the entry
// is the identity (a signed magnitude of 0). *neg is the entry's sign.
template <class P>
__device__ __forceinline__ bool fetch(P& Q, bool& neg, const uint32_t* __restrict__ tbl, int d,
                                      long long i, long long lanes, int is_signed) {
  constexpr int WORDS = P::NC * P::NL;
  int entry = d;
  neg = false;
  if (is_signed) {
    const int mag = d & 0xFF;
    if (mag == 0) return false;
    entry = mag - 1;
    neg = (d >> 8) & 1;
  }
  pt_load(Q, tbl + ((long long)entry * lanes + i) * WORDS);
  return true;
}

// Each thread sums lanes i, i + stride, ...: 8-word families in two
// interleaved chains (two independent adds in flight, the entries of both
// loaded at once); at 12 words a second chain's registers would cost a
// block an SM, so one chain keeps the next lane's entry (and the digit
// after it) in flight while its add runs.
template <class P>
__global__ void __launch_bounds__(THREADS)
    fixed_lookup_kernel(const uint32_t* __restrict__ tbl, const int32_t* __restrict__ dig,
                        uint32_t* __restrict__ out, long long lanes, int is_signed,
                        typename P::Consts K) {
  constexpr int WORDS = P::NC * P::NL;
  __shared__ uint32_t sh[WORDS * THREADS / 32];
  const long long stride = (long long)gridDim.x * THREADS;
  long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  P acc;
  bool started = false;
  if constexpr (P::NL == 8) {
    P acc1;
    bool started1 = false;
#pragma unroll 1
    for (; i < lanes; i += 2 * stride) {
      P c0, c1;
      bool n0, n1 = false, h1 = false;
      const bool h0 = fetch(c0, n0, tbl, dig[i], i, lanes, is_signed);
      if (i + stride < lanes)
        h1 = fetch(c1, n1, tbl, dig[i + stride], i + stride, lanes, is_signed);
      if (h0) {
        if (n0) pt_neg(c0, K);
        if (started) pt_add(acc, acc, c0, K); else acc = c0;
        started = true;
      }
      if (h1) {
        if (n1) pt_neg(c1, K);
        if (started1) pt_add(acc1, acc1, c1, K); else acc1 = c1;
        started1 = true;
      }
    }
    if (started1) {
      if (started) pt_add(acc, acc, acc1, K); else acc = acc1;
      started = true;
    }
  } else {
    P cur;
    bool have = false, neg = false;
    int dnext = 0;
    if (i < lanes) have = fetch(cur, neg, tbl, dig[i], i, lanes, is_signed);
    if (i + stride < lanes) dnext = dig[i + stride];
#pragma unroll 1
    for (; i < lanes; i += stride) {
      const long long ni = i + stride;
      P nxt;
      bool nhave = false, nneg = false;
      if (ni < lanes) nhave = fetch(nxt, nneg, tbl, dnext, ni, lanes, is_signed);
      if (ni + stride < lanes) dnext = dig[ni + stride];
      if (have) {
        if (neg) pt_neg(cur, K);
        if (started) {
          pt_add(acc, acc, cur, K);
        } else {
          acc = cur;
          started = true;
        }
      }
      cur = nxt;
      have = nhave;
      neg = nneg;
    }
  }
  if (!started) pt_identity(acc, K);
  pt_segment_sum(acc, sh, THREADS, true, K);
  if (threadIdx.x == 0) pt_store(out + (long long)blockIdx.x * WORDS, acc);
}

template <class P>
int launch(const void* tbl, const void* dig, void* out, long long lanes, int is_signed,
           int nblocks, const typename P::Consts& K, cudaStream_t stream) {
  if (nblocks < 1) return (int)cudaErrorInvalidValue;
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

// Blocks of the kernel that the current device holds at once (blocks an SM
// at THREADS threads × SMs), or -1 on a CUDA error.
extern "C" int BPP_ENTRY(bpp_fixed_lookup_resident)(void) {
  int dev, sms, per_sm;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fixed_lookup_kernel<FamilyPt>,
                                                    THREADS, 0) != cudaSuccess)
    return -1;
  return sms * per_sm;
}
