// K5: per-lane 4-bit fixed-window scalar multiplication, out[i] = s_i·P_i.
//
// Replaces bulletproofsplus_tpu/curves/pallas_curve.py::_ladder_call (the
// pl.pallas_call at :253; wrapper ladder_scalar_mul :436), both of its
// bodies: Edwards (Pt4) and Weierstrass (Pt3<8>, Pt3<12>) points, one
// template built once per family (family.cuh). A 16-entry table 0·P .. 15·P built by
// repeated adds, then nwin windows MSB first, each four doublings and one
// table add, with canonical output. The TPU pads lanes to 512-wide blocks;
// here the four threads of an aligned quad own one lane and nothing pads.
//
// What bounds it: on the prover's path it runs h·α_k of the bit commitment
// on K = 256 lanes (one lane for a single prove), far too few to fill a
// card of 132 SMs, so it is bound by the latency of one lane's chain of
// 14 + 64·5 = 334 dependent point ops, not by the card's multiply rate. The
// design shortens that chain: every add and doubling is a quad operation
// (pt_add_quad, pt_dbl_quad of the family's header), each thread of the
// quad one Montgomery product a round and shuffles handing all four the
// round's products, so a doubling takes 2 (Edwards) or 3 (Weierstrass)
// product rounds instead of 8 or 9, an add 3 or 4 instead of 9 or 14. The
// products and their order are pt_add's and pt_dbl's in K2's order, so K5
// equals K2 at J = 1 limb for limb. Every thread of a warp must reach every
// shuffle, so threads past N run a copy of lane N − 1 and do not store.
//
// The table lives in dynamic shared memory, 16 points a thread (each thread
// of a quad keeps its own copy, so no barrier orders its stores and loads):
// 128 KB for a 64-thread block of Edwards points (128 B), 96 KB of 8-word
// Weierstrass points (96 B), 144 KB of 12-word ones (144 B, bls12-381), all
// above the 48 KB of static shared memory and opted in per family at
// launch; word-interleaved across the block's threads (word w of entry k of
// thread t at [(k·WORDS + w)·THREADS + t]) so that a warp's 32 table reads
// hit 32 different banks. 64-thread blocks put the 1,024 threads of 256
// lanes on 16 SMs, two warps each: on an H100 they ran 0.5-2.5 % faster
// than 32-thread blocks at 256 lanes and as fast at one lane; 128-thread
// blocks ran no faster on secp256k1 and exceed the 227 KB a block may opt
// into with Edwards (256 KB) and 12-word (288 KB) tables.
#include <cuda_runtime.h>

#include "family.cuh"

using namespace bpp;

namespace {

constexpr int THREADS = 64;
constexpr int NENT = 16;

template <class P>
constexpr int smem_bytes() {
  return NENT * P::NC * P::NL * THREADS * (int)sizeof(uint32_t);
}

template <class P>
__device__ __forceinline__ void tbl_store(uint32_t* tbl, int k, const P& Q) {
  uint32_t* base = tbl + k * P::NC * P::NL * THREADS + threadIdx.x;
#pragma unroll
  for (int c = 0; c < P::NC; ++c) {
    const uint32_t* w = Q.coord(c);
#pragma unroll
    for (int i = 0; i < P::NL; ++i) base[(c * P::NL + i) * THREADS] = w[i];
  }
}

template <class P>
__device__ __forceinline__ void tbl_load(P& Q, const uint32_t* tbl, uint32_t k) {
  const uint32_t* base = tbl + k * P::NC * P::NL * THREADS + threadIdx.x;
#pragma unroll
  for (int c = 0; c < P::NC; ++c) {
    uint32_t* w = Q.coord(c);
#pragma unroll
    for (int i = 0; i < P::NL; ++i) w[i] = base[(c * P::NL + i) * THREADS];
  }
}

template <class P>
__global__ void __launch_bounds__(THREADS)
ladder_kernel(const uint32_t* __restrict__ pts, const uint32_t* __restrict__ scal,
              uint32_t* __restrict__ out, long long N, int nwin, typename P::Consts K) {
  constexpr int WORDS = P::NC * P::NL;
  extern __shared__ uint32_t tbl[];
  const long long lane = ((long long)blockIdx.x * THREADS + threadIdx.x) / 4;
  const long long i = lane < N ? lane : N - 1;
  P base, cur, acc;
  pt_identity(acc, K);
  tbl_store(tbl, 0, acc);
  pt_load(base, pts + i * WORDS);
  tbl_store(tbl, 1, base);
  cur = base;
#pragma unroll 1
  for (int k = 2; k < NENT; ++k) {
    pt_add_quad(cur, cur, base, K);
    tbl_store(tbl, k, cur);
  }
  const uint32_t* s = scal + i * SW;
#pragma unroll 1
  for (int w = nwin - 1; w >= 0; --w) {
#pragma unroll 1
    for (int d = 0; d < 4; ++d) pt_dbl_quad(acc, acc, K);
    const int word = (4 * w) >> 5, shift = (4 * w) & 31;
    tbl_load(cur, tbl, (s[word] >> shift) & 15u);
    pt_add_quad(acc, acc, cur, K);
  }
  if (lane < N && (threadIdx.x & 3) == 0) pt_store(out + i * WORDS, acc);
}

template <class P>
int launch(const void* pts, const void* scal, void* out, long long N, int nwin,
           const typename P::Consts& K, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ladder_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<P>());
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (4 * N + THREADS - 1) / THREADS;
  ladder_kernel<P><<<(unsigned)blocks, THREADS, smem_bytes<P>(), stream>>>(
      (const uint32_t*)pts, (const uint32_t*)scal, (uint32_t*)out, N, nwin, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int BPP_ENTRY(bpp_ladder)(const void* pts, const void* scal, void* out, long long N,
                                     int nwin, const uint32_t* consts, void* stream) {
  if (nwin < 1 || nwin > 64) return (int)cudaErrorInvalidValue;
  FamilyPt::Consts K;
  memcpy(&K, consts, sizeof(K));
  return launch<FamilyPt>(pts, scal, out, N, nwin, K, (cudaStream_t)stream);
}
