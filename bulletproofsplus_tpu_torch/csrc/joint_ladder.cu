// K2: J-way joint windowed ladder (Strauss–Shamir), out[g] = Σ_j s_gj·P_gj.
//
// Replaces bulletproofsplus_tpu/curves/pallas_curve.py::_joint_ladder_call
// (the pl.pallas_call at :718). One thread per group of J pairs: it builds J
// tables 0..15·P_j in local memory (J × 2 KB), then runs nwin 4-bit windows
// MSB first, each 4 doublings and J table adds. 4-bit digits come straight
// from the plain-form scalar words. What bounds it on Hopper: ~9 Montgomery
// products per point op, ~900 point ops per group at J=8 and 253-bit
// scalars, all dependent; with one thread per group the 9,986-lane batch
// gives ~1,250 threads, far below the card's 270k, so it is bound by
// per-thread latency and by the local-memory table loads. A later PR spreads
// a group over several threads; this one is the simple, exact baseline.
#include <cuda_runtime.h>

#include "ed25519.cuh"

using namespace bpp;

namespace {

template <int J>
__global__ void joint_ladder_kernel(const uint32_t* __restrict__ pts,
                                    const uint32_t* __restrict__ scal,
                                    uint32_t* __restrict__ out, long long G, int nwin,
                                    EdConsts K) {
  long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  Pt tbl[J][16];
#pragma unroll 1
  for (int j = 0; j < J; ++j) {
    pt_identity(tbl[j][0], K);
    pt_load(tbl[j][1], pts + (g * J + j) * 32);
#pragma unroll 1
    for (int k = 2; k < 16; ++k) pt_add(tbl[j][k], tbl[j][k - 1], tbl[j][1], K);
  }
  const uint32_t* s = scal + g * J * NL;
  Pt acc;
  pt_identity(acc, K);
#pragma unroll 1
  for (int w = nwin - 1; w >= 0; --w) {
#pragma unroll 1
    for (int i = 0; i < 4; ++i) pt_dbl(acc, acc, K);
    const int word = (4 * w) >> 5, shift = (4 * w) & 31;
#pragma unroll 1
    for (int j = 0; j < J; ++j) {
      const uint32_t dig = (s[j * NL + word] >> shift) & 15u;
      pt_add(acc, acc, tbl[j][dig], K);
    }
  }
  pt_store(out + g * 32, acc);
}

template <int J>
int launch(const void* pts, const void* scal, void* out, long long G, int nwin,
           const EdConsts& K, cudaStream_t stream) {
  const int threads = 32;
  const long long blocks = (G + threads - 1) / threads;
  joint_ladder_kernel<J><<<(unsigned)blocks, threads, 0, stream>>>(
      (const uint32_t*)pts, (const uint32_t*)scal, (uint32_t*)out, G, nwin, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bpp_joint_ladder(const void* pts, const void* scal, void* out, long long G,
                                int jway, int nwin, const uint32_t* consts, void* stream) {
  EdConsts K;
  memcpy(&K, consts, sizeof(K));
  cudaStream_t st = (cudaStream_t)stream;
  switch (jway) {
    case 1: return launch<1>(pts, scal, out, G, nwin, K, st);
    case 2: return launch<2>(pts, scal, out, G, nwin, K, st);
    case 4: return launch<4>(pts, scal, out, G, nwin, K, st);
    case 8: return launch<8>(pts, scal, out, G, nwin, K, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
