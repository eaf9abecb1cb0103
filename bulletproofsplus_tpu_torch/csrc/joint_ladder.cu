// K2: J-way joint windowed ladder (Strauss–Shamir), out[g] = Σ_j s_gj·P_gj.
//
// Replaces bulletproofsplus_tpu/curves/pallas_curve.py::_joint_ladder_call
// (the pl.pallas_call at :718), both of its bodies: Edwards (Pt4) and
// Weierstrass (Pt3<8>, Pt3<12>) points, one template built once per family
// (family.cuh). One thread per group of J pairs: it builds J tables
// 0..15·P_j in local memory (J × 2 KB for Edwards, J × 1.5 KB for 8-word
// Weierstrass points, J × 2.25 KB for 12-word ones: 18 KB at J = 8), then
// runs nwin 4-bit windows MSB first, each 4 doublings and J table adds.
// 4-bit digits come straight from the plain-form scalar words, SW = 8 of
// them a scalar whatever the width of a coordinate. What bounds it on
// Hopper: 8-9 (Edwards) or 9-14 (Weierstrass) Montgomery products per point
// op, ~900-1,000 point ops per group at J = 8, all dependent. Each product
// (field.cuh::fe_mul) is two PTX carry chains a row, which alone run at
// 93-96 % of the card's integer-multiply rate (scripts/bench_torch_fe_mul.py);
// the kernel keeps 120 (Edwards), 186 (8-word) and 244-246 (12-word
// Weierstrass) registers a thread, so 8-17 warps an SM hide that chain. At
// the prover's 10^5-10^6 groups it runs within about 1.5-2× of its
// integer-multiply bound; at the verifier's few thousand groups it is bound
// by per-thread latency on a partial wave. A later PR spreads a group over
// several threads there.
#include <cuda_runtime.h>

#include "family.cuh"

using namespace bpp;

// Threads a block where the groups fill the card many times over (the
// prover's 10^5-10^6), and below SMALL_GRID groups (the verifier's few
// thousand) blocks of 32 threads, which spread the partial wave over more
// SMs. PERF.md has the launch shapes that were tried. The minimum of 1
// block an SM in __launch_bounds__ is not the default: without it ptxas
// holds the registers down for occupancy, and the prover's shapes ran
// slower (PERF.md).
constexpr int THREADS = 128;
constexpr long long SMALL_GRID = 32768;

namespace {

template <class P, int J>
__global__ void __launch_bounds__(THREADS, 1)
    joint_ladder_kernel(const uint32_t* __restrict__ pts, const uint32_t* __restrict__ scal,
                        uint32_t* __restrict__ out, long long G, int nwin,
                        typename P::Consts K) {
  constexpr int W = P::NC * P::NL;
  long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  P tbl[J][16];
#pragma unroll 1
  for (int j = 0; j < J; ++j) {
    pt_identity(tbl[j][0], K);
    pt_load(tbl[j][1], pts + (g * J + j) * W);
#pragma unroll 1
    for (int k = 2; k < 16; ++k) pt_add(tbl[j][k], tbl[j][k - 1], tbl[j][1], K);
  }
  const uint32_t* s = scal + g * J * SW;
  P acc;
  pt_identity(acc, K);
#pragma unroll 1
  for (int w = nwin - 1; w >= 0; --w) {
#pragma unroll 1
    for (int i = 0; i < 4; ++i) pt_dbl(acc, acc, K);
    const int word = (4 * w) >> 5, shift = (4 * w) & 31;
#pragma unroll 1
    for (int j = 0; j < J; ++j) {
      const uint32_t dig = (s[j * SW + word] >> shift) & 15u;
      pt_add(acc, acc, tbl[j][dig], K);
    }
  }
  pt_store(out + g * W, acc);
}

template <class P>
int launch(const void* pts, const void* scal, void* out, long long G, int jway, int nwin,
           const typename P::Consts& K, cudaStream_t stream) {
  const int threads = G < SMALL_GRID ? 32 : THREADS;
  const unsigned blocks = (unsigned)((G + threads - 1) / threads);
  const uint32_t* p = (const uint32_t*)pts;
  const uint32_t* s = (const uint32_t*)scal;
  uint32_t* o = (uint32_t*)out;
  switch (jway) {
    case 1: joint_ladder_kernel<P, 1><<<blocks, threads, 0, stream>>>(p, s, o, G, nwin, K); break;
    case 2: joint_ladder_kernel<P, 2><<<blocks, threads, 0, stream>>>(p, s, o, G, nwin, K); break;
    case 4: joint_ladder_kernel<P, 4><<<blocks, threads, 0, stream>>>(p, s, o, G, nwin, K); break;
    case 8: joint_ladder_kernel<P, 8><<<blocks, threads, 0, stream>>>(p, s, o, G, nwin, K); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int BPP_ENTRY(bpp_joint_ladder)(const void* pts, const void* scal, void* out,
                                           long long G, int jway, int nwin,
                                           const uint32_t* consts, void* stream) {
  FamilyPt::Consts K;
  memcpy(&K, consts, sizeof(K));
  return launch<FamilyPt>(pts, scal, out, G, jway, nwin, K, (cudaStream_t)stream);
}
