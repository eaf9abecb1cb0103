// What the point kernels share across the point families.
//
// A family is a point type with NC coordinates of NL words each (coord(c)
// is coordinate c, Consts = CurveConsts<NL> its constants) and overloads of
// pt_identity, pt_add, pt_dbl and pt_neg: Pt4 of ed25519.cuh (extended
// Edwards, 8 words) and Pt3<NL> of weierstrass.cuh (projective Weierstrass
// with a = 0, at 8 words for secp256k1 and 12 for bls12-381), as each TPU
// kernel has an Edwards and a Weierstrass body
// (bulletproofsplus_tpu/curves/pallas_curve.py::_family). The kernels are
// templates over the point type, built once per family (family.cuh).
// Scalars are SW = 8 words whatever NL is. A point in memory is NC·NL
// consecutive uint32 (the coordinates in order, Montgomery form, each < p),
// loaded and stored as NL/4 16-byte words a coordinate, so point arrays must
// be 16-byte aligned.
#pragma once

#include <cstring>

#include "field.cuh"

namespace bpp {

// The constants of a family's formulas at NL words, one layout for every
// family (the packing of curves/cuda_curve.py::_consts_words).
template <int NL>
struct CurveConsts {
  Mod<NL> fp;         // the base field
  uint32_t k[NL];     // 2d (Edwards) or 3b (Weierstrass), Montgomery form
  uint32_t one[NL];   // 2^(32·NL) mod p (1 in Montgomery form)
};

template <class P>
__device__ __forceinline__ void pt_load(P& Q, const uint32_t* __restrict__ src) {
  static_assert(P::NL % 4 == 0, "a coordinate is whole 16-byte words");
  constexpr int V = P::NL / 4;
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int c = 0; c < P::NC; ++c) {
    uint32_t* w = Q.coord(c);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const uint4 q = s[c * V + v];
      w[4 * v] = q.x; w[4 * v + 1] = q.y; w[4 * v + 2] = q.z; w[4 * v + 3] = q.w;
    }
  }
}

template <class P>
__device__ __forceinline__ void pt_store(uint32_t* __restrict__ dst, const P& Q) {
  constexpr int V = P::NL / 4;
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int c = 0; c < P::NC; ++c) {
    const uint32_t* w = Q.coord(c);
#pragma unroll
    for (int v = 0; v < V; ++v)
      d[c * V + v] = make_uint4(w[4 * v], w[4 * v + 1], w[4 * v + 2], w[4 * v + 3]);
  }
}

// Block-wide sum of one point per thread through shared memory; the total
// lands in sh[0].  blockDim.x must be a power of two, sh sized blockDim.x.
template <class P>
__device__ __forceinline__ void pt_block_reduce(P* sh, const P& mine,
                                                const typename P::Consts& K) {
  const int t = threadIdx.x;
  sh[t] = mine;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (t < s) {
      P acc = sh[t];
      P other = sh[t + s];
      pt_add(acc, acc, other, K);
      sh[t] = acc;
    }
    __syncthreads();
  }
}

}  // namespace bpp
