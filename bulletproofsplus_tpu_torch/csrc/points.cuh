// What the point kernels share across the two curve families.
//
// A family is a point type with NC coordinates of NL words each (coord(c)
// is coordinate c) and overloads of pt_identity, pt_add, pt_dbl and pt_neg:
// Pt4 of ed25519.cuh (extended Edwards) and Pt3 of weierstrass.cuh
// (projective Weierstrass with a = 0), as each TPU kernel has an Edwards and
// a Weierstrass body (bulletproofsplus_tpu/curves/pallas_curve.py::_family).
// The kernels are templates over the point type, built once per family
// (family.cuh). A point in memory is NC·NL consecutive uint32 (the
// coordinates in order, Montgomery form, each < p), loaded and stored as
// 16-byte words, so point arrays must be 16-byte aligned.
#pragma once

#include <cstring>

#include "field.cuh"

namespace bpp {

// The constants of a family's formulas, one layout for both families (the
// packing of curves/cuda_curve.py::_consts_words).
struct CurveConsts {
  Mod fp;            // the base field
  uint32_t k[NL];    // 2d (Edwards) or 3b (Weierstrass), Montgomery form
  uint32_t one[NL];  // 2^256 mod p (1 in Montgomery form)
};

template <class P>
__device__ __forceinline__ void pt_load(P& Q, const uint32_t* __restrict__ src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int c = 0; c < P::NC; ++c) {
    uint32_t* w = Q.coord(c);
    const uint4 lo = s[2 * c], hi = s[2 * c + 1];
    w[0] = lo.x; w[1] = lo.y; w[2] = lo.z; w[3] = lo.w;
    w[4] = hi.x; w[5] = hi.y; w[6] = hi.z; w[7] = hi.w;
  }
}

template <class P>
__device__ __forceinline__ void pt_store(uint32_t* __restrict__ dst, const P& Q) {
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int c = 0; c < P::NC; ++c) {
    const uint32_t* w = Q.coord(c);
    d[2 * c] = make_uint4(w[0], w[1], w[2], w[3]);
    d[2 * c + 1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// Block-wide sum of one point per thread through shared memory; the total
// lands in sh[0].  blockDim.x must be a power of two, sh sized blockDim.x.
template <class P>
__device__ __forceinline__ void pt_block_reduce(P* sh, const P& mine, const CurveConsts& K) {
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
