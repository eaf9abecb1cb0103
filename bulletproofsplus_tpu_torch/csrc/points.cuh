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

// pt_load through L2 only (ld.global.cg): for points that other blocks of the
// same launch wrote, which this SM's L1 may not see.
template <class P>
__device__ __forceinline__ void pt_load_cg(P& Q, const uint32_t* src) {
  constexpr int V = P::NL / 4;
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int c = 0; c < P::NC; ++c) {
    uint32_t* w = Q.coord(c);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const uint4 q = __ldcg(s + c * V + v);
      w[4 * v] = q.x; w[4 * v + 1] = q.y; w[4 * v + 2] = q.z; w[4 * v + 3] = q.w;
    }
  }
}

// Point i of an array of `stride` points held word-major in shared memory
// (word k of point i at sh[k·stride + i]), so that neighbouring threads
// touch neighbouring banks.
template <class P>
__device__ __forceinline__ void pt_to_shared(uint32_t* sh, int stride, int i, const P& Q) {
#pragma unroll
  for (int c = 0; c < P::NC; ++c)
#pragma unroll
    for (int l = 0; l < P::NL; ++l) sh[(c * P::NL + l) * stride + i] = Q.coord(c)[l];
}

template <class P>
__device__ __forceinline__ void pt_from_shared(P& Q, const uint32_t* sh, int stride, int i) {
#pragma unroll
  for (int c = 0; c < P::NC; ++c)
#pragma unroll
    for (int l = 0; l < P::NL; ++l) Q.coord(c)[l] = sh[(c * P::NL + l) * stride + i];
}

// -- one add or doubling by the four lanes of a quad ---------------------------
// pt_add_quad (ed25519.cuh, weierstrass.cuh) computes R = P + Q with the
// four lanes of an aligned quad of a warp, each holding the same P and Q: a
// round gives each lane one of the add's Montgomery products, and shuffles
// hand every lane the four products, so the add's dependent chain is 3
// (Edwards) or 4 (Weierstrass) products instead of 9 or 14. pt_dbl_quad
// does the same for R = 2P: 2 or 3 products instead of 8 or 9. R lands in
// all four lanes, equal word for word to pt_add's or pt_dbl's. Every lane
// of the warp calls them. These are the helpers.

// r = the operand of this lane's role (0-3) among four.
template <int N>
__device__ __forceinline__ void fe_pick(uint32_t* r, int role, const uint32_t* a0,
                                        const uint32_t* a1, const uint32_t* a2,
                                        const uint32_t* a3) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    r[i] = role == 0 ? a0[i] : role == 1 ? a1[i] : role == 2 ? a2[i] : a3[i];
}

// r = m of lane k of this lane's quad.
template <int N>
__device__ __forceinline__ void fe_from_lane(uint32_t* r, const uint32_t* m, int k) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = __shfl_sync(0xffffffffu, m[i], k, 4);
}

// Q = P of the lane `m` away by xor (all words).
template <class P>
__device__ __forceinline__ void pt_shfl_xor(P& Q, const P& src, int m) {
#pragma unroll
  for (int c = 0; c < P::NC; ++c)
#pragma unroll
    for (int l = 0; l < P::NL; ++l)
      Q.coord(c)[l] = __shfl_xor_sync(0xffffffffu, src.coord(c)[l], m);
}

// Q = P of the lane `d` above (all words); a lane with none above (lane + d
// past 32) gets its own P back.
template <class P>
__device__ __forceinline__ void pt_shfl_down(P& Q, const P& src, int d) {
#pragma unroll
  for (int c = 0; c < P::NC; ++c)
#pragma unroll
    for (int l = 0; l < P::NL; ++l)
      Q.coord(c)[l] = __shfl_down_sync(0xffffffffu, src.coord(c)[l], d);
}

// -- reductions --------------------------------------------------------------

// Butterfly levels m = from, 2·from, ... below `to` (powers of two, to ≤ 32)
// over lanes that hold one point each: lane l adds lane l ^ m's point. The
// adds are symmetric word for word, so after levels 1 and 2 the four lanes
// of a quad hold the same point, and the levels from 4 on add quads by
// pt_add_quad. Every lane of the warp must call it with the same bounds.
template <class P>
__device__ __forceinline__ void pt_butterfly(P& acc, int from, int to,
                                             const typename P::Consts& K) {
#pragma unroll 1
  for (int m = from; m < to; m <<= 1) {
    P o;
    pt_shfl_xor(o, acc, m);
    if (m < 4)
      pt_add(acc, acc, o, K);
    else
      pt_add_quad(acc, acc, o, K);
  }
}

// Each warp holds its sum in every lane; the first warp of each run of nw
// warps (a power of two, at most 8) adds the run's nw sums, one a quad,
// through shared memory (sh: blockDim.x / 32 points, word-major). Every
// thread of the block must call it with the same nw.
template <class P>
__device__ __forceinline__ void pt_across_warps(P& acc, uint32_t* sh, int nw,
                                                const typename P::Consts& K) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, stride = blockDim.x / 32;
  __syncthreads();  // an earlier call may still read sh
  if (lane == 0) pt_to_shared(sh, stride, warp, acc);
  __syncthreads();
  if (warp % nw == 0) {
    if (lane / 4 < nw)
      pt_from_shared(acc, sh, stride, warp + lane / 4);
    else
      pt_identity(acc, K);
    pt_butterfly(acc, 4, 4 * nw, K);
  }
}

// Sum over segments of `seg` consecutive threads (a power of two dividing
// blockDim.x), one point a thread; the segment's sum lands in its first
// thread, after log2(seg) dependent adds. Two orders, for a segment wider
// than a warp:
// - quads_first (the shorter chain, for a card that waits on it): every
//   warp first sums its own 32 points by shuffles (two levels of single
//   adds, three of quad adds), then the segment's first warp adds the
//   warps' sums, one a quad, through shared memory (sh: blockDim.x / 32
//   points);
// - otherwise (less work, for a card full of blocks): the segment first
//   halves across its warps through shared memory (sh: blockDim.x / 2
//   points, word-major), single adds, so whole warps drop out at each level
//   and only log2(seg / 32) levels meet a __syncthreads; then its first
//   warp finishes by shuffles.
// Every thread of the block must call it with the same seg and order.
template <class P>
__device__ __forceinline__ void pt_segment_sum(P& acc, uint32_t* sh, int seg, bool quads_first,
                                               const typename P::Consts& K) {
  if (seg > 32 && !quads_first) {
    const int t = threadIdx.x, r = t % seg;
    const int stride = blockDim.x / 2, base = (t / seg) * (seg / 2);
#pragma unroll 1
    for (int w = seg / 2; w >= 32; w >>= 1) {
      if (r >= w && r < 2 * w) pt_to_shared(sh, stride, base + r - w, acc);
      __syncthreads();
      if (r < w) {
        P o;
        pt_from_shared(o, sh, stride, base + r);
        pt_add(acc, acc, o, K);
      }
      __syncthreads();
    }
    if (r < 32) pt_butterfly(acc, 1, 32, K);
    return;
  }
  pt_butterfly(acc, 1, seg < 32 ? seg : 32, K);
  if (seg > 32) pt_across_warps(acc, sh, seg / 32, K);
}

}  // namespace bpp
