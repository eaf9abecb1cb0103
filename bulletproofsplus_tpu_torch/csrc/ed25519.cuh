// edwards25519 extended points (X, Y, Z, T) over field.cuh.
//
// The device counterpart of curves/edwards.py::EdwardsOps.add/dbl and of the
// TPU formulas in bulletproofsplus_tpu/curves/pallas_curve.py:46-74: the
// same add-2008-hwcd-3 and dbl-2008-hwcd sequences, so kernel and plain
// version produce identical coordinates when they add in the same order.
// A point in memory is 32 consecutive uint32: X, Y, Z, T, 8 words each,
// Montgomery form, every coordinate < p.
#pragma once

#include <cstring>

#include "field.cuh"

namespace bpp {

struct EdConsts {
  Mod fp;             // p = 2^255 - 19
  uint32_t k2d[NL];   // 2d in Montgomery form
  uint32_t one[NL];   // 2^256 mod p (1 in Montgomery form)
};

struct Pt {
  uint32_t X[NL], Y[NL], Z[NL], T[NL];
};

__device__ __forceinline__ void pt_identity(Pt& P, const EdConsts& C) {
  fe_set_zero(P.X);
  fe_copy(P.Y, C.one);
  fe_copy(P.Z, C.one);
  fe_set_zero(P.T);
}

__device__ __forceinline__ void pt_load(Pt& P, const uint32_t* __restrict__ src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint32_t* w[4] = {P.X, P.Y, P.Z, P.T};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint4 lo = s[2 * c], hi = s[2 * c + 1];
    w[c][0] = lo.x; w[c][1] = lo.y; w[c][2] = lo.z; w[c][3] = lo.w;
    w[c][4] = hi.x; w[c][5] = hi.y; w[c][6] = hi.z; w[c][7] = hi.w;
  }
}

__device__ __forceinline__ void pt_store(uint32_t* __restrict__ dst, const Pt& P) {
  uint4* d = reinterpret_cast<uint4*>(dst);
  const uint32_t* w[4] = {P.X, P.Y, P.Z, P.T};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    d[2 * c] = make_uint4(w[c][0], w[c][1], w[c][2], w[c][3]);
    d[2 * c + 1] = make_uint4(w[c][4], w[c][5], w[c][6], w[c][7]);
  }
}

// R = P + Q, add-2008-hwcd-3 (a = -1), complete.  R may alias P or Q.
__device__ __forceinline__ void pt_add(Pt& R, const Pt& P, const Pt& Q, const EdConsts& K) {
  const Mod& M = K.fp;
  uint32_t a[NL], b[NL], c[NL], d[NL], t0[NL], t1[NL];
  fe_sub(t0, P.Y, P.X, M);
  fe_sub(t1, Q.Y, Q.X, M);
  fe_mul(a, t0, t1, M);
  fe_add(t0, P.Y, P.X, M);
  fe_add(t1, Q.Y, Q.X, M);
  fe_mul(b, t0, t1, M);
  fe_mul(t0, P.T, Q.T, M);
  fe_mul(c, t0, K.k2d, M);
  fe_add(t0, P.Z, P.Z, M);
  fe_mul(d, t0, Q.Z, M);
  uint32_t e[NL], f[NL], g[NL], h[NL];
  fe_sub(e, b, a, M);
  fe_sub(f, d, c, M);
  fe_add(g, d, c, M);
  fe_add(h, b, a, M);
  fe_mul(R.X, e, f, M);
  fe_mul(R.Y, g, h, M);
  fe_mul(R.Z, f, g, M);
  fe_mul(R.T, e, h, M);
}

// R = 2P, dbl-2008-hwcd (a = -1).  R may alias P.
__device__ __forceinline__ void pt_dbl(Pt& R, const Pt& P, const EdConsts& K) {
  const Mod& M = K.fp;
  uint32_t a[NL], b[NL], zz[NL], t[NL];
  fe_mul(a, P.X, P.X, M);
  fe_mul(b, P.Y, P.Y, M);
  fe_mul(zz, P.Z, P.Z, M);
  fe_add(t, P.X, P.Y, M);
  fe_mul(t, t, t, M);
  uint32_t c[NL], e[NL], f[NL], g[NL], h[NL];
  fe_add(c, zz, zz, M);
  fe_sub(g, b, a, M);
  fe_sub(e, t, a, M);
  fe_sub(e, e, b, M);
  fe_sub(f, g, c, M);
  fe_add(h, a, b, M);
  fe_neg(h, h, M);
  fe_mul(R.X, e, f, M);
  fe_mul(R.Y, g, h, M);
  fe_mul(R.Z, f, g, M);
  fe_mul(R.T, e, h, M);
}

// P = -P: (-X, Y, Z, -T).
__device__ __forceinline__ void pt_neg(Pt& P, const EdConsts& K) {
  fe_neg(P.X, P.X, K.fp);
  fe_neg(P.T, P.T, K.fp);
}

// Block-wide sum of one point per thread through shared memory; the total
// lands in sh[0].  blockDim.x must be a power of two, sh sized blockDim.x.
__device__ __forceinline__ void pt_block_reduce(Pt* sh, const Pt& mine, const EdConsts& K) {
  const int t = threadIdx.x;
  sh[t] = mine;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (t < s) {
      Pt acc = sh[t];
      Pt other = sh[t + s];
      pt_add(acc, acc, other, K);
      sh[t] = acc;
    }
    __syncthreads();
  }
}

}  // namespace bpp
