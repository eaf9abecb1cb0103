// edwards25519 extended points (X, Y, Z, T) over field.cuh: family 0.
//
// The device counterpart of curves/edwards.py::EdwardsOps.add/dbl and of the
// TPU formulas in bulletproofsplus_tpu/curves/pallas_curve.py:46-74: the
// same add-2008-hwcd-3 and dbl-2008-hwcd sequences, so kernel and plain
// version produce identical coordinates when they add in the same order.
// A point in memory is 32 consecutive uint32: X, Y, Z, T, 8 words each,
// Montgomery form, every coordinate < p. CurveConsts::k holds 2d.
#pragma once

#include "points.cuh"

namespace bpp {

struct Pt4 {
  static constexpr int NC = 4, NL = 8;
  using Consts = CurveConsts<NL>;
  uint32_t X[NL], Y[NL], Z[NL], T[NL];
  __device__ __forceinline__ uint32_t* coord(int c) {
    return c == 0 ? X : c == 1 ? Y : c == 2 ? Z : T;
  }
  __device__ __forceinline__ const uint32_t* coord(int c) const {
    return c == 0 ? X : c == 1 ? Y : c == 2 ? Z : T;
  }
};

constexpr int NL4 = Pt4::NL;

__device__ __forceinline__ void pt_identity(Pt4& P, const Pt4::Consts& C) {
  fe_set_zero(P.X);
  fe_copy(P.Y, C.one);
  fe_copy(P.Z, C.one);
  fe_set_zero(P.T);
}

// R = P + Q, add-2008-hwcd-3 (a = -1), complete.  R may alias P or Q.
__device__ __forceinline__ void pt_add(Pt4& R, const Pt4& P, const Pt4& Q, const Pt4::Consts& K) {
  const Mod<NL4>& M = K.fp;
  uint32_t a[NL4], b[NL4], c[NL4], d[NL4], t0[NL4], t1[NL4];
  fe_sub(t0, P.Y, P.X, M);
  fe_sub(t1, Q.Y, Q.X, M);
  fe_mul(a, t0, t1, M);
  fe_add(t0, P.Y, P.X, M);
  fe_add(t1, Q.Y, Q.X, M);
  fe_mul(b, t0, t1, M);
  fe_mul(t0, P.T, Q.T, M);
  fe_mul(c, t0, K.k, M);
  fe_add(t0, P.Z, P.Z, M);
  fe_mul(d, t0, Q.Z, M);
  uint32_t e[NL4], f[NL4], g[NL4], h[NL4];
  fe_sub(e, b, a, M);
  fe_sub(f, d, c, M);
  fe_add(g, d, c, M);
  fe_add(h, b, a, M);
  fe_mul(R.X, e, f, M);
  fe_mul(R.Y, g, h, M);
  fe_mul(R.Z, f, g, M);
  fe_mul(R.T, e, h, M);
}

// R = P + Q by the four lanes of a quad (points.cuh, pt_add_quad), each
// holding the same P and Q: pt_add's products in three rounds, (Y1 − X1)(Y2
// − X2), (Y1 + X1)(Y2 + X2), T1·T2 and 2Z1·Z2 one a lane, then c = 2d·T1·T2
// in every lane, then X3 = e·f, Y3 = g·h, Z3 = f·g, T3 = e·h one a lane.
// R may alias P or Q.
__device__ __forceinline__ void pt_add_quad(Pt4& R, const Pt4& P, const Pt4& Q,
                                            const Pt4::Consts& K) {
  const Mod<NL4>& M = K.fp;
  const int r = threadIdx.x & 3;
  uint32_t zero[NL4], u[NL4], v[NL4], su[NL4], ad[NL4], m[NL4];
  fe_set_zero(zero);
  // lane 0: Y − X, 1: Y + X, 2: T + 0, 3: Z + Z, for each of P and Q (Q's Z
  // is not doubled)
  fe_pick<NL4>(u, r, P.Y, P.Y, P.T, P.Z);
  fe_pick<NL4>(v, r, P.X, P.X, zero, P.Z);
  fe_sub(su, u, v, M);
  fe_add(ad, u, v, M);
  fe_pick<NL4>(u, r, su, ad, ad, ad);
  fe_pick<NL4>(su, r, Q.Y, Q.Y, Q.T, Q.Z);
  fe_pick<NL4>(ad, r, Q.X, Q.X, zero, zero);
  fe_sub(m, su, ad, M);
  fe_add(v, su, ad, M);
  fe_pick<NL4>(v, r, m, v, v, v);
  fe_mul(m, u, v, M);
  uint32_t a[NL4], b[NL4], c[NL4], d[NL4];
  fe_from_lane<NL4>(a, m, 0);
  fe_from_lane<NL4>(b, m, 1);
  fe_from_lane<NL4>(u, m, 2);
  fe_from_lane<NL4>(d, m, 3);
  fe_mul(c, u, K.k, M);
  uint32_t e[NL4], f[NL4], g[NL4], h[NL4];
  fe_sub(e, b, a, M);
  fe_sub(f, d, c, M);
  fe_add(g, d, c, M);
  fe_add(h, b, a, M);
  fe_pick<NL4>(u, r, e, g, f, e);
  fe_pick<NL4>(v, r, f, h, g, h);
  fe_mul(m, u, v, M);
  fe_from_lane<NL4>(R.X, m, 0);
  fe_from_lane<NL4>(R.Y, m, 1);
  fe_from_lane<NL4>(R.Z, m, 2);
  fe_from_lane<NL4>(R.T, m, 3);
}

// R = 2P, dbl-2008-hwcd (a = -1).  R may alias P.
__device__ __forceinline__ void pt_dbl(Pt4& R, const Pt4& P, const Pt4::Consts& K) {
  const Mod<NL4>& M = K.fp;
  uint32_t a[NL4], b[NL4], zz[NL4], t[NL4];
  fe_mul(a, P.X, P.X, M);
  fe_mul(b, P.Y, P.Y, M);
  fe_mul(zz, P.Z, P.Z, M);
  fe_add(t, P.X, P.Y, M);
  fe_mul(t, t, t, M);
  uint32_t c[NL4], e[NL4], f[NL4], g[NL4], h[NL4];
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

// R = 2P by the four lanes of a quad (points.cuh, pt_add_quad), each
// holding the same P: pt_dbl's products in two rounds, X·X, Y·Y, Z·Z and
// (X + Y)·(X + Y) one a lane, then X3 = e·f, Y3 = g·h, Z3 = f·g, T3 = e·h
// one a lane. R lands in all four lanes, equal word for word to pt_dbl's.
// R may alias P.
__device__ __forceinline__ void pt_dbl_quad(Pt4& R, const Pt4& P, const Pt4::Consts& K) {
  const Mod<NL4>& M = K.fp;
  const int r = threadIdx.x & 3;
  uint32_t u[NL4], v[NL4], m[NL4];
  fe_add(v, P.X, P.Y, M);
  fe_pick<NL4>(u, r, P.X, P.Y, P.Z, v);
  fe_mul(m, u, u, M);
  uint32_t a[NL4], b[NL4], zz[NL4], t[NL4];
  fe_from_lane<NL4>(a, m, 0);
  fe_from_lane<NL4>(b, m, 1);
  fe_from_lane<NL4>(zz, m, 2);
  fe_from_lane<NL4>(t, m, 3);
  uint32_t c[NL4], e[NL4], f[NL4], g[NL4], h[NL4];
  fe_add(c, zz, zz, M);
  fe_sub(g, b, a, M);
  fe_sub(e, t, a, M);
  fe_sub(e, e, b, M);
  fe_sub(f, g, c, M);
  fe_add(h, a, b, M);
  fe_neg(h, h, M);
  fe_pick<NL4>(u, r, e, g, f, e);
  fe_pick<NL4>(v, r, f, h, g, h);
  fe_mul(m, u, v, M);
  fe_from_lane<NL4>(R.X, m, 0);
  fe_from_lane<NL4>(R.Y, m, 1);
  fe_from_lane<NL4>(R.Z, m, 2);
  fe_from_lane<NL4>(R.T, m, 3);
}

// P = -P: (-X, Y, Z, -T).
__device__ __forceinline__ void pt_neg(Pt4& P, const Pt4::Consts& K) {
  fe_neg(P.X, P.X, K.fp);
  fe_neg(P.T, P.T, K.fp);
}

}  // namespace bpp
