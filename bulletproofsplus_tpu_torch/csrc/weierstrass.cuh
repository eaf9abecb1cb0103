// Projective Weierstrass points (X, Y, Z) with a = 0 over field.cuh, at N
// words a coordinate: family 1 (N = 8, secp256k1) and family 2 (N = 12,
// bls12-381 G1).
//
// The device counterpart of curves/weierstrass.py::WeierstrassOps and of the
// TPU formulas `_wadd`/`_wdbl` in bulletproofsplus_tpu/curves/
// pallas_curve.py:77-120: the Renes–Costello–Batina complete formulas
// (eprint 2015/1060, algorithms 7 and 9 for a = 0), step for step, so kernel
// and plain version produce identical coordinates when they add in the same
// order. They are complete on odd-order groups: no case for the identity,
// doublings or inverses. The identity is (0, 1, 0); a point with Z = 0 is the
// identity. A point in memory is 3·N consecutive uint32 (96 bytes at N = 8,
// 144 at N = 12): X, Y, Z, Montgomery form, every coordinate < p.
// CurveConsts::k holds 3b. The formulas keep more values alive than hwcd
// does (an add holds eight temporaries besides its operands, 8·N registers);
// the build log's ptxas lines show each kernel's registers and spills.
#pragma once

#include "points.cuh"

namespace bpp {

template <int N>
struct Pt3 {
  static constexpr int NC = 3, NL = N;
  using Consts = CurveConsts<N>;
  uint32_t X[N], Y[N], Z[N];
  __device__ __forceinline__ uint32_t* coord(int c) { return c == 0 ? X : c == 1 ? Y : Z; }
  __device__ __forceinline__ const uint32_t* coord(int c) const {
    return c == 0 ? X : c == 1 ? Y : Z;
  }
};

template <int N>
__device__ __forceinline__ void pt_identity(Pt3<N>& P, const CurveConsts<N>& C) {
  fe_set_zero(P.X);
  fe_copy(P.Y, C.one);
  fe_set_zero(P.Z);
}

// R = P + Q, RCB algorithm 7 (a = 0), complete: 14 products.  R may alias
// P or Q (both are read before R is written).
template <int N>
__device__ __forceinline__ void pt_add(Pt3<N>& R, const Pt3<N>& P, const Pt3<N>& Q,
                                       const CurveConsts<N>& K) {
  const Mod<N>& M = K.fp;
  uint32_t t0[N], t1[N], t2[N], t3[N], t4[N], t5[N], u[N], v[N];
  fe_mul(t0, P.X, Q.X, M);
  fe_mul(t1, P.Y, Q.Y, M);
  fe_mul(t2, P.Z, Q.Z, M);
  fe_add(u, P.X, P.Y, M);  // t3 = (X1 + Y1)(X2 + Y2) - t0 - t1
  fe_add(v, Q.X, Q.Y, M);
  fe_mul(t3, u, v, M);
  fe_sub(t3, t3, t0, M);
  fe_sub(t3, t3, t1, M);
  fe_add(u, P.Y, P.Z, M);  // t4 = (Y1 + Z1)(Y2 + Z2) - t1 - t2
  fe_add(v, Q.Y, Q.Z, M);
  fe_mul(t4, u, v, M);
  fe_sub(t4, t4, t1, M);
  fe_sub(t4, t4, t2, M);
  fe_add(u, P.X, P.Z, M);  // t5 = (X1 + Z1)(X2 + Z2) - t0 - t2
  fe_add(v, Q.X, Q.Z, M);
  fe_mul(t5, u, v, M);
  fe_sub(t5, t5, t0, M);
  fe_sub(t5, t5, t2, M);
  fe_add(u, t0, t0, M);    // t0 := 3·t0
  fe_add(t0, u, t0, M);
  fe_mul(t2, K.k, t2, M);  // t2 := b3·t2
  fe_mul(t5, K.k, t5, M);  // t5 := b3·t5
  fe_add(u, t1, t2, M);    // z3c = t1 + b3·t2
  fe_sub(t1, t1, t2, M);   // t1m = t1 - b3·t2
  fe_mul(v, t3, t1, M);    // X3 = t3·t1m - t4·t5
  fe_mul(t2, t4, t5, M);
  fe_sub(R.X, v, t2, M);
  fe_mul(v, t1, u, M);     // Y3 = t1m·z3c + t5·3t0
  fe_mul(t2, t5, t0, M);
  fe_add(R.Y, v, t2, M);
  fe_mul(v, u, t4, M);     // Z3 = z3c·t4 + 3t0·t3
  fe_mul(t2, t0, t3, M);
  fe_add(R.Z, v, t2, M);
}

// R = P + Q by the four lanes of a quad (points.cuh, pt_add_quad), each
// holding the same P and Q: pt_add's 14 products in four rounds, one a lane
// (X1X2, Y1Y2, Z1Z2, (X1 + Y1)(X2 + Y2); (Y1 + Z1)(Y2 + Z2), (X1 + Z1)(X2 +
// Z2), b3·t2, 3t0·t3; b3·t5, t3·t1m, t1m·z3c, z3c·t4; t4·t5, t5·3t0).
// R may alias P or Q.
template <int N>
__device__ __forceinline__ void pt_add_quad(Pt3<N>& R, const Pt3<N>& P, const Pt3<N>& Q,
                                            const CurveConsts<N>& K) {
  const Mod<N>& M = K.fp;
  const int r = threadIdx.x & 3;
  uint32_t u[N], v[N], m[N], w[N];
  fe_add(w, P.X, P.Y, M);
  fe_pick<N>(u, r, P.X, P.Y, P.Z, w);
  fe_add(w, Q.X, Q.Y, M);
  fe_pick<N>(v, r, Q.X, Q.Y, Q.Z, w);
  fe_mul(m, u, v, M);
  uint32_t t0[N], t1[N], t2[N], t3[N];
  fe_from_lane<N>(t0, m, 0);
  fe_from_lane<N>(t1, m, 1);
  fe_from_lane<N>(t2, m, 2);
  fe_from_lane<N>(t3, m, 3);
  fe_sub(t3, t3, t0, M);   // t3 = (X1 + Y1)(X2 + Y2) - t0 - t1
  fe_sub(t3, t3, t1, M);
  uint32_t x3[N];          // 3·t0
  fe_add(x3, t0, t0, M);
  fe_add(x3, x3, t0, M);
  fe_add(u, P.Y, P.Z, M);
  fe_add(w, P.X, P.Z, M);
  fe_pick<N>(u, r, u, w, K.k, x3);
  fe_add(v, Q.Y, Q.Z, M);
  fe_add(w, Q.X, Q.Z, M);
  fe_pick<N>(v, r, v, w, t2, t3);
  fe_mul(m, u, v, M);
  uint32_t t4[N], t5[N], b2[N], z3[N];
  fe_from_lane<N>(t4, m, 0);
  fe_from_lane<N>(t5, m, 1);
  fe_from_lane<N>(b2, m, 2);   // b3·t2
  fe_from_lane<N>(z3, m, 3);   // 3t0·t3, Z3's second product
  fe_sub(t4, t4, t1, M);   // t4 = (Y1 + Z1)(Y2 + Z2) - t1 - t2
  fe_sub(t4, t4, t2, M);
  fe_sub(t5, t5, t0, M);   // t5 = (X1 + Z1)(X2 + Z2) - t0 - t2
  fe_sub(t5, t5, t2, M);
  fe_add(t0, t1, b2, M);   // z3c = t1 + b3·t2
  fe_sub(t1, t1, b2, M);   // t1m = t1 - b3·t2
  fe_pick<N>(u, r, K.k, t3, t1, t0);
  fe_pick<N>(v, r, t5, t1, t0, t4);
  fe_mul(m, u, v, M);
  uint32_t p1[N], p3[N], p5[N];
  fe_from_lane<N>(t5, m, 0);   // b3·t5
  fe_from_lane<N>(p1, m, 1);   // t3·t1m
  fe_from_lane<N>(p3, m, 2);   // t1m·z3c
  fe_from_lane<N>(p5, m, 3);   // z3c·t4
  fe_pick<N>(u, r & 1, t4, t5, t4, t5);
  fe_pick<N>(v, r & 1, t5, x3, t5, x3);
  fe_mul(m, u, v, M);
  fe_from_lane<N>(u, m, 0);    // t4·t5
  fe_from_lane<N>(v, m, 1);    // t5·3t0
  fe_sub(R.X, p1, u, M);
  fe_add(R.Y, p3, v, M);
  fe_add(R.Z, p5, z3, M);
}

// R = 2P, RCB algorithm 9 (a = 0), complete: 9 products.  R may alias P.
template <int N>
__device__ __forceinline__ void pt_dbl(Pt3<N>& R, const Pt3<N>& P, const CurveConsts<N>& K) {
  const Mod<N>& M = K.fp;
  uint32_t t0[N], t1[N], t2[N], xy[N], z3[N], y3[N];
  fe_mul(t0, P.Y, P.Y, M);
  fe_mul(t1, P.Y, P.Z, M);
  fe_mul(t2, P.Z, P.Z, M);
  fe_mul(xy, P.X, P.Y, M);
  fe_add(z3, t0, t0, M);   // z3 = 8·t0
  fe_add(z3, z3, z3, M);
  fe_add(z3, z3, z3, M);
  fe_mul(t2, K.k, t2, M);  // t2b = b3·t2
  fe_add(y3, t0, t2, M);   // y3c = t0 + t2b
  fe_mul(R.Z, t1, z3, M);  // Z3 = t1·z3
  fe_mul(z3, t2, z3, M);   // x3m = t2b·z3
  fe_add(t1, t2, t2, M);   // t0m = t0 - 3·t2b
  fe_add(t1, t1, t2, M);
  fe_sub(t0, t0, t1, M);
  fe_mul(y3, t0, y3, M);   // Y3 = x3m + t0m·y3c
  fe_add(R.Y, z3, y3, M);
  fe_mul(xy, t0, xy, M);   // X3 = 2·t0m·xy
  fe_add(R.X, xy, xy, M);
}

// R = 2P by the four lanes of a quad (points.cuh, pt_add_quad), each
// holding the same P: pt_dbl's 9 products in three rounds, one a lane (Y·Y,
// Y·Z, Z·Z, X·Y; b3·t2 and t1·z3 on lanes 0 and 1, lanes 2 and 3 repeating
// them; t2b·z3, t0m·y3c, t0m·xy on lanes 0-2, lane 3 repeating the last).
// R lands in all four lanes, equal word for word to pt_dbl's. R may alias P.
template <int N>
__device__ __forceinline__ void pt_dbl_quad(Pt3<N>& R, const Pt3<N>& P,
                                            const CurveConsts<N>& K) {
  const Mod<N>& M = K.fp;
  const int r = threadIdx.x & 3;
  uint32_t u[N], v[N], m[N];
  fe_pick<N>(u, r, P.Y, P.Y, P.Z, P.X);
  fe_pick<N>(v, r, P.Y, P.Z, P.Z, P.Y);
  fe_mul(m, u, v, M);
  uint32_t t0[N], t1[N], t2[N], xy[N], z3[N];
  fe_from_lane<N>(t0, m, 0);
  fe_from_lane<N>(t1, m, 1);
  fe_from_lane<N>(t2, m, 2);
  fe_from_lane<N>(xy, m, 3);
  fe_add(z3, t0, t0, M);   // z3 = 8·t0
  fe_add(z3, z3, z3, M);
  fe_add(z3, z3, z3, M);
  fe_pick<N>(u, r & 1, K.k, t1, K.k, t1);
  fe_pick<N>(v, r & 1, t2, z3, t2, z3);
  fe_mul(m, u, v, M);
  fe_from_lane<N>(t2, m, 0);   // t2b = b3·t2
  fe_from_lane<N>(t1, m, 1);   // Z3 = t1·z3
  uint32_t y3[N];
  fe_add(y3, t0, t2, M);   // y3c = t0 + t2b
  fe_add(u, t2, t2, M);    // t0m = t0 - 3·t2b
  fe_add(u, u, t2, M);
  fe_sub(t0, t0, u, M);
  fe_pick<N>(u, r, t2, t0, t0, t0);
  fe_pick<N>(v, r, z3, y3, xy, xy);
  fe_mul(m, u, v, M);
  fe_from_lane<N>(z3, m, 0);   // x3m = t2b·z3
  fe_from_lane<N>(y3, m, 1);   // t0m·y3c
  fe_from_lane<N>(xy, m, 2);   // t0m·xy
  fe_add(R.Y, z3, y3, M);  // Y3 = x3m + t0m·y3c
  fe_add(R.X, xy, xy, M);  // X3 = 2·t0m·xy
  fe_copy(R.Z, t1);
}

// P = -P: (X, -Y, Z).
template <int N>
__device__ __forceinline__ void pt_neg(Pt3<N>& P, const CurveConsts<N>& K) {
  fe_neg(P.Y, P.Y, K.fp);
}

}  // namespace bpp
