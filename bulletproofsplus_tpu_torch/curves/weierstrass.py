"""Complete projective arithmetic for short Weierstrass curves with a = 0
(secp256k1, bls12-381 G1).

Port of bulletproofsplus_tpu/curves/weierstrass.py:27-168. Points are
(..., 3, L) limb tensors, L = 8 on secp256k1 and 12 on bls12-381 (X, Y, Z
in Montgomery form, homogeneous projective coordinates, every coordinate
< p); the identity is (0, 1, 0), stored as
(0, R mod p, 0), and every point with Z = 0 is the identity. The
Renes–Costello–Batina formulas (eprint 2015/1060, algorithms 7 and 9 for
a = 0) are complete on these odd-order groups, so no operation special-cases
identities, doublings or inverses. They follow the TPU kernels' `_wadd` and
`_wdbl` (bulletproofsplus_tpu/curves/pallas_curve.py:77-120) step by step,
as `pt_add`/`pt_dbl` in csrc/weierstrass.cuh do; products that do not depend
on each other go to the field as one stacked call (4 calls for an add's 14
products, 4 for a doubling's 9), which gives the same values in fewer
launches.
"""
from __future__ import annotations

import torch

from .base import CurveOps


class WeierstrassOps(CurveOps):
    """Projective Weierstrass points; the kernels' constant is 3b."""

    COORDS = 3

    @property
    def FAMILY(self) -> str:
        """The kernels' build for Pt3 at this width: "weierstrass" at 8
        words, "weierstrass12" at 12 (csrc/family.cuh)."""
        return "weierstrass" if self.fp.L == 8 else f"weierstrass{self.fp.L}"

    @property
    def kconst_int(self) -> int:
        return self.host.b3

    def is_identity(self, P):
        return self.fp.is_zero(P[..., 2, :])

    def neg(self, P):
        return torch.stack([P[..., 0, :], self.fp.neg(P[..., 1, :]), P[..., 2, :]],
                           dim=-2)

    def add(self, P, Q):
        """RCB complete addition, a = 0 (algorithm 7): 14 products."""
        f = self.fp
        P, Q = torch.broadcast_tensors(P, Q)
        X1, Y1, Z1 = P.unbind(-2)
        X2, Y2, Z2 = Q.unbind(-2)
        b3 = self._c(P.device)["kconst"]
        # X1 + Y1, X2 + Y2, Y1 + Z1, Y2 + Z2, X1 + Z1, X2 + Z2
        s = f.add(torch.stack([X1, X2, Y1, Y2, X1, X2]), torch.stack([Y1, Y2, Z1, Z2, Z1, Z2]))
        m = f.mul(torch.stack([X1, Y1, Z1, s[0], s[2], s[4]]),
                  torch.stack([X2, Y2, Z2, s[1], s[3], s[5]]))
        t0, t1, t2 = m[0], m[1], m[2]
        # t3 = (X1+Y1)(X2+Y2) - t0 - t1, t4 = ... - t1 - t2, t5 = ... - t0 - t2
        t3, t4, t5 = f.sub(f.sub(m[3:], torch.stack([t0, t1, t0])), torch.stack([t1, t2, t2]))
        t0_3 = f.add(f.add(t0, t0), t0)
        t2b, t5b = f.mul(b3, torch.stack([t2, t5]))
        z3c = f.add(t1, t2b)
        t1m = f.sub(t1, t2b)
        q = f.mul(torch.stack([t3, t4, t1m, t5b, z3c, t0_3]),
                  torch.stack([t1m, t5b, z3c, t0_3, t4, t3]))
        X3 = f.sub(q[0], q[1])                    # t3·t1m - t4·t5b
        Y3, Z3 = f.add(q[2::2], q[3::2])          # t1m·z3c + t5b·3t0, z3c·t4 + 3t0·t3
        return torch.stack([X3, Y3, Z3], dim=-2)

    def dbl(self, P):
        """RCB complete doubling, a = 0 (algorithm 9): 9 products."""
        f = self.fp
        X, Y, Z = P.unbind(-2)
        b3 = self._c(P.device)["kconst"]
        t0, t1, t2, xy = f.mul(torch.stack([Y, Y, Z, X]), torch.stack([Y, Z, Z, Y]))
        z3_2 = f.add(t0, t0)
        z3_4 = f.add(z3_2, z3_2)
        z3 = f.add(z3_4, z3_4)                    # 8·Y²
        t2b = f.mul(b3, t2)
        y3c = f.add(t0, t2b)
        Z3, x3m = f.mul(torch.stack([t1, t2b]), z3)
        t0m = f.sub(t0, f.add(f.add(t2b, t2b), t2b))
        t0m_y3c, x3p = f.mul(t0m, torch.stack([y3c, xy]))
        Y3 = f.add(x3m, t0m_y3c)
        X3 = f.add(x3p, x3p)
        return torch.stack([X3, Y3, Z3], dim=-2)
