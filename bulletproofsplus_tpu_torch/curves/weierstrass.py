"""Complete projective arithmetic for short Weierstrass curves with a = 0
(secp256k1).

Port of bulletproofsplus_tpu/curves/weierstrass.py:27-168. Points are
(..., 3, 8) limb tensors (X, Y, Z in Montgomery form, homogeneous projective
coordinates, every coordinate < p); the identity is (0, 1, 0), stored as
(0, R mod p, 0), and every point with Z = 0 is the identity. The
Renes–Costello–Batina formulas (eprint 2015/1060, algorithms 7 and 9 for
a = 0) are complete on these odd-order groups, so no operation special-cases
identities, doublings or inverses. They follow the TPU kernels' `_wadd` and
`_wdbl` (bulletproofsplus_tpu/curves/pallas_curve.py:77-120) step by step,
as `pt_add`/`pt_dbl` in csrc/weierstrass.cuh do.
"""
from __future__ import annotations

import torch

from .base import CurveOps


class WeierstrassOps(CurveOps):
    """Projective Weierstrass points; the kernels' constant is 3b."""

    COORDS = 3
    FAMILY = "weierstrass"

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
        X1, Y1, Z1 = P.unbind(-2)
        X2, Y2, Z2 = Q.unbind(-2)
        b3 = self._c(P.device)["kconst"]
        t0 = f.mul(X1, X2)
        t1 = f.mul(Y1, Y2)
        t2 = f.mul(Z1, Z2)
        t3 = f.sub(f.sub(f.mul(f.add(X1, Y1), f.add(X2, Y2)), t0), t1)
        t4 = f.sub(f.sub(f.mul(f.add(Y1, Z1), f.add(Y2, Z2)), t1), t2)
        t5 = f.sub(f.sub(f.mul(f.add(X1, Z1), f.add(X2, Z2)), t0), t2)
        t0_3 = f.add(f.add(t0, t0), t0)
        t2b = f.mul(b3, t2)
        t5b = f.mul(b3, t5)
        z3c = f.add(t1, t2b)
        t1m = f.sub(t1, t2b)
        X3 = f.sub(f.mul(t3, t1m), f.mul(t4, t5b))
        Y3 = f.add(f.mul(t1m, z3c), f.mul(t5b, t0_3))
        Z3 = f.add(f.mul(z3c, t4), f.mul(t0_3, t3))
        return torch.stack([X3, Y3, Z3], dim=-2)

    def dbl(self, P):
        """RCB complete doubling, a = 0 (algorithm 9): 9 products."""
        f = self.fp
        X, Y, Z = P.unbind(-2)
        b3 = self._c(P.device)["kconst"]
        t0 = f.mul(Y, Y)
        t1 = f.mul(Y, Z)
        t2 = f.mul(Z, Z)
        xy = f.mul(X, Y)
        z3_2 = f.add(t0, t0)
        z3_4 = f.add(z3_2, z3_2)
        z3 = f.add(z3_4, z3_4)                    # 8·Y²
        t2b = f.mul(b3, t2)
        y3c = f.add(t0, t2b)
        Z3 = f.mul(t1, z3)
        x3m = f.mul(t2b, z3)
        t0m = f.sub(t0, f.add(f.add(t2b, t2b), t2b))
        Y3 = f.add(x3m, f.mul(t0m, y3c))
        x3p = f.mul(t0m, xy)
        X3 = f.add(x3p, x3p)
        return torch.stack([X3, Y3, Z3], dim=-2)
