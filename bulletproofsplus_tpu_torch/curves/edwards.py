"""Extended-coordinate arithmetic for twisted Edwards a = -1 (edwards25519).

Port of bulletproofsplus_tpu/curves/edwards.py. Points are (..., 4, 8) limb
tensors (X, Y, Z, T with X·Y = Z·T, Montgomery form, every coordinate < p);
the identity is (0, 1, 1, 0). add-2008-hwcd-3 is complete for a = -1, so no
operation special-cases identities or doublings. The same formulas, in the
same order, are `pt_add`/`pt_dbl` in csrc/ed25519.cuh.
"""
from __future__ import annotations

import torch

from .base import CurveOps


class EdwardsOps(CurveOps):
    """Extended Edwards points; the kernels' constant is 2d."""

    COORDS = 4
    FAMILY = "edwards"

    @property
    def kconst_int(self) -> int:
        return self.host.k2d

    def is_identity(self, P):
        """X = 0 and Y = Z (coordinates are canonical)."""
        return (self.fp.is_zero(P[..., 0, :])
                & (P[..., 1, :] == P[..., 2, :]).all(dim=-1))

    def neg(self, P):
        f = self.fp
        return torch.stack([f.neg(P[..., 0, :]), P[..., 1, :], P[..., 2, :],
                            f.neg(P[..., 3, :])], dim=-2)

    def add(self, P, Q):
        """add-2008-hwcd-3 (a = -1), complete."""
        f = self.fp
        X1, Y1, Z1, T1 = P.unbind(-2)
        X2, Y2, Z2, T2 = Q.unbind(-2)
        A = f.mul(f.sub(Y1, X1), f.sub(Y2, X2))
        B = f.mul(f.add(Y1, X1), f.add(Y2, X2))
        C = f.mul(f.mul(T1, T2), self._c(P.device)["kconst"])
        D = f.mul(f.add(Z1, Z1), Z2)
        E, F, G, H = f.sub(B, A), f.sub(D, C), f.add(D, C), f.add(B, A)
        return torch.stack([f.mul(E, F), f.mul(G, H), f.mul(F, G),
                            f.mul(E, H)], dim=-2)

    def dbl(self, P):
        """dbl-2008-hwcd (a = -1)."""
        f = self.fp
        X1, Y1, Z1, _ = P.unbind(-2)
        A = f.mul(X1, X1)
        B = f.mul(Y1, Y1)
        ZZ = f.mul(Z1, Z1)
        t = f.add(X1, Y1)
        t = f.mul(t, t)
        C = f.add(ZZ, ZZ)
        G = f.sub(B, A)
        E = f.sub(f.sub(t, A), B)
        F = f.sub(G, C)
        H = f.neg(f.add(A, B))
        return torch.stack([f.mul(E, F), f.mul(G, H), f.mul(F, G),
                            f.mul(E, H)], dim=-2)
