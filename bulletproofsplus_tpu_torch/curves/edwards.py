"""Extended-coordinate arithmetic for twisted Edwards a = -1 (edwards25519).

Port of bulletproofsplus_tpu/curves/edwards.py. Points are (..., 4, 8) limb
tensors (X, Y, Z, T with X·Y = Z·T, Montgomery form, every coordinate < p);
the identity is (0, 1, 1, 0). add-2008-hwcd-3 is complete for a = -1, so no
operation special-cases identities or doublings. The same formulas, in the
same order, are `pt_add`/`pt_dbl` in csrc/ed25519.cuh; products that do not
depend on each other go to the field as one stacked call.
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
        P, Q = torch.broadcast_tensors(P, Q)
        X1, Y1, Z1, T1 = P.unbind(-2)
        X2, Y2, Z2, T2 = Q.unbind(-2)
        d1, d2 = f.sub(torch.stack([Y1, Y2]), torch.stack([X1, X2]))
        s1, s2, z2 = f.add(torch.stack([Y1, Y2, Z1]), torch.stack([X1, X2, Z1]))
        A, B, TT, D = f.mul(torch.stack([d1, s1, T1, z2]), torch.stack([d2, s2, T2, Z2]))
        C = f.mul(TT, self._c(P.device)["kconst"])
        E, F = f.sub(torch.stack([B, D]), torch.stack([A, C]))
        G, H = f.add(torch.stack([D, B]), torch.stack([C, A]))
        return f.mul(torch.stack([E, G, F, E], dim=-2), torch.stack([F, H, G, H], dim=-2))

    def dbl(self, P):
        """dbl-2008-hwcd (a = -1)."""
        f = self.fp
        X1, Y1, Z1, _ = P.unbind(-2)
        sq = torch.stack([X1, Y1, Z1, f.add(X1, Y1)])
        A, B, ZZ, t = f.mul(sq, sq)
        C = f.add(ZZ, ZZ)
        G = f.sub(B, A)
        E = f.sub(f.sub(t, A), B)
        F = f.sub(G, C)
        H = f.neg(f.add(A, B))
        return f.mul(torch.stack([E, G, F, E], dim=-2), torch.stack([F, H, G, H], dim=-2))
