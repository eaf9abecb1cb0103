"""Extended-coordinate arithmetic for twisted Edwards a = -1 (edwards25519).

Port of bulletproofsplus_tpu/curves/edwards.py. Points are (..., 4, 8) limb
tensors (X, Y, Z, T with X·Y = Z·T, Montgomery form, every coordinate < p);
the identity is (0, 1, 1, 0). add-2008-hwcd-3 is complete for a = -1, so no
operation special-cases identities or doublings. The same formulas, in the
same order, are `pt_add`/`pt_dbl` in csrc/ed25519.cuh.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import torch

from ..fields.ops import FieldOps
from ..fields.spec import ints_to_tensor, tensor_to_ints
from . import host

Affine = Optional[Tuple[int, int]]


class EdwardsOps:
    """Vectorized point ops over field ops `fp` (coordinates) and `fn`
    (scalars). `plain` is the same curve over plain field ops."""

    def __init__(self, fp: FieldOps, fn: FieldOps, d: int, name: str):
        self.fp = fp
        self.fn = fn
        self.d = d
        self.name = name
        self.k2d_int = 2 * d % fp.p
        self._dev: dict = {}

    @functools.cached_property
    def plain(self) -> "EdwardsOps":
        if self.fp.is_plain:
            return self
        return EdwardsOps(self.fp.plain, self.fn.plain, self.d, self.name)

    def _c(self, device) -> dict:
        key = str(device)
        if key not in self._dev:
            one = self.fp.spec.r_mod_p
            self._dev[key] = {
                "k2d": self.fp.encode(self.k2d_int, device),
                "identity": ints_to_tensor([0, one, one, 0], device),
            }
        return self._dev[key]

    # -- host conversions -------------------------------------------------

    def encode_points(self, points: Sequence[Affine], device=None) -> torch.Tensor:
        """Affine tuples (None = identity) → (N, 4, 8) with Z = 1."""
        p = self.fp.p
        vals = []
        for A in points:
            x, y = (0, 1) if A is None else A
            vals += [x, y, 1, x * y % p]
        return self.fp.encode(vals, device).reshape(-1, 4, self.fp.L)

    def decode_points(self, t: torch.Tensor) -> List[Affine]:
        """(..., 4, 8) → flat list of affine tuples, one host inversion."""
        rinv, p = self.fp.spec.rinv, self.fp.p
        v = [x * rinv % p for x in tensor_to_ints(t)]
        return host.to_affine([tuple(v[i:i + 4]) for i in range(0, len(v), 4)])

    def decode_point(self, t: torch.Tensor) -> Affine:
        return self.decode_points(t)[0]

    # -- core ops ---------------------------------------------------------

    def identity(self, device) -> torch.Tensor:
        return self._c(device)["identity"]

    def identity_like(self, shape_prefix, device) -> torch.Tensor:
        return self.identity(device).expand(*shape_prefix, 4, self.fp.L)

    def is_identity(self, P):
        """X = 0 and Y = Z (coordinates are canonical)."""
        return (self.fp.is_zero(P[..., 0, :])
                & (P[..., 1, :] == P[..., 2, :]).all(dim=-1))

    def select(self, mask, P, Q):
        return torch.where(torch.as_tensor(mask, device=P.device)[..., None, None],
                           P, Q)

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
        C = f.mul(f.mul(T1, T2), self._c(P.device)["k2d"])
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
