"""What the point families share: host conversions, the identity, select.

A curve's points are (..., COORDS, L) limb tensors in Montgomery form, every
coordinate < p, with L = fp.L the base field's word count (8, or 12 on
bls12-381): COORDS = 4 for extended Edwards (curves/edwards.py) and 3 for
projective Weierstrass (curves/weierstrass.py). FAMILY names the build of
each point kernel for that point type and width (entry point
bpp_<kernel>_<FAMILY>, csrc/family.cuh), and `kconst_int` is the one curve
constant their formulas multiply by (2d or 3b), packed with the modulus by
curves/cuda_curve.py.
"""
from __future__ import annotations

import functools
from typing import List, Sequence

import torch

from ..fields.ops import FieldOps
from ..fields.spec import ints_to_tensor, tensor_to_ints
from .host import Affine, HostCurve


class CurveOps:
    """Vectorized point ops over field ops `fp` (coordinates) and `fn`
    (scalars); `host` is the curve in Python ints. `plain` is the same
    curve over plain field ops (the reference inside kernels' plain
    versions, which must not launch K1)."""

    COORDS: int
    FAMILY: str

    def __init__(self, fp: FieldOps, fn: FieldOps, host: HostCurve, name: str):
        self.fp = fp
        self.fn = fn
        self.host = host
        self.name = name
        self._dev: dict = {}

    @property
    def kconst_int(self) -> int:
        raise NotImplementedError

    @functools.cached_property
    def plain(self) -> "CurveOps":
        if self.fp.is_plain:
            return self
        return type(self)(self.fp.plain, self.fn.plain, self.host, self.name)

    def _c(self, device) -> dict:
        key = str(device)
        if key not in self._dev:
            ident = [v * self.fp.spec.r_mod_p % self.fp.p for v in self.host.identity]
            self._dev[key] = {"kconst": self.fp.encode(self.kconst_int, device),
                              "identity": ints_to_tensor(ident, device, self.fp.L)}
        return self._dev[key]

    # -- host conversions -------------------------------------------------

    def encode_points(self, points: Sequence[Affine], device=None) -> torch.Tensor:
        """Affine tuples (None = identity) → (N, COORDS, L) with Z = 1."""
        vals = [v for A in points for v in self.host.lift(A)]
        return self.fp.encode(vals, device).reshape(-1, self.COORDS, self.fp.L)

    def decode_points(self, t: torch.Tensor) -> List[Affine]:
        """(..., COORDS, L) → flat list of affine tuples, one host inversion."""
        rinv, p, nc = self.fp.spec.rinv, self.fp.p, self.COORDS
        v = [x * rinv % p for x in tensor_to_ints(t)]
        return self.host.to_affine([tuple(v[i:i + nc]) for i in range(0, len(v), nc)])

    def decode_point(self, t: torch.Tensor) -> Affine:
        return self.decode_points(t)[0]

    # -- shared ops -------------------------------------------------------

    def identity(self, device) -> torch.Tensor:
        return self._c(device)["identity"]

    def identity_like(self, shape_prefix, device) -> torch.Tensor:
        return self.identity(device).expand(*shape_prefix, self.COORDS, self.fp.L)

    def select(self, mask, P, Q):
        return torch.where(torch.as_tensor(mask, device=P.device)[..., None, None],
                           P, Q)
