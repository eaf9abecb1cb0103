"""The port's curve backends by name.

Counterpart of bulletproofsplus_tpu/curves/instances.py: edwards25519
(extended Edwards) and secp256k1 (projective Weierstrass, a = 0, b = 7).
bls12-381, whose base field needs 12 limbs of 32 bits, comes with a later
slice.
"""
from __future__ import annotations

import functools

from ..fields import ED25519_FL, ED25519_FP, SECP256K1_FN, SECP256K1_FP, FieldOps
from . import host
from .base import CurveOps
from .edwards import EdwardsOps
from .weierstrass import WeierstrassOps

CURVE_NAMES = ("edwards25519", "secp256k1")


@functools.lru_cache(maxsize=None)
def curve_ops(name: str = "edwards25519") -> CurveOps:
    """Vectorized curve backend by name."""
    if name == "edwards25519":
        return EdwardsOps(FieldOps(ED25519_FP), FieldOps(ED25519_FL), host.ED25519, name)
    if name == "secp256k1":
        return WeierstrassOps(FieldOps(SECP256K1_FP), FieldOps(SECP256K1_FN),
                              host.SECP256K1, name)
    raise ValueError(f"curve {name!r} is not ported yet")
