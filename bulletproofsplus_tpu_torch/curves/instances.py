"""The port's curve backends by name.

Counterpart of bulletproofsplus_tpu/curves/instances.py: edwards25519
(extended Edwards), secp256k1 (projective Weierstrass, a = 0, b = 7) and
bls12-381 G1 (projective Weierstrass, a = 0, b = 4), whose 381-bit base
field Fq takes 12 limbs of 32 bits while its scalars (Fr, 255 bits) take 8.
"""
from __future__ import annotations

import functools

from ..fields import (
    BLS12_381_FQ,
    BLS12_381_FR,
    ED25519_FL,
    ED25519_FP,
    SECP256K1_FN,
    SECP256K1_FP,
    FieldOps,
)
from . import host
from .base import CurveOps
from .edwards import EdwardsOps
from .weierstrass import WeierstrassOps

CURVE_NAMES = ("edwards25519", "secp256k1", "bls12_381")


@functools.lru_cache(maxsize=None)
def curve_ops(name: str = "edwards25519") -> CurveOps:
    """Vectorized curve backend by name."""
    if name == "edwards25519":
        return EdwardsOps(FieldOps(ED25519_FP), FieldOps(ED25519_FL), host.ED25519, name)
    if name == "secp256k1":
        return WeierstrassOps(FieldOps(SECP256K1_FP), FieldOps(SECP256K1_FN),
                              host.SECP256K1, name)
    if name == "bls12_381":
        return WeierstrassOps(FieldOps(BLS12_381_FQ), FieldOps(BLS12_381_FR),
                              host.BLS12_381, name)
    raise ValueError(f"curve {name!r} is not ported yet")
