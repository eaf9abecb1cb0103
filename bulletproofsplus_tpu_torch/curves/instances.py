"""The port's curve backend: edwards25519 only (the batch-verify slice).

Counterpart of bulletproofsplus_tpu/curves/instances.py. The secp256k1 and
bls12-381 Weierstrass backends come with a later slice.
"""
from __future__ import annotations

import functools

from ..fields import ED25519_FL, ED25519_FP, FieldOps
from . import host
from .edwards import EdwardsOps

CURVE_NAMES = ("edwards25519",)


@functools.lru_cache(maxsize=None)
def curve_ops(name: str = "edwards25519") -> EdwardsOps:
    """Vectorized curve backend by name."""
    if name != "edwards25519":
        raise ValueError(f"curve {name!r} is not ported yet")
    return EdwardsOps(FieldOps(ED25519_FP), FieldOps(ED25519_FL), d=host.ED_D,
                      name=name)
