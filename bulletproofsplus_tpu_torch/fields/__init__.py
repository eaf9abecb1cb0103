"""Prime fields in the port's layout of 32-bit limbs, 8 or 12 words (see spec.py)."""
from .ops import FieldOps
from .spec import (
    BLS12_381_FQ,
    BLS12_381_FR,
    ED25519_FL,
    ED25519_FP,
    SECP256K1_FN,
    SECP256K1_FP,
    FieldSpec,
)

__all__ = ["BLS12_381_FQ", "BLS12_381_FR", "ED25519_FL", "ED25519_FP", "FieldOps",
           "FieldSpec", "SECP256K1_FN", "SECP256K1_FP"]
