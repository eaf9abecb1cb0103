"""Prime fields in the port's 8 × 32-bit limb layout (see spec.py)."""
from .ops import FieldOps
from .spec import ED25519_FL, ED25519_FP, SECP256K1_FN, SECP256K1_FP, FieldSpec

__all__ = ["ED25519_FL", "ED25519_FP", "FieldOps", "FieldSpec", "SECP256K1_FN",
           "SECP256K1_FP"]
