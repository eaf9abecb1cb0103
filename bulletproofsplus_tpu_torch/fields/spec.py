"""Field specifications: modulus → Montgomery constants for the port's limbs.

Layout (the one layout of every tensor, kernel boundary and plain version):
a field element is 8 little-endian limbs of 32 bits, held as the int32 bit
patterns of uint32 words in a (..., 8) tensor, R = 2^256, Montgomery form
x·R mod p unless a function says "plain". Hopper multiplies 32×32 → 64 bits
natively, so the kernels take whole words; the JAX package's 12-bit limbs
exist only because TPU lanes are int32 (bulletproofsplus_tpu/fields/spec.py).

Every operation here returns fully reduced values (< p). The ed25519 moduli
lie below 2^255 and the secp256k1 moduli above it, so a sum of two elements
or an unreduced Montgomery product can carry out of the top word; the
reductions take that carry as a top bit (fields/mont_mul.py::reduce_once).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Sequence

import numpy as np
import torch

NUM_LIMBS = 8
LIMB_BITS = 32
R = 1 << (NUM_LIMBS * LIMB_BITS)

ED25519_P = 2**255 - 19
ED25519_L = 2**252 + 27742317777372353535851937790883648493
SECP256K1_P = 2**256 - 2**32 - 977
SECP256K1_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """A prime field in the 8 × 32-bit limb layout."""

    name: str
    modulus: int

    @functools.cached_property
    def r_mod_p(self) -> int:
        return R % self.modulus

    @functools.cached_property
    def r2_mod_p(self) -> int:
        return R * R % self.modulus

    @functools.cached_property
    def rinv(self) -> int:
        return pow(R, -1, self.modulus)

    @functools.cached_property
    def nprime(self) -> int:
        """-p^{-1} mod R (the separated-REDC multiplier of the plain path)."""
        return (-pow(self.modulus, -1, R)) % R

    @functools.cached_property
    def n0inv(self) -> int:
        """-p^{-1} mod 2^32 (the word-serial CIOS multiplier of the kernels)."""
        return self.nprime & 0xFFFFFFFF

    @property
    def p_words(self) -> List[int]:
        return int_to_words(self.modulus)


ED25519_FP = FieldSpec("ed25519_fp", ED25519_P)
ED25519_FL = FieldSpec("ed25519_fl", ED25519_L)
SECP256K1_FP = FieldSpec("secp256k1_fp", SECP256K1_P)
SECP256K1_FN = FieldSpec("secp256k1_fn", SECP256K1_N)


def int_to_words(x: int) -> List[int]:
    """Nonnegative int < 2^256 → 8 little-endian uint32 words."""
    if not 0 <= x < R:
        raise ValueError("value does not fit in 8 limbs of 32 bits")
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(NUM_LIMBS)]


def ints_to_tensor(xs: Sequence[int], device=None) -> torch.Tensor:
    """Ints < 2^256 → (N, 8) int32 tensor of their uint32 limb patterns."""
    blob = b"".join(int(x).to_bytes(32, "little") for x in xs)
    arr = np.frombuffer(blob, dtype="<u4").view(np.int32).reshape(-1, NUM_LIMBS)
    return torch.from_numpy(arr.copy()).to(device)


def tensor_to_ints(t: torch.Tensor) -> List[int]:
    """(..., 8) int32 limb tensor → flat list of ints (row-major order)."""
    arr = t.detach().to("cpu").contiguous().numpy().astype("<u4", copy=False)
    raw = arr.reshape(-1, NUM_LIMBS).tobytes()
    return [int.from_bytes(raw[i:i + 32], "little")
            for i in range(0, len(raw), 32)]

