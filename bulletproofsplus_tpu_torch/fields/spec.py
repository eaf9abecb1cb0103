"""Field specifications: modulus → Montgomery constants for the port's limbs.

Layout (the one layout of every tensor, kernel boundary and plain version):
a field element is L little-endian limbs of 32 bits, held as the int32 bit
patterns of uint32 words in a (..., L) tensor, R = 2^(32·L), Montgomery form
x·R mod p unless a function says "plain". Each field carries its own L
(`FieldSpec.num_limbs`): 8 words (R = 2^256) for every scalar field and the
256-bit base fields, 12 words (R = 2^384) for bls12-381's 381-bit Fq. Hopper
multiplies 32×32 → 64 bits natively, so the kernels take whole words; the
JAX package's 12-bit limbs exist only because TPU lanes are int32
(bulletproofsplus_tpu/fields/spec.py).

Every operation here returns fully reduced values (< p). The ed25519 moduli
lie below 2^255 and the secp256k1 moduli above it, so a sum of two elements
or an unreduced Montgomery product can carry out of the top word; the
reductions take that carry as a top bit (fields/mont_mul.py::reduce_once).
bls12-381's Fq leaves 3 bits of headroom in 384, so nothing there carries,
and no value is ever left unreduced.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Sequence

import numpy as np
import torch

NUM_LIMBS = 8          # words of a scalar and of a 256-bit base-field element
LIMB_BITS = 32
DIVSTEP_BLOCK = 30     # divsteps a block of the inversion (fe_inv), bits of its limbs
INV_LIMBS_MAX = 13     # signed 30-bit limbs of a 12-word value and its sign

ED25519_P = 2**255 - 19
ED25519_L = 2**252 + 27742317777372353535851937790883648493
SECP256K1_P = 2**256 - 2**32 - 977
SECP256K1_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
# bls12-381: Fr (255 bits, the group order) and Fq (381 bits, G1 coordinates)
BLS12_381_R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
BLS12_381_Q = int("1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F624"
                  "1EABFFFEB153FFFFB9FEFFFFFFFFAAAB", 16)


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """A prime field in the layout of `num_limbs` 32-bit words, R = 2^(32·L)."""

    name: str
    modulus: int
    num_limbs: int = NUM_LIMBS

    @property
    def R(self) -> int:
        return 1 << (LIMB_BITS * self.num_limbs)

    @functools.cached_property
    def r_mod_p(self) -> int:
        return self.R % self.modulus

    @functools.cached_property
    def r2_mod_p(self) -> int:
        return self.R * self.R % self.modulus

    @functools.cached_property
    def rinv(self) -> int:
        return pow(self.R, -1, self.modulus)

    @functools.cached_property
    def nprime(self) -> int:
        """-p^{-1} mod R (the separated-REDC multiplier of the plain path)."""
        return (-pow(self.modulus, -1, self.R)) % self.R

    @functools.cached_property
    def n0inv(self) -> int:
        """-p^{-1} mod 2^32 (the word-serial CIOS multiplier of the kernels)."""
        return self.nprime & 0xFFFFFFFF

    @property
    def p_words(self) -> List[int]:
        return int_to_words(self.modulus, self.num_limbs)

    @functools.cached_property
    def kernel_consts(self):
        """The field's argument to every field kernel (csrc/field_ops.cu),
        built once: the L words of p, -p^-1 mod 2^32, the L words of R mod p."""
        words = self.p_words + [self.n0inv] + int_to_words(self.r_mod_p, self.num_limbs)
        return (ctypes.c_uint32 * len(words))(*words)

    @property
    def s30_limbs(self) -> int:
        """Signed 30-bit limbs of the inversion (csrc/field_ops.cu, fe_inv):
        9 for 8 words, 13 for 12, room for a 32·L-bit value and its sign."""
        return 32 * self.num_limbs // DIVSTEP_BLOCK + 1

    @property
    def divsteps(self) -> int:
        """Divsteps that bring g to 0 for every input: Bernstein and Yang's
        bound (eprint 2019/266, Theorem 11.2) for f = p, 0 ≤ g < p, d = the
        bit length of p (f² + 4g² < 5·2^(2d)): ⌊(49d + 57)/17⌋ for d ≥ 46,
        ⌊(49d + 80)/17⌋ below; 732 to 741 for the 253- to 256-bit moduli,
        1,101 for bls12-381's Fq."""
        d = self.modulus.bit_length()
        return (49 * d + (57 if d >= 46 else 80)) // 17

    @property
    def divstep_blocks(self) -> int:
        """Blocks of DIVSTEP_BLOCK divsteps the inversion runs (25 at 8 words,
        37 for bls12-381's Fq)."""
        return -(-self.divsteps // DIVSTEP_BLOCK)

    @functools.cached_property
    def inv_consts(self):
        """The inversion kernel's argument (csrc/field_ops.cu, InvConsts),
        built once: the divstep count, p⁻¹ mod 2^30, then p and R² mod p in
        signed 30-bit limbs, INV_LIMBS_MAX each."""
        words = ([self.divsteps, pow(self.modulus, -1, 1 << DIVSTEP_BLOCK)]
                 + int_to_s30(self.modulus, INV_LIMBS_MAX)
                 + int_to_s30(self.r2_mod_p, INV_LIMBS_MAX))
        return (ctypes.c_uint32 * len(words))(*words)


ED25519_FP = FieldSpec("ed25519_fp", ED25519_P)
ED25519_FL = FieldSpec("ed25519_fl", ED25519_L)
SECP256K1_FP = FieldSpec("secp256k1_fp", SECP256K1_P)
SECP256K1_FN = FieldSpec("secp256k1_fn", SECP256K1_N)
BLS12_381_FQ = FieldSpec("bls12_381_fq", BLS12_381_Q, 12)
BLS12_381_FR = FieldSpec("bls12_381_fr", BLS12_381_R)


def int_to_words(x: int, limbs: int = NUM_LIMBS) -> List[int]:
    """Nonnegative int < 2^(32·limbs) → `limbs` little-endian uint32 words."""
    if not 0 <= x < 1 << (LIMB_BITS * limbs):
        raise ValueError(f"value does not fit in {limbs} limbs of 32 bits")
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(limbs)]


def int_to_s30(x: int, limbs: int) -> List[int]:
    """Nonnegative int → `limbs` 30-bit limbs, little-endian (the inversion's
    signed representation of a nonnegative value)."""
    if not 0 <= x < 1 << (DIVSTEP_BLOCK * limbs):
        raise ValueError(f"value does not fit in {limbs} limbs of 30 bits")
    return [(x >> (DIVSTEP_BLOCK * i)) & ((1 << DIVSTEP_BLOCK) - 1) for i in range(limbs)]


def ints_to_tensor(xs: Sequence[int], device=None, limbs: int = NUM_LIMBS) -> torch.Tensor:
    """Ints < 2^(32·limbs) → (N, limbs) int32 tensor of their uint32 limb
    patterns."""
    blob = b"".join(int(x).to_bytes(4 * limbs, "little") for x in xs)
    arr = np.frombuffer(blob, dtype="<u4").view(np.int32).reshape(-1, limbs)
    return torch.from_numpy(arr.copy()).to(device)


def tensor_to_ints(t: torch.Tensor) -> List[int]:
    """(..., L) int32 limb tensor → flat list of ints (row-major order); the
    width L is the tensor's last axis."""
    width = 4 * t.shape[-1]
    arr = t.detach().to("cpu").contiguous().numpy().astype("<u4", copy=False)
    raw = arr.tobytes()
    return [int.from_bytes(raw[i:i + width], "little")
            for i in range(0, len(raw), width)]

