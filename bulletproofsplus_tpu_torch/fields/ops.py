"""Vectorized modular arithmetic over (..., L) limb tensors.

Port of bulletproofsplus_tpu/fields/ops.py::FieldOps. L is the field spec's
word count (8, or 12 for bls12-381's Fq). Elements are in Montgomery form
(x·2^(32L) mod p) unless a method says "plain"; every method
broadcasts over leading axes and returns fully reduced limbs. `mul` is K1
(fields/mont_mul.py); add, sub, neg, sum, pow_const and inv are the
field kernels of fields/field_kernels.py, one launch each. For each, a CPU
tensor takes the plain version and a CUDA tensor the kernel; the XLA
fusion the JAX package gets for free is those kernels here. The scans the
JAX package builds with `lax.associative_scan` are Hillis–Steele doubling
loops here (log2 of the axis length in `mul` calls).
"""
from __future__ import annotations

import functools
from typing import List, Sequence, Union

import torch

from . import field_kernels as fk
from .mont_mul import mont_mul, mont_mul_plain, u64
from .spec import FieldSpec, ints_to_tensor, tensor_to_ints


class FieldOps:
    """Montgomery-form ops for one prime field. `plain=True` gives the same
    ops on the plain versions alone (the reference inside kernels' plain
    versions, which must launch nothing, whatever the device)."""

    def __init__(self, spec: FieldSpec, plain: bool = False):
        self.spec = spec
        self.p = spec.modulus
        self.L = spec.num_limbs
        self.is_plain = plain
        if plain:
            self._mul, self._add, self._sub, self._neg, self._sum, self._pow, self._inv = (
                mont_mul_plain, fk.fe_add_plain, fk.fe_sub_plain, fk.fe_neg_plain,
                fk.fe_sum_plain, fk.fe_pow_plain, fk.fe_inv_plain)
        else:
            self._mul, self._add, self._sub, self._neg, self._sum, self._pow, self._inv = (
                mont_mul, fk.fe_add, fk.fe_sub, fk.fe_neg, fk.fe_sum, fk.fe_pow, fk.fe_inv)
        self._dev: dict = {}

    @functools.cached_property
    def plain(self) -> "FieldOps":
        return self if self.is_plain else FieldOps(self.spec, plain=True)

    def _c(self, device) -> dict:
        key = str(device)
        if key not in self._dev:
            self._dev[key] = {
                "one": ints_to_tensor([self.spec.r_mod_p], device, self.L)[0],
                "one_plain": ints_to_tensor([1], device, self.L)[0],
                "r2": ints_to_tensor([self.spec.r2_mod_p], device, self.L)[0],
            }
        return self._dev[key]

    # -- host boundaries --------------------------------------------------

    def encode(self, x: Union[int, Sequence[int]], device=None) -> torch.Tensor:
        """Int(s) → Montgomery limbs, (L,) or (N, L)."""
        if isinstance(x, int):
            return self.encode([x], device)[0]
        return ints_to_tensor([int(v) % self.p * self.spec.r_mod_p % self.p
                               for v in x], device, self.L)

    def decode(self, t: torch.Tensor) -> Union[int, List[int]]:
        """Montgomery limbs → int (for (L,)) or flat list of ints."""
        vals = [v * self.spec.rinv % self.p for v in tensor_to_ints(t)]
        return vals[0] if t.dim() == 1 else vals

    def encode_plain(self, x: Union[int, Sequence[int]], device=None) -> torch.Tensor:
        if isinstance(x, int):
            return self.encode_plain([x], device)[0]
        return ints_to_tensor([int(v) % self.p for v in x], device, self.L)

    def decode_plain(self, t: torch.Tensor) -> Union[int, List[int]]:
        vals = tensor_to_ints(t)
        return vals[0] if t.dim() == 1 else vals

    def one(self, device) -> torch.Tensor:
        return self._c(device)["one"]

    # -- ring ops ---------------------------------------------------------

    def add(self, a, b):
        return self._add(a, b, self.spec)

    def sub(self, a, b):
        return self._sub(a, b, self.spec)

    def neg(self, a):
        return self._neg(a, self.spec)

    def mul(self, a, b):
        return self._mul(a, b, self.spec)

    def from_mont(self, a):
        """Montgomery → plain form (x·R → x), e.g. for MSM scalars."""
        return self.mul(a, self._c(a.device)["one_plain"])

    def to_mont(self, a):
        return self.mul(a, self._c(a.device)["r2"])

    # -- powers and inverses ----------------------------------------------

    def pow_const(self, a, e: int):
        """a^e for a Python-int exponent: 4-bit fixed window, one 16-entry
        table then 4 squarings + one multiply per window, MSB first (one
        launch on the card)."""
        return self._pow(a, e, self.spec)

    def inv(self, a):
        """a⁻¹ elementwise, 0 ↦ 0 (what a^(p−2) gives, word for word): the
        divstep inversion, one launch on the card (fields/field_kernels.py,
        fe_inv)."""
        return self._inv(a, self.spec)

    def scan_mul(self, a, dim: int, reverse: bool = False):
        """Inclusive prefix products along `dim` (Hillis–Steele doubling)."""
        dim = dim % a.dim()
        if reverse:
            return self.scan_mul(a.flip(dim), dim).flip(dim)
        n = a.shape[dim]
        s = 1
        while s < n:
            head = a.narrow(dim, 0, s)
            tail = self.mul(a.narrow(dim, s, n - s), a.narrow(dim, 0, n - s))
            a = torch.cat([head, tail], dim=dim)
            s *= 2
        return a

    def batch_invert(self, a, axis: int = 0):
        """(product of all inverses, elementwise inverses) along `axis`:
        the Montgomery trick, one inversion per slice. Entries must be
        nonzero."""
        dim = axis
        n = a.shape[dim]
        pre = self.scan_mul(a, dim)
        suf = self.scan_mul(a, dim, reverse=True)
        allinv = self.inv(pre.select(dim, n - 1))
        ones = self.one(a.device).expand_as(a.narrow(dim, 0, 1))
        pre_excl = torch.cat([ones, pre.narrow(dim, 0, n - 1)], dim=dim)
        suf_excl = torch.cat([suf.narrow(dim, 1, n - 1), ones], dim=dim)
        invs = self.mul(self.mul(pre_excl, suf_excl), allinv.unsqueeze(dim))
        return allinv, invs

    def powers_type2(self, x, n: int):
        """[x, x², ..., xⁿ] as (..., n, L) for x of shape (..., L)."""
        return self.scan_mul(x.unsqueeze(-2).expand(*x.shape[:-1], n, self.L)
                             .contiguous(), -2)

    def sum(self, a, axis: int = 0):
        """Field sum along an axis (one launch on the card)."""
        return self._sum(a, self.spec, axis)

    # -- predicates and digits --------------------------------------------

    def is_zero(self, a):
        return (a == 0).all(dim=-1)

    def select(self, mask, a, b):
        """mask ? a : b, with mask shaped like a.shape[:-1]."""
        return torch.where(torch.as_tensor(mask, device=a.device)[..., None], a, b)

    @property
    def order_bits(self) -> int:
        return self.p.bit_length()

    def scalar_digits(self, s, nbits: int | None = None, c: int = 4):
        """Plain-form limbs (..., L) → c-bit digits (..., nwin) int32,
        LSB first, nbits by default all 32·L bits of the limbs, for any c
        from 1 to 32. A digit that straddles two words (c = 6, the bucket
        MSM's window) is read from the 64-bit pair of its word and the next;
        above the top word the bits are 0."""
        if not 1 <= c <= 32:
            raise ValueError("window must be 1 to 32 bits")
        nbits = nbits or self.L * 32
        nwin = -(-nbits // c)
        if (nwin - 1) * c // 32 >= self.L:
            raise ValueError("nbits exceeds limb capacity")
        pos = torch.arange(nwin, device=s.device) * c
        words = u64(s)
        words = torch.cat([words, torch.zeros_like(words[..., :1])], dim=-1)
        pair = words[..., pos // 32] | (words[..., pos // 32 + 1] << 32)
        # bit 63 of the pair holds its sign; a digit ends at bit 62 at most
        return ((pair >> (pos % 32)) & ((1 << c) - 1)).to(torch.int32)

    def signed_window_count(self, nbits: int | None = None, c: int = 4) -> int:
        """Windows of the signed c-bit decomposition: one more than
        ceil(nbits/c) iff the top digit plus a carry can exceed 2^(c-1)."""
        nbits = nbits or self.L * 32
        nwin = -(-nbits // c)
        top_max = ((1 << nbits) - 1) >> (c * (nwin - 1))
        return nwin + (1 if top_max + 1 > (1 << (c - 1)) else 0)

    def scalar_digits_signed(self, s, nbits: int | None = None, c: int = 4):
        """Plain-form limbs → balanced signed digits: (magnitudes (..., nw1)
        in [0, 2^(c-1)], negative-sign bools), LSB first. Digit j becomes
        d_j + carry_in − 2^c·carry_out with carry_out = (d_j + carry_in >
        2^(c-1)); a sequential carry over the windows."""
        nbits = nbits or self.L * 32
        nwin = -(-nbits // c)
        nw1 = self.signed_window_count(nbits, c)
        half = 1 << (c - 1)
        d = self.scalar_digits(s, nwin * c, c)
        if nw1 > nwin:
            d = torch.cat([d, torch.zeros_like(d[..., :1])], dim=-1)
        mags, negs = [], []
        carry = torch.zeros_like(d[..., 0])
        for j in range(nw1):
            t = d[..., j] + carry
            neg = t > half
            mags.append(torch.where(neg, (1 << c) - t, t))
            negs.append(neg)
            carry = neg.to(t.dtype)
        return torch.stack(mags, dim=-1), torch.stack(negs, dim=-1)

