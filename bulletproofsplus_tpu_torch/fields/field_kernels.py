"""The field layer around K1 as kernels: add, sub, neg, a sum along one axis
and a power by a constant exponent, each one launch on the card.

The JAX package computes these (bulletproofsplus_tpu/fields/ops.py: add,
sub, neg :206-216, pow_const :298-337, sum :389-403) as jnp carry chains
that XLA fuses into the programs around them; only its products reach a
Pallas kernel (K1, fields/pallas_ops.py::_mont_mul_call, pl.pallas_call
:369). Eager PyTorch fuses nothing, so on the card each becomes a kernel of
csrc/field_ops.cu beside K1's product (fields/mont_mul.py), at the spec's
width (8 or 12 words):

- `fe_add`, `fe_sub`, `fe_neg`: one thread an element, field.cuh's carry
  chains; broadcasting like torch, a broadcast operand ((K, 1, L) or (L,)
  against (K, W, L)) read in place with stride 0, never materialized
  (kernels.operand). Bound by bytes.
- `fe_sum`: the field sum along one axis of (B, R, C, L), over R; a block
  covers a few columns of one b and reduces through shared memory, so one
  launch serves both the verifier's sum over K proofs (leading axis) and
  the prover's sums over one row (inner axis). Bound by bytes.
- `fe_pow`: a^e for a Python-int e below 2^512, the 4-bit window chain of
  `FieldOps.pow_const`, one thread an element, all of it in one launch: a
  Fermat inversion is one launch, not ~330 products. Bound by operations
  (the chain's products).

Each wrapper takes its plain version for a CPU tensor, and for a CUDA
tensor launches its kernel or raises; `<wrapper>.launches` counts launches.
The plain versions are the torch carry chains the port used before these
kernels (`carry32`, `reduce_once`), and every kernel equals its plain version
word for word: values are fully reduced, so any order of a sum gives the
same words.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels
from .mont_mul import _const, carry32, i32, mont_mul_plain, reduce_once, u64
from .spec import FieldSpec, int_to_words

MAX_EXP_WORDS = 16      # csrc/field_ops.cu: fe_pow takes exponents below 2^512
WINDOW = 4


# -- plain versions --------------------------------------------------------


def fe_add_plain(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    s, top = carry32(u64(a) + u64(b))
    return reduce_once(s, top, _const(spec, a.device)["p64"])


def fe_sub_plain(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    d, borrow = carry32(u64(a) - u64(b), borrow=True)
    back, _ = carry32(d + _const(spec, a.device)["p64"])
    return i32(torch.where((borrow < 0)[..., None], back, d))


def fe_neg_plain(a: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    return fe_sub_plain(torch.zeros_like(a), a, spec)


def fe_sum_plain(a: torch.Tensor, spec: FieldSpec, axis: int = 0) -> torch.Tensor:
    """Field sum along `axis` by a balanced tree of adds."""
    a = a.movedim(axis, 0)
    while a.shape[0] > 1:
        half = a.shape[0] // 2
        paired = fe_add_plain(a[:half], a[half:2 * half], spec)
        a = torch.cat([paired, a[2 * half:]]) if a.shape[0] % 2 else paired
    return a[0]


def fe_pow_plain(a: torch.Tensor, e: int, spec: FieldSpec) -> torch.Tensor:
    """a^e, Montgomery form: 4-bit fixed window, one 16-entry table then 4
    squarings + one multiply per window, MSB first."""
    one = _const(spec, a.device)["one"].expand_as(a)
    if e == 0:
        return one.clone()
    tab = [one, a]
    for _ in range(2, 16):
        tab.append(mont_mul_plain(tab[-1], a, spec))
    nwin = -(-e.bit_length() // WINDOW)
    acc = tab[(e >> (WINDOW * (nwin - 1))) & 15]
    for w in range(nwin - 2, -1, -1):
        for _ in range(WINDOW):
            acc = mont_mul_plain(acc, acc, spec)
        acc = mont_mul_plain(acc, tab[(e >> (WINDOW * w)) & 15], spec)
    return acc


# -- kernel wrappers -------------------------------------------------------


def _binary(name: str, wrapper, plain, a, b, spec: FieldSpec) -> torch.Tensor:
    shape = kernels.broadcast_shape(a.shape, b.shape)
    if shape[-1] != spec.num_limbs:
        raise ValueError(f"{spec.name} elements have {spec.num_limbs} limbs, got {shape[-1]}")
    if a.device.type == "cpu":
        return plain(a, b, spec)
    kernels.check_operands(name, (a, torch.int32), (b, torch.int32))
    out, n = kernels.elementwise(f"bpp_{name}", shape, (a, b), spec.kernel_consts)
    if n:
        wrapper.launches += 1
    return out


def fe_add(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """a + b mod p, broadcasting (..., L) Montgomery or plain limbs."""
    return _binary("fe_add", fe_add, fe_add_plain, a, b, spec)


def fe_sub(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """a − b mod p, broadcasting."""
    return _binary("fe_sub", fe_sub, fe_sub_plain, a, b, spec)


def fe_neg(a: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """−a mod p."""
    if a.shape[-1] != spec.num_limbs:
        raise ValueError(f"{spec.name} elements have {spec.num_limbs} limbs, got {a.shape[-1]}")
    if a.device.type == "cpu":
        return fe_neg_plain(a, spec)
    kernels.check_operands("fe_neg", (a, torch.int32))
    out, n = kernels.elementwise("bpp_fe_neg", a.shape, (a,), spec.kernel_consts)
    if n:
        fe_neg.launches += 1
    return out


def fe_sum(a: torch.Tensor, spec: FieldSpec, axis: int = 0) -> torch.Tensor:
    """Field sum of (..., L) limbs along `axis` (not the limb axis); the
    axis must not be empty. On the card the sum runs over a contiguous copy
    of a (no copy where a already is one) viewed as (B, R, C, L), R the
    summed axis."""
    axis = axis % a.dim()
    if axis == a.dim() - 1:
        raise ValueError("cannot sum along the limb axis")
    if a.device.type == "cpu":
        return fe_sum_plain(a, spec, axis)
    kernels.check_operands("fe_sum", (a, torch.int32))
    L = spec.num_limbs
    if a.shape[-1] != L:
        raise ValueError(f"{spec.name} elements have {L} limbs, got {a.shape[-1]}")
    shape = a.shape
    R = shape[axis]
    out = torch.empty((*shape[:axis], *shape[axis + 1:]), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    if R == 0:
        raise ValueError("field sum over an empty axis")
    x = kernels.aligned(a)
    kernels.launch("bpp_fe_sum", x.data_ptr(), out.data_ptr(), shape[:axis].numel(), R,
                   shape[axis + 1:-1].numel(), L, spec.kernel_consts, device=a.device)
    fe_sum.launches += 1
    return out


@functools.lru_cache(maxsize=64)
def _exponent(e: int):
    """(MAX_EXP_WORDS words of e as the kernel's argument, 4-bit windows)."""
    words = int_to_words(e, MAX_EXP_WORDS)
    return (ctypes.c_uint32 * MAX_EXP_WORDS)(*words), -(-e.bit_length() // WINDOW)


def fe_pow(a: torch.Tensor, e: int, spec: FieldSpec) -> torch.Tensor:
    """a^e for a Python int 0 ≤ e < 2^512, elementwise over (..., L)
    Montgomery limbs (a^0 = 1)."""
    L = spec.num_limbs
    if a.shape[-1] != L:
        raise ValueError(f"{spec.name} elements have {L} limbs, got {a.shape[-1]}")
    if a.device.type == "cpu":
        return fe_pow_plain(a, e, spec)
    kernels.check_operands("fe_pow", (a, torch.int32))
    if not 0 <= e < 1 << (32 * MAX_EXP_WORDS):
        raise ValueError(f"fe_pow takes exponents in [0, 2^{32 * MAX_EXP_WORDS})")
    x = kernels.aligned(a)
    out = torch.empty_like(x)
    n = x.numel() // L
    if n:
        words, nwin = _exponent(e)
        kernels.launch("bpp_fe_pow", x.data_ptr(), out.data_ptr(), n, L, words, nwin,
                       spec.kernel_consts, device=a.device)
        fe_pow.launches += 1
    return out


WRAPPERS = (fe_add, fe_sub, fe_neg, fe_sum, fe_pow)
for _w in WRAPPERS:
    _w.launches = 0
