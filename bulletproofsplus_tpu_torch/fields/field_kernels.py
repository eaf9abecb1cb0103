"""The field layer around K1 as kernels: add, sub, neg, a sum along one axis,
a power by a constant exponent and the inverse, each one launch on the card.

The JAX package computes these (bulletproofsplus_tpu/fields/ops.py: add,
sub, neg :206-216, pow_const :298-337, inv :339, sum :389-403) as jnp
carry chains that XLA fuses into the programs around them; only its
products reach a Pallas kernel (K1, fields/pallas_ops.py::_mont_mul_call, pl.pallas_call
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
  Fermat inversion is one launch, not ~330 products. Bound by one
  thread's chain of dependent products; no path of the port calls it since
  `fe_inv`.
- `fe_inv`: a⁻¹ (0 ↦ 0) by Bernstein–Yang divsteps (eprint 2019/266),
  `FieldOps.inv`: one thread an element runs the modulus's fixed count of
  divsteps (FieldSpec.divsteps: 732-741 at 253-256 bits, 1,101 at 381) in
  blocks of 30 on signed 30-bit limbs, a dependent path of some 5,000
  integer operations at 8 words where a^(p − 2) has ~330 dependent
  products of 256. Bound by that chain.

Each wrapper takes its plain version for a CPU tensor, and for a CUDA
tensor launches its kernel or raises; `<wrapper>.launches` counts launches.
The plain versions are the torch carry chains the port used before these
kernels (`carry32`, `reduce_once`), and `fe_inv_plain` the kernel's divstep
algorithm on int64 tensors; every kernel equals its plain version word for
word: values are fully reduced, so any order of a sum gives the same words.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels
from .mont_mul import MASK32, _const, carry32, i32, mont_mul_plain, reduce_once, u64
from .spec import DIVSTEP_BLOCK, INV_LIMBS_MAX, FieldSpec, int_to_words

MAX_EXP_WORDS = 16      # csrc/field_ops.cu: fe_pow takes exponents below 2^512
WINDOW = 4
M30 = (1 << DIVSTEP_BLOCK) - 1


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


def _to_s30(a: torch.Tensor, spec: FieldSpec) -> list:
    """(..., L) words → the value's spec.s30_limbs 30-bit limbs (int64)."""
    w = u64(a)
    L = spec.num_limbs
    limbs = []
    for j in range(spec.s30_limbs):
        k, s = divmod(DIVSTEP_BLOCK * j, 32)
        v = w[..., k] >> s
        if s > 32 - DIVSTEP_BLOCK and k + 1 < L:
            v = v | (w[..., k + 1] << (32 - s))
        limbs.append(v & M30)
    return limbs


def _from_s30(limbs: list, spec: FieldSpec) -> torch.Tensor:
    """Normalized 30-bit limbs (each in [0, 2^30)) → (..., L) int32 words."""
    words = []
    for i in range(spec.num_limbs):
        j, s = divmod(32 * i, DIVSTEP_BLOCK)
        words.append(((limbs[j] >> s) | (limbs[j + 1] << (DIVSTEP_BLOCK - s))) & MASK32)
    return i32(torch.stack(words, dim=-1))


def _divsteps(delta, f0, g0):
    """DIVSTEP_BLOCK divsteps on the low bits of f and g: (delta, u, v, q,
    r), the block's transition matrix scaled by 2^30, 2^30·(f', g') = (u·f +
    v·g, q·f + r·g). Branch-free, as in the kernel: a step with delta > 0
    and g odd swaps, (1 − δ, g, (g − f)/2); otherwise (1 + δ, f, (g + (g
    mod 2)·f)/2). The kernel keeps f, g mod 2^32; here they stay exact, and
    the low bits, which alone decide each step, agree."""
    f, g = f0, g0
    u, v = torch.ones_like(f), torch.zeros_like(f)
    q, r = torch.zeros_like(f), torch.ones_like(f)
    for _ in range(DIVSTEP_BLOCK):
        c1 = -(delta > 0).to(torch.int64)          # all ones where δ > 0
        c2 = -(g & 1)                              # all ones where g is odd
        x, y, z = (f ^ c1) - c1, (u ^ c1) - c1, (v ^ c1) - c1
        g, q, r = g + (x & c2), q + (y & c2), r + (z & c2)
        c1 = c1 & c2                               # the swap
        delta = (delta ^ c1) - c1 + 1
        f, u, v = f + (g & c1), u + (q & c1), v + (r & c1)
        g, u, v = g >> 1, u << 1, v << 1
    return delta, u, v, q, r


def _update_fg(f: list, g: list, u, v, q, r) -> None:
    """(f, g) ← (u·f + v·g, q·f + r·g)/2^30, exact, in place."""
    S = len(f)
    cf = (u * f[0] + v * g[0]) >> DIVSTEP_BLOCK
    cg = (q * f[0] + r * g[0]) >> DIVSTEP_BLOCK
    for i in range(1, S):
        cf = cf + u * f[i] + v * g[i]
        cg = cg + q * f[i] + r * g[i]
        f[i - 1], cf = cf & M30, cf >> DIVSTEP_BLOCK
        g[i - 1], cg = cg & M30, cg >> DIVSTEP_BLOCK
    f[S - 1], g[S - 1] = cf, cg


def _update_de(d: list, e: list, u, v, q, r, p: list, inv30: int) -> None:
    """(d, e) ← (u·d + v·e, q·d + r·e)/2^30 mod p, in place, each kept in
    (−2p, p): md·p and me·p are added, md and me chosen to clear the low 30
    bits (and to add p·(u, q) where d < 0, p·(v, r) where e < 0)."""
    S = len(d)
    sd, se = d[S - 1] >> 63, e[S - 1] >> 63
    md, me = (u & sd) + (v & se), (q & sd) + (r & se)
    cd = u * d[0] + v * e[0]
    ce = q * d[0] + r * e[0]
    md = md - ((inv30 * (cd & M30) + md) & M30)
    me = me - ((inv30 * (ce & M30) + me) & M30)
    cd = (cd + p[0] * md) >> DIVSTEP_BLOCK
    ce = (ce + p[0] * me) >> DIVSTEP_BLOCK
    for i in range(1, S):
        cd = cd + u * d[i] + v * e[i] + p[i] * md
        ce = ce + q * d[i] + r * e[i] + p[i] * me
        d[i - 1], cd = cd & M30, cd >> DIVSTEP_BLOCK
        e[i - 1], ce = ce & M30, ce >> DIVSTEP_BLOCK
    d[S - 1], e[S - 1] = cd, ce


def _normalize(d: list, sign, p: list) -> list:
    """d in (−2p, p), times the sign of `sign` (f's top limb, f = ±1) →
    its residue in [0, p), limbs in [0, 2^30): add p where negative, negate
    where f < 0, carry, add p where still negative, carry."""
    S = len(d)

    def carry(x):
        for i in range(S - 1):
            x[i + 1] = x[i + 1] + (x[i] >> DIVSTEP_BLOCK)
            x[i] = x[i] & M30
        return x

    neg = d[S - 1] >> 63
    x = [di + (pi & neg) for di, pi in zip(d, p)]
    flip = sign >> 63
    x = carry([(xi ^ flip) - flip for xi in x])
    neg = x[S - 1] >> 63
    return carry([xi + (pi & neg) for xi, pi in zip(x, p)])


def fe_inv_plain(a: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """a⁻¹ in Montgomery form (0 ↦ 0) by fe_inv's divstep algorithm, the
    kernel's steps on int64 tensors over the whole batch: f = p, g = a·R;
    spec.divstep_blocks blocks of DIVSTEP_BLOCK divsteps on the low limbs,
    each block's matrix applied to (f, g) and, mod p, to (d, e), which
    start at (0, R² mod p) so that at the end (f = ±1) d = ±R²·(aR)⁻¹ =
    ±a⁻¹·R; then d's residue. Equals fe_pow_plain(a, p − 2) word for word."""
    S = spec.s30_limbs
    c = spec.inv_consts
    blocks, inv30 = -(-c[0] // DIVSTEP_BLOCK), c[1]
    p_l = [int(x) for x in c[2:2 + S]]
    r2_l = [int(x) for x in c[2 + INV_LIMBS_MAX:2 + INV_LIMBS_MAX + S]]
    g = _to_s30(a, spec)
    zero = torch.zeros_like(g[0])
    f = [zero + x for x in p_l]
    d = [zero] * S
    e = [zero + x for x in r2_l]
    delta = zero + 1
    for _ in range(blocks):
        delta, u, v, q, r = _divsteps(delta, f[0], g[0])
        _update_fg(f, g, u, v, q, r)
        _update_de(d, e, u, v, q, r, p_l, inv30)
    return _from_s30(_normalize(d, f[S - 1], p_l), spec)


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


def fe_inv(a: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """a⁻¹ elementwise over (..., L) Montgomery limbs, 0 ↦ 0: one launch of
    the divstep kernel on the card (fe_inv_plain's algorithm, one thread an
    element), equal to fe_pow(a, p − 2) word for word."""
    L = spec.num_limbs
    if a.shape[-1] != L:
        raise ValueError(f"{spec.name} elements have {L} limbs, got {a.shape[-1]}")
    if a.device.type == "cpu":
        return fe_inv_plain(a, spec)
    kernels.check_operands("fe_inv", (a, torch.int32))
    x = kernels.aligned(a)
    out = torch.empty_like(x)
    n = x.numel() // L
    if n:
        kernels.launch("bpp_fe_inv", x.data_ptr(), out.data_ptr(), n, L, spec.inv_consts,
                       device=a.device)
        fe_inv.launches += 1
    return out


WRAPPERS = (fe_add, fe_sub, fe_neg, fe_sum, fe_pow, fe_inv)
for _w in WRAPPERS:
    _w.launches = 0
