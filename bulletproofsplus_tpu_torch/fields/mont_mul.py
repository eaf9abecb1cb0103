"""K1: batched Montgomery product a·b·R⁻¹ mod p over (..., L) limb tensors.

Replaces bulletproofsplus_tpu/fields/pallas_ops.py::_mont_mul_call (the
`pl.pallas_call` at :369, wrapper `mont_mul` :386): a schoolbook convolution
of 12-bit limbs, halving passes, a separated REDC and one carry resolve, laid
out limb-major so the batch fills TPU lanes.

On Hopper (csrc/field_ops.cu) one thread owns one element and runs word-serial
CIOS over L × 32-bit words with 32×32→64 multiplies in PTX carry chains
(`fe_mul` in csrc/field.cuh): L² + L² multiply-adds, all in registers, at L = 8 (R =
2^256) or L = 12 (bls12-381's Fq, R = 2^384), the field spec's width, one
template instance each, in the same source as the field kernels around it
(fields/field_kernels.py). What bounds it: each element moves up to 12·L
bytes (two operands, one result) for 2·L² wide multiplies, so at the
exponent stage's sizes it is bound by memory bandwidth, not by the
multiplier; the design reads and writes each word once, reads a broadcast
operand in place (stride 0, kernels.operand) and keeps every intermediate
in registers. Through the wrapper a call also costs the host's launch
(kernels.launch keeps that to a lookup, the raw stream and the ctypes call).

The plain version below computes the same function with torch integer ops:
int64 cannot hold a 32×32-bit product, so it splits words into 16-bit
halves, multiplies by broadcasting, and reduces by separated REDC (T + M·p)/R.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels
from .spec import FieldSpec, ints_to_tensor

MASK16 = 0xFFFF
MASK32 = 0xFFFFFFFF
# Elements a pass of the plain product takes: its partial products hold up
# to 96·L² bytes an element (0.8 GB a pass at L = 8, 1.8 GB at L = 12).
PLAIN_CHUNK = 1 << 17


def u64(a: torch.Tensor) -> torch.Tensor:
    """int32 limb patterns → their uint32 values as int64."""
    return a.to(torch.int64) & MASK32


def i32(u: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) → int32 bit patterns."""
    return (u - ((u >> 31) << 32)).to(torch.int32)


def _positions(n: int, device):
    """(i, 2^i) for column i < n as int64 tensors on `device`, cached."""
    key = (n, str(device))
    if key not in _POSITIONS:
        idx = torch.arange(n, device=device)
        _POSITIONS[key] = (idx, torch.ones_like(idx) << idx)
    return _POSITIONS[key]


_POSITIONS: dict = {}


def _resolve(gen: torch.Tensor, passes: torch.Tensor):
    """Carries of one column-wise addition, all at once, without a scan.
    Column i emits a carry (gen[i]) or passes on the one it receives
    (passes[i]; never both). With those as the bits of G and P, these are
    the carries of the binary sum (P | G) + G, whose bits generate exactly
    where G does and propagate exactly where P does. Returns (0/1 carry into
    each column, carry out of the top). The carries are bits of one int64,
    so at most 62 columns."""
    n = gen.shape[-1]
    assert n <= 62, "carries of more than 62 columns overflow int64"
    idx, w = _positions(n, gen.device)
    G = (gen.to(torch.int64) * w).sum(-1)
    PG = (passes.to(torch.int64) * w).sum(-1) | G
    c = (PG + G) ^ PG ^ G                       # bit i: the carry into column i
    return (c[..., None] >> idx) & 1, (c >> n) & 1


def carry32(t: torch.Tensor, borrow: bool = False):
    """int64 limbs, each the sum (0 ≤ t < 2^33) or, with borrow=True, the
    difference (−2^32 < t < 2^32) of two 32-bit words → (limbs in
    [0, 2^32), carry out: 1 or 0 for a sum, −1 or 0 for a difference)."""
    gen = t >> 32
    low = t & MASK32
    c_in, c_out = _resolve(gen != 0, (gen == 0) & (low == (0 if borrow else MASK32)))
    if borrow:
        c_in, c_out = -c_in, -c_out
    return (low + c_in) & MASK32, c_out


def reduce_once(t: torch.Tensor, top: torch.Tensor, p64: torch.Tensor) -> torch.Tensor:
    """A value top·2^(32L) + t in [0, 2p), as L canonical int64 word limbs t
    and its top bit (0 or 1; 2p passes 2^256 when a 256-bit p > 2^255) →
    int32 limbs mod p. The value is at least p when its top bit is set or
    t − p does not borrow; t − p mod 2^(32L) is then the result."""
    d, borrow = carry32(t - p64, borrow=True)
    keep = (top == 0) & (borrow < 0)
    return i32(torch.where(keep[..., None], t, d))


def _halves(a: torch.Tensor) -> torch.Tensor:
    u = u64(a)
    return torch.stack([u & MASK16, u >> 16], dim=-1).flatten(-2)


def _wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product of 16-bit limb vectors → (..., 2n) column sums
    (each < n·2^32, exact in int64). The shear trick of the JAX package's
    FieldOps._mul_wide: row i of the outer product lands shifted by i."""
    n = a.shape[-1]
    o = a[..., :, None] * b[..., None, :]
    lead = o.shape[:-2]
    o = torch.cat([o, torch.zeros_like(o)], dim=-1).reshape(*lead, 2 * n * n)
    cols = o[..., : n * (2 * n - 1)].reshape(*lead, n, 2 * n - 1).sum(dim=-2)
    return F.pad(cols, (0, 1))


def _norm16(t: torch.Tensor) -> torch.Tensor:
    """Nonnegative int64 columns → canonical 16-bit limbs, mod 2^(16·len).
    Three carry-save passes take columns below 2^63 to at most 2^16 + 2^15,
    so each remaining carry is 0 or 1 and they resolve at once (`_resolve`)."""
    for _ in range(3):
        t = (t & MASK16) + F.pad((t >> 16)[..., :-1], (1, 0))
    c_in, _ = _resolve(t >> 16, t == MASK16)
    return (t + c_in) & MASK16


def _consts(spec: FieldSpec, device) -> dict:
    def halves_of(x):
        return torch.tensor([(x >> (16 * i)) & MASK16 for i in range(2 * spec.num_limbs)],
                            dtype=torch.int64, device=device)

    return {
        "p16": halves_of(spec.modulus),
        "np16": halves_of(spec.nprime),
        "p64": torch.tensor(spec.p_words, dtype=torch.int64, device=device),
        "one": ints_to_tensor([spec.r_mod_p], device, spec.num_limbs)[0],
    }


_CONSTS: dict = {}


def _const(spec: FieldSpec, device) -> dict:
    key = (spec.modulus, str(device))
    if key not in _CONSTS:
        _CONSTS[key] = _consts(spec, device)
    return _CONSTS[key]


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor,
                   spec: FieldSpec) -> torch.Tensor:
    """Plain PyTorch version of K1: a·b·R⁻¹ mod p, inputs < p, over the
    spec's L words (R = 2^(32L)); broadcasts, and takes at most PLAIN_CHUNK
    elements a pass."""
    a, b = torch.broadcast_tensors(a, b)
    L = spec.num_limbs
    if a.numel() // L <= PLAIN_CHUNK:
        return _mont_mul_pass(a, b, spec)
    fa, fb = a.reshape(-1, L), b.reshape(-1, L)
    return torch.cat([_mont_mul_pass(fa[i:i + PLAIN_CHUNK], fb[i:i + PLAIN_CHUNK], spec)
                      for i in range(0, fa.shape[0], PLAIN_CHUNK)]).reshape(a.shape)


def _mont_mul_pass(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    L = spec.num_limbs
    c = _const(spec, a.device)
    # T = a·b stays in 4L unnormalized 16-bit columns (< 2L·2^32): its low
    # 2L columns are still ≡ T mod R, and T + m·p is normalized once at the
    # end. T + m·p < 2R·p can reach R² when p > R/2, so it gets a column
    # more for that bit, which becomes the top bit of (T + m·p)/R < 2p.
    t = _wide(_halves(a), _halves(b))
    m = _norm16(_wide(t[..., :2 * L], c["np16"])[..., :2 * L])  # T·N' mod R
    s = _norm16(F.pad(t + _wide(m, c["p16"]), (0, 1)))          # ≡ 0 mod R
    hi = s[..., 2 * L:4 * L].reshape(*s.shape[:-1], L, 2)
    return reduce_once(hi[..., 0] | (hi[..., 1] << 16), s[..., 4 * L], c["p64"])


def mont_mul(a: torch.Tensor, b: torch.Tensor,
             spec: FieldSpec) -> torch.Tensor:
    """K1 wrapper: broadcasting Montgomery product of (..., L) int32 limbs,
    L = spec.num_limbs.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    at the spec's width (one thread per element, a broadcast operand read in
    place with stride 0: kernels.operand) or raises."""
    shape = kernels.broadcast_shape(a.shape, b.shape)
    L = spec.num_limbs
    if shape[-1] != L:
        raise ValueError(f"{spec.name} elements have {L} limbs, got {shape[-1]}")
    if a.device.type == "cpu":
        return mont_mul_plain(a, b, spec)
    kernels.check_operands("mont_mul", (a, torch.int32), (b, torch.int32))
    out, n = kernels.elementwise("bpp_mont_mul", shape, (a, b), spec.kernel_consts)
    if n:
        mont_mul.launches += 1
    return out


mont_mul.launches = 0
