"""edwards25519 on the host, in Python ints: constants, decompression and the
few group operations that setup and deserialization need.

Counterpart of bulletproofsplus_tpu/golden/curves.py:287-316 (ED_D, the base
point, `_ed_recover_x`). The port cannot import golden (the JAX package's
__init__ imports jax), so it keeps this small copy. Points are affine tuples
(x, y) with None as the identity; internally extended (X, Y, Z, T) with the
complete add-2008-hwcd-3 formula, so a scalar multiple costs one inversion.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..fields.spec import ED25519_L, ED25519_P

P = ED25519_P
ED_D = (-121665 * pow(121666, P - 2, P)) % P
ED_GY = (4 * pow(5, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)
K2D = 2 * ED_D % P

Affine = Optional[Tuple[int, int]]


def recover_x(y: int, sign: int) -> int:
    """x with -x² + y² = 1 + d·x²·y² and x mod 2 == sign; ValueError if none."""
    y2 = y * y % P
    u = (y2 - 1) % P
    v = (ED_D * y2 + 1) % P
    x = (u * pow(v, 3, P)) % P * pow((u * pow(v, 7, P)) % P, (P - 5) // 8, P) % P
    if (v * x * x - u) % P != 0:
        x = x * SQRT_M1 % P
    if (v * x * x - u) % P != 0:
        raise ValueError("not a square")
    if x % 2 != sign:
        x = P - x
    return x


BASE: Tuple[int, int] = (recover_x(ED_GY, 0), ED_GY)
IDENTITY_EXT = (0, 1, 1, 0)


def to_ext(A: Affine):
    if A is None:
        return IDENTITY_EXT
    x, y = A
    return (x, y, 1, x * y % P)


def ext_add(p1, p2):
    """add-2008-hwcd-3 (a = -1), complete."""
    X1, Y1, Z1, T1 = p1
    X2, Y2, Z2, T2 = p2
    a = (Y1 - X1) * (Y2 - X2) % P
    b = (Y1 + X1) * (Y2 + X2) % P
    c = T1 * T2 % P * K2D % P
    d = 2 * Z1 * Z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def ext_mul(p1, k: int):
    """k·P by double-and-add on the raw k (not reduced mod ℓ)."""
    acc = IDENTITY_EXT
    while k:
        if k & 1:
            acc = ext_add(acc, p1)
        p1 = ext_add(p1, p1)
        k >>= 1
    return acc


def to_affine(points: Sequence) -> List[Affine]:
    """Extended points → affine, one shared inversion (Montgomery trick)."""
    zs = [pt[2] for pt in points]
    prefix, acc = [], 1
    for z in zs:
        acc = acc * z % P
        prefix.append(acc)
    inv = pow(acc, P - 2, P)
    out: List[Affine] = [None] * len(points)
    for i in range(len(points) - 1, -1, -1):
        zi = inv * (prefix[i - 1] if i else 1) % P
        inv = inv * zs[i] % P
        x, y = points[i][0] * zi % P, points[i][1] * zi % P
        out[i] = None if (x == 0 and y == 1) else (x, y)
    return out


def in_subgroup(A: Affine) -> bool:
    """Whether A lies in the prime-order subgroup: ℓ·A is the identity."""
    if A is None:
        return True
    X, Y, Z, _ = ext_mul(to_ext(A), ED25519_L)
    return X % P == 0 and (Y - Z) % P == 0

