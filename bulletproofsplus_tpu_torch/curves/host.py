"""The port's curves on the host, in Python ints: constants, base points,
square roots and the few group operations that setup, commitments and
deserialization need.

Counterpart of bulletproofsplus_tpu/golden/curves.py (bls12-381 G1
:260-275, secp256k1 :276-285, edwards25519 :287-316), of the square root in
bulletproofsplus_tpu/protocol/publickey.py:181-195 and of the subgroup check
in bulletproofsplus_tpu/serialize.py:33-65. The port cannot import
golden (the JAX package's __init__ imports jax), so it keeps this small copy.
Points are affine tuples (x, y) with None as the identity. Each curve adds
in complete projective coordinates, the same formulas as its device ops, so
a scalar multiple costs no inversion and a list of points goes back to
affine with one shared inversion.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..fields.spec import (
    BLS12_381_Q,
    BLS12_381_R,
    ED25519_L,
    ED25519_P,
    SECP256K1_N,
    SECP256K1_P,
)

Affine = Optional[Tuple[int, int]]


class HostCurve:
    """What both families share: double-and-add and the way back to affine.
    A subclass gives `identity` (projective), `lift` and `add`."""

    name: str
    p: int
    order: int
    identity: tuple
    base: Tuple[int, int]

    def mul(self, P, k: int):
        """k·P by double-and-add on the raw k (not reduced mod the order)."""
        acc = self.identity
        while k:
            if k & 1:
                acc = self.add(acc, P)
            P = self.add(P, P)
            k >>= 1
        return acc

    def is_identity_affine(self, x: int, y: int) -> bool:
        return False

    def is_identity(self, P) -> bool:
        """Whether the projective point P is the identity."""
        raise NotImplementedError

    def to_affine(self, points: Sequence) -> List[Affine]:
        """Projective points → affine, one shared inversion (Montgomery
        trick). A point with Z = 0 (the Weierstrass identity) is None."""
        p = self.p
        zs = [pt[2] % p or 1 for pt in points]
        prefix, acc = [], 1
        for z in zs:
            acc = acc * z % p
            prefix.append(acc)
        inv = pow(acc, p - 2, p)
        out: List[Affine] = [None] * len(points)
        for i in range(len(points) - 1, -1, -1):
            zi = inv * (prefix[i - 1] if i else 1) % p
            inv = inv * zs[i] % p
            if points[i][2] % p == 0:
                continue
            x, y = points[i][0] * zi % p, points[i][1] * zi % p
            out[i] = None if self.is_identity_affine(x, y) else (x, y)
        return out


class EdwardsHost(HostCurve):
    """Twisted Edwards a = -1 (edwards25519) in extended (X, Y, Z, T)
    coordinates with add-2008-hwcd-3."""

    name = "edwards25519"
    p = ED25519_P
    order = ED25519_L
    identity = (0, 1, 1, 0)

    def __init__(self):
        P = self.p
        self.d = (-121665 * pow(121666, P - 2, P)) % P
        self.k2d = 2 * self.d % P
        self.sqrt_m1 = pow(2, (P - 1) // 4, P)
        gy = (4 * pow(5, P - 2, P)) % P
        self.base = (self.recover_x(gy, 0), gy)

    def recover_x(self, y: int, sign: int) -> int:
        """x with -x² + y² = 1 + d·x²·y² and x mod 2 == sign; ValueError if none."""
        P = self.p
        y2 = y * y % P
        u = (y2 - 1) % P
        v = (self.d * y2 + 1) % P
        x = (u * pow(v, 3, P)) % P * pow((u * pow(v, 7, P)) % P, (P - 5) // 8, P) % P
        if (v * x * x - u) % P != 0:
            x = x * self.sqrt_m1 % P
        if (v * x * x - u) % P != 0:
            raise ValueError("not a square")
        if x % 2 != sign:
            x = P - x
        return x

    def lift(self, A: Affine):
        if A is None:
            return self.identity
        x, y = A
        return (x, y, 1, x * y % self.p)

    def add(self, p1, p2):
        """add-2008-hwcd-3 (a = -1), complete."""
        P = self.p
        X1, Y1, Z1, T1 = p1
        X2, Y2, Z2, T2 = p2
        a = (Y1 - X1) * (Y2 - X2) % P
        b = (Y1 + X1) * (Y2 + X2) % P
        c = T1 * T2 % P * self.k2d % P
        d = 2 * Z1 * Z2 % P
        e, f, g, h = b - a, d - c, d + c, b + a
        return (e * f % P, g * h % P, f * g % P, e * h % P)

    def is_identity_affine(self, x: int, y: int) -> bool:
        return x == 0 and y == 1

    def is_identity(self, P) -> bool:
        return P[0] % self.p == 0 and (P[1] - P[2]) % self.p == 0

    def in_subgroup(self, A: Affine) -> bool:
        """Whether A lies in the prime-order subgroup: ℓ·A is the identity."""
        return A is None or self.is_identity(self.mul(self.lift(A), self.order))


class WeierstrassHost(HostCurve):
    """Short Weierstrass y² = x³ + b (a = 0) in homogeneous projective
    (X, Y, Z) coordinates with the Renes–Costello–Batina complete addition
    (eprint 2015/1060 algorithm 7); the identity is (0, 1, 0). `cofactor` is
    the index of the prime-order subgroup in the curve's group."""

    identity = (0, 1, 0)

    def __init__(self, name: str, p: int, order: int, b: int, gx: int, gy: int,
                 cofactor: int = 1):
        self.name, self.p, self.order, self.b = name, p, order, b
        self.b3 = 3 * b % p
        self.base = (gx, gy)
        self.cofactor = cofactor

    def lift(self, A: Affine):
        return self.identity if A is None else (A[0], A[1], 1)

    def add(self, p1, p2):
        """RCB algorithm 7 (a = 0), complete."""
        P, b3 = self.p, self.b3
        X1, Y1, Z1 = p1
        X2, Y2, Z2 = p2
        t0, t1, t2 = X1 * X2 % P, Y1 * Y2 % P, Z1 * Z2 % P
        t3 = ((X1 + Y1) * (X2 + Y2) - t0 - t1) % P
        t4 = ((Y1 + Z1) * (Y2 + Z2) - t1 - t2) % P
        t5 = ((X1 + Z1) * (X2 + Z2) - t0 - t2) % P
        t2b, t5b = b3 * t2 % P, b3 * t5 % P
        z3, t1m = t1 + t2b, t1 - t2b
        return ((t3 * t1m - t4 * t5b) % P, (t1m * z3 + 3 * t5b * t0) % P,
                (z3 * t4 + 3 * t0 * t3) % P)

    def sqrt(self, a: int) -> Optional[int]:
        """A square root of a mod p (p ≡ 3 mod 4), None for a non-residue."""
        r = pow(a, (self.p + 1) // 4, self.p)
        return r if r * r % self.p == a % self.p else None

    def is_identity(self, P) -> bool:
        return P[2] % self.p == 0

    def in_subgroup(self, A: Affine) -> bool:
        """Whether A lies in the prime-order subgroup: ℓ·A is the identity
        (Z = 0). With cofactor 1 every point on the curve does."""
        if A is None or self.cofactor == 1:
            return True
        return self.is_identity(self.mul(self.lift(A), self.order))


ED25519 = EdwardsHost()
SECP256K1 = WeierstrassHost(
    "secp256k1", SECP256K1_P, SECP256K1_N, 7,
    0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8)
# G1 of bls12-381, y² = x³ + 4, with the reference's generator
# (src/bls12_381/building_block/point/point.rs:15-18)
BLS12_381 = WeierstrassHost(
    "bls12_381", BLS12_381_Q, BLS12_381_R, 4,
    int("3685416753713387016781088315183077757961620795782546409894578378688607592378376"
        "318836054947676345821548104185464507"),
    int("1339506544944476473020471379941921221584933875938349620426543736416511423956333"
        "506472724655353366534992391756441569"),
    cofactor=0x396C8C005555E1568C00AAAB0000AAAB)
