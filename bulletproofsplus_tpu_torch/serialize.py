"""edwards25519 point compression and range-proof wire format.

Port of bulletproofsplus_tpu/serialize.py:68-228 for edwards25519, with the
subgroup check of :37-65: a point is 32 bytes, y little-endian with sign(x)
in the top bit; a proof is [rounds:u8] ‖ A ‖ L_vec ‖ R_vec ‖ A_wip ‖ B ‖
r' ‖ s' ‖ δ' with 32-byte little-endian scalars. Decoding rejects bytes off
the curve or outside the prime-order subgroup with FormatError (one host
scalar multiplication per point, so decode a statement once and reuse it).
"""
from __future__ import annotations

from typing import List

import torch

from .curves import host
from .device import entry_device
from .errors import FormatError

POINT_LEN = 32
SCALAR_LEN = 32


def point_bytes(P: host.Affine) -> bytes:
    x, y = (0, 1) if P is None else P
    enc = bytearray(y.to_bytes(32, "little"))
    enc[31] |= (x & 1) << 7
    return bytes(enc)


def point_from_bytes(data: bytes) -> host.Affine:
    """Decompress to an affine tuple (None = identity); FormatError for
    malformed, off-curve or non-subgroup input."""
    if len(data) != POINT_LEN:
        raise FormatError()
    sign = data[31] >> 7
    y = int.from_bytes(bytes(data[:31]) + bytes([data[31] & 0x7F]), "little")
    if y >= host.P:
        raise FormatError()
    if y == 1 and sign == 0:
        return None
    try:
        x = host.recover_x(y, sign)
    except ValueError:
        raise FormatError()
    if not host.in_subgroup((x, y)):
        raise FormatError("point not in the prime-order subgroup")
    return (x, y)


def scalar_from_bytes(curve, data: bytes) -> int:
    v = int.from_bytes(data, "little")
    if v >= curve.fn.p:
        raise FormatError()
    return v


def decode_proof(curve, data: bytes):
    """Wire bytes → (rounds, affine points [A, L..., R..., A_wip, B],
    scalars [r', s', δ'] as ints)."""
    if len(data) < 1:
        raise FormatError()
    rounds = data[0]
    npts = 2 * rounds + 3
    if len(data) != 1 + npts * POINT_LEN + 3 * SCALAR_LEN:
        raise FormatError()
    pts = [point_from_bytes(data[1 + i * POINT_LEN: 1 + (i + 1) * POINT_LEN])
           for i in range(npts)]
    off = 1 + npts * POINT_LEN
    scalars = [scalar_from_bytes(curve, data[off + i * SCALAR_LEN:
                                             off + (i + 1) * SCALAR_LEN])
               for i in range(3)]
    return rounds, pts, scalars


def proof_from_bytes(curve, data: bytes, device=None):
    """Bytes → RangeProof of tensors on `device` (default: the CUDA card)."""
    from .protocol.range import RangeProof
    from .protocol.wip import WipProof

    device = entry_device(device)
    rounds, pts, (r, s, d) = decode_proof(curve, data)
    P = curve.encode_points(pts, device)
    fn = curve.fn
    return RangeProof(
        A=P[0],
        proof=WipProof(L_vec=P[1:1 + rounds], R_vec=P[1 + rounds:1 + 2 * rounds],
                       A=P[1 + 2 * rounds], B=P[2 + 2 * rounds],
                       r_prime=fn.encode(r, device), s_prime=fn.encode(s, device),
                       d_prime=fn.encode(d, device)),
    )


def proof_to_bytes(curve, proof) -> bytes:
    """RangeProof → wire bytes."""
    w = proof.proof
    pts = curve.decode_points(
        torch.cat([proof.A[None], w.L_vec, w.R_vec, w.A[None], w.B[None]]))
    out = bytearray([w.rounds])
    for P in pts:
        out += point_bytes(P)
    for s in (w.r_prime, w.s_prime, w.d_prime):
        out += curve.fn.decode(s).to_bytes(SCALAR_LEN, "little")
    return bytes(out)


def points_from_bytes(data: bytes) -> List[host.Affine]:
    """Concatenated 32-byte points → affine tuples."""
    if len(data) % POINT_LEN:
        raise FormatError()
    return [point_from_bytes(data[i:i + POINT_LEN])
            for i in range(0, len(data), POINT_LEN)]


FIXTURE_MAGIC = b"BPPF1"


def read_fixture(data: bytes):
    """Parse a statement fixture (scripts/make_torch_fixtures.py):
    returns (n, m, [(commitment bytes (m·32), proof bytes)])."""
    if not data.startswith(FIXTURE_MAGIC) or len(data) < 9:
        raise FormatError("not a statement fixture")
    n, m, count = data[5], data[6], int.from_bytes(data[7:9], "big")
    off, rows = 9, []
    for _ in range(count):
        comms = data[off:off + m * POINT_LEN]
        off += m * POINT_LEN
        size = int.from_bytes(data[off:off + 2], "big")
        rows.append((comms, data[off + 2:off + 2 + size]))
        off += 2 + size
    if off != len(data):
        raise FormatError("trailing bytes in statement fixture")
    return n, m, rows
