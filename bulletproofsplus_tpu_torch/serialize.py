"""Point compression and the range-proof wire format, per curve.

Port of bulletproofsplus_tpu/serialize.py:68-228 for the port's curves, with
the subgroup check of :37-65. Fixed length per curve:

- edwards25519: 32 bytes, y little-endian with sign(x) in the top bit;
  decoding also checks the prime-order subgroup (cofactor 8; one host
  scalar multiplication per point, so decode a statement once and reuse it).
- secp256k1: 33 bytes, SEC1 compressed: 02/03 (parity of y) ‖ x
  big-endian; the identity is 0x00 ‖ 32 zero bytes. The cofactor is 1, so a
  point on the curve is in the group.
- bls12-381 G1: 49 bytes, the same scheme over the 48-byte base field:
  02/03 ‖ x big-endian, the identity 0x00 ‖ 48 zero bytes. The cofactor is
  0x396C8C005555E1568C00AAAB0000AAAB, so decoding also checks the subgroup
  (one host scalar multiplication per point, as on edwards25519).

A proof is [rounds:u8] ‖ A ‖ L_vec ‖ R_vec ‖ A_wip ‖ B ‖ r' ‖ s' ‖ δ' with
32-byte little-endian scalars; a public key (:230-283) is b"BPPK1" ‖
len(name):u8 ‖ name ‖ length:u32 big-endian ‖ g ‖ h ‖ G_vec ‖ H_vec.
Malformed, off-curve or non-subgroup bytes raise FormatError.
"""
from __future__ import annotations

import struct
from typing import List

import torch

from .curves.host import Affine
from .device import entry_device
from .errors import FormatError

SCALAR_LEN = 32


def _fp_bytes(curve) -> int:
    return (curve.fp.p.bit_length() + 7) // 8


def point_len(curve) -> int:
    return 32 if curve.COORDS == 4 else _fp_bytes(curve) + 1


def point_bytes(curve, P: Affine) -> bytes:
    """Compress a host affine point (None = identity)."""
    if curve.COORDS == 4:
        x, y = (0, 1) if P is None else P
        enc = bytearray(y.to_bytes(32, "little"))
        enc[31] |= (x & 1) << 7
        return bytes(enc)
    if P is None:
        return bytes(point_len(curve))
    x, y = P
    return bytes([2 + (y & 1)]) + x.to_bytes(_fp_bytes(curve), "big")


def point_from_bytes(curve, data: bytes) -> Affine:
    """Decompress to an affine tuple (None = identity); FormatError for
    malformed, off-curve or non-subgroup input."""
    hc = curve.host
    if len(data) != point_len(curve):
        raise FormatError()
    if curve.COORDS == 4:
        sign = data[31] >> 7
        y = int.from_bytes(bytes(data[:31]) + bytes([data[31] & 0x7F]), "little")
        if y >= hc.p:
            raise FormatError()
        if y == 1 and sign == 0:
            return None
        try:
            x = hc.recover_x(y, sign)
        except ValueError:
            raise FormatError()
        if not hc.in_subgroup((x, y)):
            raise FormatError("point not in the prime-order subgroup")
        return (x, y)
    if data[0] == 0:
        if any(data[1:]):
            raise FormatError()
        return None
    if data[0] not in (2, 3):
        raise FormatError()
    x = int.from_bytes(data[1:], "big")
    if x >= hc.p:
        raise FormatError()
    y = hc.sqrt(x * x * x + hc.b)
    if y is None:
        raise FormatError()
    if y & 1 != data[0] - 2:
        y = hc.p - y
    if not hc.in_subgroup((x, y)):
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
    npts, plen = 2 * rounds + 3, point_len(curve)
    if len(data) != 1 + npts * plen + 3 * SCALAR_LEN:
        raise FormatError()
    pts = [point_from_bytes(curve, data[1 + i * plen: 1 + (i + 1) * plen])
           for i in range(npts)]
    off = 1 + npts * plen
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
        out += point_bytes(curve, P)
    for s in (w.r_prime, w.s_prime, w.d_prime):
        out += curve.fn.decode(s).to_bytes(SCALAR_LEN, "little")
    return bytes(out)


def publickey_to_bytes(curve, pk) -> bytes:
    """PublicKey → bytes: b"BPPK1" ‖ len(name):u8 ‖ name ‖ length:u32 ‖ g ‖
    h ‖ G_vec ‖ H_vec, compressed points (one fetch and decode for all)."""
    name = curve.name.encode()
    out = bytearray(b"BPPK1" + bytes([len(name)]) + name)
    out += pk.length.to_bytes(4, "big")
    pts = curve.decode_points(torch.cat([pk.g[None], pk.h[None], pk.G_vec, pk.H_vec]))
    for P in pts:
        out += point_bytes(curve, P)
    return bytes(out)


def publickey_from_bytes(curve, data: bytes, device=None):
    """Bytes → PublicKey on `device` (default: the CUDA card); FormatError
    for malformed input, another curve's key, or off-curve or non-subgroup
    points."""
    from .protocol.publickey import PublicKey

    device = entry_device(device)
    name = curve.name.encode()
    head = b"BPPK1" + bytes([len(name)]) + name
    if not data.startswith(head):
        raise FormatError("not a public key for this curve")
    off = len(head)
    if len(data) < off + 4:
        raise FormatError()
    length = int.from_bytes(data[off:off + 4], "big")
    off += 4
    plen = point_len(curve)
    if len(data) != off + (2 * length + 2) * plen:
        raise FormatError()
    enc = curve.encode_points(points_from_bytes(curve, data[off:]), device)
    return PublicKey(curve=curve, g=enc[0], h=enc[1], G_vec=enc[2:2 + length],
                     H_vec=enc[2 + length:])


def points_from_bytes(curve, data: bytes) -> List[Affine]:
    """Concatenated compressed points → affine tuples."""
    plen = point_len(curve)
    if len(data) % plen:
        raise FormatError()
    return [point_from_bytes(curve, data[i:i + plen])
            for i in range(0, len(data), plen)]


def read_fixture(data: bytes):
    """Parse a statement fixture (scripts/make_torch_fixtures.py): returns
    (curve name, n, m, [(commitment bytes (m points), proof bytes)]). Points
    are as long as the named curve's (32, 33 or 49 bytes).

    BPPF2 names its curve and holds n and m as u16; BPPF1, the format of
    the edwards25519 fixture, holds them as u8 and implies edwards25519."""
    from .curves import curve_ops

    if data.startswith(b"BPPF1") and len(data) >= 9:
        name, (n, m, count), off = "edwards25519", struct.unpack(">BBH", data[5:9]), 9
    elif data.startswith(b"BPPF2") and len(data) >= 12 + data[5]:
        end = 6 + data[5]
        name = data[6:end].decode()
        (n, m, count), off = struct.unpack(">HHH", data[end:end + 6]), end + 6
    else:
        raise FormatError("not a statement fixture")
    plen = point_len(curve_ops(name))
    rows = []
    for _ in range(count):
        comms = data[off:off + m * plen]
        off += m * plen
        size = int.from_bytes(data[off:off + 2], "big")
        rows.append((comms, data[off + 2:off + 2 + size]))
        off += 2 + size
    if off != len(data):
        raise FormatError("trailing bytes in statement fixture")
    return name, n, m, rows
