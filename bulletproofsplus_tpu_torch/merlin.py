"""Merlin transcripts on the host: Keccak-f[1600], STROBE-128 and the Merlin
framing, byte-exact with the `merlin` crate, and the Bulletproofs+ flow over
them.

A copy of bulletproofsplus_tpu/merlin.py:1-214 (the port cannot import the
JAX package, whose __init__ imports jax). Layers:

- `keccak_f1600(state)`: the permutation (FIPS 202) on a 200-byte state;
- `Strobe128`: merlin's mini-STROBE (security 128, rate 166): meta-AD, AD
  and PRF with begin-op framing;
- `MerlinTranscript`: new(label), append_message, append_u64,
  challenge_bytes;
- `MerlinBppTranscript`: the range proof's Fiat-Shamir flow over it, with
  ShaTranscript's interface (transcript.py). Points absorb in their
  compressed encoding (serialize.point_bytes); a challenge is 64 squeezed
  bytes, little-endian, reduced mod the group order, 0 mapped to 1.

The permutation is pure Python and runs on the host, as in the JAX package:
a Merlin proof's challenges cost the host about one permutation each.
"""
from __future__ import annotations

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]
_M64 = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _M64


def keccak_f1600(state: bytearray) -> None:
    """In-place Keccak-f[1600] on a 200-byte state (little-endian lanes)."""
    A = [[int.from_bytes(state[8 * (x + 5 * y): 8 * (x + 5 * y) + 8], "little")
          for y in range(5)] for x in range(5)]
    for rnd in range(24):
        # theta
        C = [A[x][0] ^ A[x][1] ^ A[x][2] ^ A[x][3] ^ A[x][4] for x in range(5)]
        D = [C[(x - 1) % 5] ^ _rotl(C[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                A[x][y] ^= D[x]
        # rho and pi
        B = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                B[y][(2 * x + 3 * y) % 5] = _rotl(A[x][y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                A[x][y] = B[x][y] ^ ((~B[(x + 1) % 5][y]) & B[(x + 2) % 5][y] & _M64)
        # iota
        A[0][0] ^= _RC[rnd]
    for x in range(5):
        for y in range(5):
            state[8 * (x + 5 * y): 8 * (x + 5 * y) + 8] = A[x][y].to_bytes(8, "little")


# -- STROBE-128 (merlin's subset: meta-AD, AD, PRF) ---------------------------

_R = 166  # STROBE-128 rate
_FLAG_I, _FLAG_A, _FLAG_C, _FLAG_T, _FLAG_M, _FLAG_K = 1, 2, 4, 8, 16, 32


class Strobe128:
    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, _R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        keccak_f1600(st)
        self.state = st
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    def _run_f(self):
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[_R + 1] ^= 0x80
        keccak_f1600(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes):
        for byte in data:
            self.state[self.pos] ^= byte
            self.pos += 1
            if self.pos == _R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray(n)
        for i in range(n):
            out[i] = self.state[self.pos]
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == _R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool):
        if more:
            assert flags == self.cur_flags, "ops cannot be interleaved"
            return
        assert flags & _FLAG_T == 0, "transport not supported"
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        force_f = 0 != (flags & (_FLAG_C | _FLAG_K))
        if force_f and self.pos != 0:
            self._run_f()

    def meta_ad(self, data: bytes, more: bool):
        self._begin_op(_FLAG_M | _FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool):
        self._begin_op(_FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(_FLAG_I | _FLAG_A | _FLAG_C, more)
        return self._squeeze(n)


# -- Merlin framing -------------------------------------------------------------


class MerlinTranscript:
    """merlin::Transcript, byte for byte."""

    def __init__(self, label: bytes):
        self.strobe = Strobe128(b"Merlin v1.0")
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes):
        self.strobe.meta_ad(label + len(message).to_bytes(4, "little"), False)
        self.strobe.ad(message, False)

    def append_u64(self, label: bytes, x: int):
        self.append_message(label, x.to_bytes(8, "little"))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label + n.to_bytes(4, "little"), False)
        return self.strobe.prf(n, False)


# -- the range proof's transcript over Merlin -----------------------------------


class MerlinBppTranscript:
    """The Bulletproofs+ Fiat-Shamir flow over a Merlin transcript, with
    ShaTranscript's interface. Points arrive as affine tuples (None for the
    identity) or as the port's point tensors, decoded here."""

    challenges_known_ahead = False

    def __init__(self, m: int, label: bytes = b"rangeproof v1"):
        self.t = MerlinTranscript(label)
        self.t.append_u64(b"m", m)
        self.m = m

    def _append_point(self, curve, label: bytes, P):
        from .serialize import point_bytes

        aff = P if (P is None or isinstance(P, tuple)) else curve.decode_point(P)
        self.t.append_message(label, point_bytes(curve, aff))

    def _challenge_scalar(self, curve, label: bytes) -> int:
        wide = self.t.challenge_bytes(label, 64)
        c = int.from_bytes(wide, "little") % curve.fn.p
        return c if c != 0 else 1

    def challenge_yz(self, curve, commitments, A):
        for V in commitments:
            self._append_point(curve, b"V", V)
        self._append_point(curve, b"A", A)
        return (self._challenge_scalar(curve, b"y"),
                self._challenge_scalar(curve, b"z"))

    def round_challenge(self, curve, L, R) -> int:
        self._append_point(curve, b"L", L)
        self._append_point(curve, b"R", R)
        return self._challenge_scalar(curve, b"e")

    def final_challenge(self, curve, A, B) -> int:
        self._append_point(curve, b"A", A)
        self._append_point(curve, b"B", B)
        return self._challenge_scalar(curve, b"e")
