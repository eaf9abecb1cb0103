"""Fiat-Shamir transcripts and blinding sources of the port.

Port of bulletproofsplus_tpu/transcript.py:28-67, :70-135, :129-219 and
:222-239. Fs256Transcript is the sound default (the JAX package's too,
protocol/range.py:196): a SHA-256 chain over word-aligned messages whose
byte protocol the card evaluates itself (hashers_device.py,
protocol/fs256.py), so batch verify replays it on the card and batch prove
draws its challenges inside the fold; this class is its host twin.
DeterministicTranscript and DeterministicRng replay the reference's
stripped-transcript constants (single y = z = 7, aggregated y = 12, z = 23,
round challenges 7, final 99; α 7/33, round blinds 4/5, final blinds
33/44/88/123): the differential test mode, NOT a sound proof system.
ShaTranscript (SHA-512, length-framed absorbs) and merlin.py's
MerlinBppTranscript are the interactive transcripts: host hashes over
affine points, so the prover fetches each round's L and R from the card
(protocol/batchprove.py). SystemRng draws blinds from `secrets` and is the
prover's default rng.
"""
from __future__ import annotations

import hashlib
import secrets

import numpy as np


class DeterministicTranscript:
    """Reference constants (range/mod.rs:109-110, :278-279; wip:131, :211).
    Challenges never depend on the proof, so replay never decodes a point."""

    challenges_known_ahead = True

    def __init__(self, m: int):
        self.m = m

    def challenge_yz(self, curve=None, commitments=None, A=None):
        return (7, 7) if self.m == 1 else (12, 23)

    def round_challenge(self, curve=None, L=None, R=None) -> int:
        return 7

    def final_challenge(self, curve=None, A=None, B=None) -> int:
        return 99


class ShaTranscript:
    """Domain-separated SHA-512 Fiat-Shamir transcript (the JAX package's,
    byte for byte). Every absorb is framed by lengths: be16(len(tag)) ‖ tag
    ‖ be64(len(data)) ‖ data. A point absorbs as the byte 01 ‖ x ‖ y (affine,
    big-endian, the base field's byte length), the identity as the byte 00. A
    challenge absorbs its label and be64(counter), then reduces the running
    SHA-512 digest mod the group order, 0 mapped to 1.

    Points arrive as affine tuples (None for the identity, as the port's
    host decode gives it) or as the port's point tensors, decoded here."""

    challenges_known_ahead = False

    def __init__(self, m: int, label: bytes = b"bulletproofsplus_tpu"):
        self._h = hashlib.sha512()
        self._absorb(b"label", label)
        self._absorb(b"m", m.to_bytes(8, "big"))
        self._counter = 0

    def _absorb(self, tag: bytes, data: bytes) -> None:
        self._h.update(len(tag).to_bytes(2, "big") + tag)
        self._h.update(len(data).to_bytes(8, "big") + data)

    def _point_bytes(self, curve, P) -> bytes:
        aff = P if (P is None or isinstance(P, tuple)) else curve.decode_point(P)
        if aff is None:
            return b"\x00"
        nbytes = (curve.fp.p.bit_length() + 7) // 8
        return b"\x01" + aff[0].to_bytes(nbytes, "big") + aff[1].to_bytes(nbytes, "big")

    def append_point(self, curve, label: bytes, P) -> None:
        self._absorb(label, self._point_bytes(curve, P))

    def _challenge(self, curve, label: bytes) -> int:
        self._counter += 1
        self._absorb(b"challenge", label + self._counter.to_bytes(8, "big"))
        c = int.from_bytes(self._h.copy().digest(), "big") % curve.fn.p
        return c if c != 0 else 1

    def challenge_yz(self, curve, commitments, A) -> tuple:
        for i, V in enumerate(commitments):
            self.append_point(curve, b"V%d" % i, V)
        self.append_point(curve, b"A", A)
        return self._challenge(curve, b"y"), self._challenge(curve, b"z")

    def round_challenge(self, curve, L, R) -> int:
        self.append_point(curve, b"L", L)
        self.append_point(curve, b"R", R)
        return self._challenge(curve, b"e")

    def final_challenge(self, curve, A, B) -> int:
        self.append_point(curve, b"A_wip", A)
        self.append_point(curve, b"B", B)
        return self._challenge(curve, b"e_final")


FS256_LABEL = b"bulletproofsplus-tpu fs256 v1   "  # 32 bytes, word-aligned


class Fs256Transcript:
    """SHA-256 Fiat-Shamir transcript whose every message has a static,
    word-aligned length, so the card runs the same chain (the host twin of
    protocol/fs256.py, byte for byte).

    Chain: state_0 = SHA256(label32 ‖ be32(m)); absorbing k points,
    state = SHA256(state ‖ tag4 ‖ x_1 ‖ y_1 ‖ ...) with affine coordinates
    as big-endian integers of the base field's byte length; the identity is
    the family's image under Z⁻¹ = 0⁻¹ = 0, (0, 1) on Edwards curves and
    (0, 0) on Weierstrass curves. A challenge: state = SHA256(state ‖ "chal"
    ‖ tag4 ‖ be32(counter)), then c = int(SHA256(state ‖ be32(1)) ‖
    SHA256(state ‖ be32(2))) mod the group order, 0 mapped to 1.

    Points arrive as affine tuples (None for the identity) or as the port's
    point tensors, which are decoded here."""

    challenges_known_ahead = False
    device_graph = True

    def __init__(self, m: int, label: bytes = FS256_LABEL):
        assert len(label) == 32
        self._state = hashlib.sha256(label + m.to_bytes(4, "big")).digest()
        self._counter = 0

    # -- byte protocol ------------------------------------------------------

    def _coord_bytes(self, curve, P) -> bytes:
        cbytes = (curve.fp.p.bit_length() + 7) // 8
        aff = P if (P is None or isinstance(P, tuple)) else curve.decode_point(P)
        if aff is None:
            aff = (0, 1) if curve.COORDS == 4 else (0, 0)
        return aff[0].to_bytes(cbytes, "big") + aff[1].to_bytes(cbytes, "big")

    def _absorb_points(self, curve, tag4: bytes, points) -> None:
        assert len(tag4) == 4
        msg = self._state + tag4 + b"".join(self._coord_bytes(curve, P) for P in points)
        self._state = hashlib.sha256(msg).digest()

    def _challenge(self, curve, tag4: bytes) -> int:
        self._counter += 1
        self._state = hashlib.sha256(self._state + b"chal" + tag4
                                     + self._counter.to_bytes(4, "big")).digest()
        d = (hashlib.sha256(self._state + (1).to_bytes(4, "big")).digest()
             + hashlib.sha256(self._state + (2).to_bytes(4, "big")).digest())
        c = int.from_bytes(d, "big") % curve.fn.p
        return c if c != 0 else 1

    # -- transcript API -------------------------------------------------------

    def challenge_yz(self, curve, commitments, A) -> tuple:
        self._absorb_points(curve, b"stmt", list(commitments) + [A])
        return self._challenge(curve, b"y   "), self._challenge(curve, b"z   ")

    def round_challenge(self, curve, L, R) -> int:
        self._absorb_points(curve, b"LR  ", [L, R])
        return self._challenge(curve, b"e   ")

    def final_challenge(self, curve, A, B) -> int:
        self._absorb_points(curve, b"AB  ", [A, B])
        return self._challenge(curve, b"ef  ")

    # -- device handoff -------------------------------------------------------

    def state_words(self) -> np.ndarray:
        """The 32-byte state as (8,) uint32 words: where the card's chain
        starts."""
        return np.frombuffer(self._state, dtype=">u4").astype(np.uint32)

    @staticmethod
    def stacked_state_words(transcripts) -> np.ndarray:
        """The states of K fs256 transcripts as (K, 8) uint32 words, read in
        one pass over their bytes (a batch's start states for the card)."""
        return np.frombuffer(b"".join(t._state for t in transcripts),
                             dtype=">u4").astype(np.uint32).reshape(-1, 8)

    def set_state_words(self, words, n_challenges: int) -> None:
        """Adopt the card's final state (8 words, uint32 values or their
        int32 bit patterns) and count the challenges it drew."""
        self._state = b"".join((int(x) & 0xFFFFFFFF).to_bytes(4, "big")
                               for x in np.asarray(words).reshape(-1))
        self._counter += n_challenges


class DeterministicRng:
    """Reference constants: alpha 7/33 (range/mod.rs:94, :256), round blinds
    d_L=4 d_R=5 (wip:94-95), final r=33 s=44 delta=88 eta=123 (wip:175-178)."""

    blinds_known_ahead = True

    def __init__(self, m: int):
        self.m = m

    def alpha(self) -> int:
        return 7 if self.m == 1 else 33

    def round_blinds(self):
        return (4, 5)

    def final_blinds(self):
        return (33, 44, 88, 123)


class SystemRng:
    """Cryptographically random blindings in [1, order) over the curve's
    scalar field."""

    def __init__(self, order: int):
        self.order = order

    def _r(self) -> int:
        return secrets.randbelow(self.order - 1) + 1

    def alpha(self) -> int:
        return self._r()

    def round_blinds(self):
        return (self._r(), self._r())

    def final_blinds(self):
        return (self._r(), self._r(), self._r(), self._r())
