"""Fiat-Shamir transcripts and blinding sources of the port.

Port of bulletproofsplus_tpu/transcript.py:28-67 and :222-239.
DeterministicTranscript and DeterministicRng replay the reference's
stripped-transcript constants (single y = z = 7, aggregated y = 12, z = 23,
round challenges 7, final 99; α 7/33, round blinds 4/5, final blinds
33/44/88/123): the differential test mode, NOT a sound proof system.
SystemRng draws blinds from `secrets` and is the prover's default rng. The
sound fs256 transcript and its batched device replay come with a later
slice.
"""
from __future__ import annotations

import secrets


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
