"""Fiat-Shamir transcripts of the port: the deterministic mode only.

Port of bulletproofsplus_tpu/transcript.py:28-67. DeterministicTranscript
replays the reference's stripped-transcript constants (single y = z = 7,
aggregated y = 12, z = 23, round challenges 7, final 99): the differential
test mode, NOT a sound proof system. The sound fs256 transcript and its
batched device replay come with a later slice.
"""
from __future__ import annotations


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
