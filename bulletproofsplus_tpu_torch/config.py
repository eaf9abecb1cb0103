"""The configuration and the user facade: Config, Statement, RangeProofSystem.

Port of bulletproofsplus_tpu/config.py:45-178. One frozen dataclass holds
the knobs (curve, bitsize, aggregation, transcript mode, generators, mesh),
and `RangeProofSystem` binds them to a prover and verifier on one device:
the generators are built once, a transcript and an rng minted per proof.

    cfg = Config(curve="edwards25519", n=64, m=16, mode="fs256")
    system = RangeProofSystem(cfg)                  # on the CUDA card
    st = system.statement([2, 5, ...])              # commit, random blinds
    proof = system.prove(st)
    system.verify(proof, st.commitments)            # raises on failure

Modes: "fs256" (the default; its chain runs on the card), "sha" and
"merlin" (host transcripts; the prover fetches each round's L and R) are
sound with random blinds; "deterministic" replays the reference's
constants with fixed blinds, for differential tests only. With
`mesh_devices`, batch verification runs sharded over that many devices
(parallel/mesh.py::default_mesh: distinct cards on CUDA, the CPU listed
that many times with device="cpu"), as the JAX facade does (config.py:96-101).
"""
from __future__ import annotations

import dataclasses
import secrets
from typing import Optional, Sequence

from .curves import CURVE_NAMES, curve_ops
from .device import entry_device
from .errors import ProvingError
from .merlin import MerlinBppTranscript
from .parallel import default_mesh
from .protocol import (
    ProofBatch,
    PublicKey,
    batch_prove,
    batch_verify,
    batch_verify_identify,
    prove,
    verify,
)
from .protocol.range import RangeProver
from .transcript import (
    DeterministicRng,
    DeterministicTranscript,
    Fs256Transcript,
    ShaTranscript,
    SystemRng,
)

_MODES = ("deterministic", "sha", "fs256", "merlin")


@dataclasses.dataclass(frozen=True)
class Config:
    """All knobs of the proof system in one place.

    curve: one of CURVE_NAMES. n: range bitsize (values below 2^n). m:
    aggregation width (a power of two). mode: the Fiat-Shamir transcript,
    one of "deterministic", "sha", "fs256" (default) and "merlin" (module
    docstring). hash_generators: derive the key's generators by hashing to
    the curve (sound) instead of the reference's small multiples
    (publickey.rs:23-39). mesh_devices: shard verification MSMs over this
    many devices (None = one device)."""

    curve: str = "edwards25519"
    n: int = 64
    m: int = 1
    mode: str = "fs256"
    hash_generators: bool = True
    mesh_devices: Optional[int] = None

    def __post_init__(self):
        if self.curve not in CURVE_NAMES:
            raise ValueError(f"unknown curve {self.curve!r}; one of {CURVE_NAMES}")
        if self.mode not in _MODES:
            raise ValueError(f"unknown mode {self.mode!r}; one of {_MODES}")


@dataclasses.dataclass
class Statement:
    """One range statement: the committed values and their commitments (and,
    on the prover's side, the blinds)."""

    prover: RangeProver

    @property
    def commitments(self):
        return self.prover.commitment_vec


class RangeProofSystem:
    """A prover and verifier bound to one Config, its generators built once
    on `device` (default: the CUDA card; pass "cpu" for the CPU). With
    config.mesh_devices, `mesh` is a (1, mesh_devices) mesh: distinct cards
    on CUDA (raises if the machine has fewer), the CPU listed mesh_devices
    times on the CPU; batch verification runs over it."""

    def __init__(self, config: Config, device=None):
        self.config = config
        self.device = entry_device(device)
        self.curve = curve_ops(config.curve)
        make = PublicKey.new_secure if config.hash_generators else PublicKey.new
        self.pk = make(self.curve, config.n * config.m, device=self.device)
        self.mesh = None
        if config.mesh_devices:
            local = None if self.device.type == "cuda" else [self.device] * config.mesh_devices
            self.mesh = default_mesh(config.mesh_devices, devices=local)

    # -- a transcript and an rng per proof ----------------------------------

    def _transcript(self):
        c = self.config
        if c.mode == "deterministic":
            return DeterministicTranscript(c.m)
        if c.mode == "merlin":
            return MerlinBppTranscript(c.m)
        if c.mode == "fs256":
            return Fs256Transcript(c.m)
        return ShaTranscript(c.m)

    def _rng(self):
        if self.config.mode == "deterministic":
            return DeterministicRng(self.config.m)
        return SystemRng(self.curve.fn.p)

    # -- API ------------------------------------------------------------------

    def statement(self, values: Sequence[int],
                  gammas: Optional[Sequence[int]] = None) -> Statement:
        """Commit m values (random blinds unless gammas are given)."""
        c = self.config
        if len(values) != c.m:
            raise ProvingError(f"expected {c.m} values (config.m), got {len(values)}")
        if gammas is None:
            if c.mode == "deterministic":
                raise ProvingError("deterministic mode needs explicit gammas for parity")
            gammas = [secrets.randbelow(self.curve.fn.p - 1) + 1 for _ in values]
        prover = RangeProver()
        for v, g in zip(values, gammas):
            prover.commit(self.pk, v, g)
        return Statement(prover=prover)

    def prove(self, statement: Statement):
        return prove(self.curve, self.pk, self.config.n, statement.prover,
                     transcript=self._transcript(), rng=self._rng())

    def verify(self, proof, commitments) -> None:
        verify(self.curve, proof, self.pk, self.config.n, commitments,
               transcript=self._transcript())

    def batch_prove(self, statements: Sequence[Statement]) -> ProofBatch:
        K = len(statements)
        return batch_prove(self.curve, self.pk, self.config.n,
                           [s.prover for s in statements],
                           transcripts=[self._transcript() for _ in range(K)],
                           rngs=[self._rng() for _ in range(K)])

    def batch_verify(self, proofs, commitment_lists) -> None:
        batch_verify(self.curve, self.pk, self.config.n, proofs, commitment_lists,
                     transcripts=[self._transcript() for _ in range(len(proofs))],
                     mesh=self.mesh)

    def batch_verify_identify(self, proofs, commitment_lists):
        """The indices of the proofs that fail ([] if all verify), fresh
        transcripts of the configured mode for every sub-batch."""
        return batch_verify_identify(self.curve, self.pk, self.config.n, proofs,
                                     commitment_lists,
                                     transcript_factory=lambda i: self._transcript(),
                                     mesh=self.mesh)

    # -- serialization ----------------------------------------------------------

    def proof_to_bytes(self, proof) -> bytes:
        from .serialize import proof_to_bytes

        return proof_to_bytes(self.curve, proof)

    def proof_from_bytes(self, data: bytes):
        from .serialize import proof_from_bytes

        return proof_from_bytes(self.curve, data, self.device)
