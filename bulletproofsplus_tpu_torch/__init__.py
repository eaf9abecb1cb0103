"""bulletproofsplus_tpu_torch — the PyTorch/CUDA port of bulletproofsplus_tpu.

The port covers batch range-proof proving and verification on
edwards25519, secp256k1 and bls12-381 G1 in the sound fs256 transcript
mode, the default (a SHA-256 chain the card runs itself: the verifier
replays it on the card, the prover draws its challenges inside the fold),
in the interactive sha and merlin modes (host hashes, one round trip a
round for the whole batch), and in the deterministic mode, behind the
facade `RangeProofSystem`: field and curve arithmetic on (..., L) tensors
of 32-bit limbs (L = 8 for every scalar field and the 256-bit base
fields, 12 for bls12-381's Fq; extended Edwards and projective
Weierstrass points), the joint-ladder and
fixed-base MSMs, the K-batched prover (bit commitment, setup, the whole WIP
fold), the exponent-vector programs and the random-linear-combination batch
verifier. Five hand-written Hopper kernels (csrc/) carry it: K1 Montgomery
multiply, with the field layer around it (add, sub, neg, sum, constant
power) as kernels of the same source, K2 joint ladder, K3 grouped point
sum, K4 fixed-base lookup, K5 per-lane ladder; K2-K5 each in an Edwards and
a Weierstrass form. A sixth, SHA-256 over a batch of messages, hashes the
fs256 transcript. Entry points place tensors on the CUDA card unless the
caller passes a device; on CPU tensors every kernel wrapper runs its plain
PyTorch version, on CUDA tensors it launches the kernel. The package never
imports jax or bulletproofsplus_tpu.

Public API (the JAX package's, bulletproofsplus_tpu/__init__.py:13-69):
    Config, RangeProofSystem (the facade), curve_ops, CURVE_NAMES,
    PublicKey, RangeProver, RangeProof, ProofBatch, prove, batch_prove,
    verify, batch_verify, batch_verify_identify, Fs256Transcript,
    ShaTranscript, DeterministicTranscript, DeterministicRng, SystemRng,
    VerificationError, FormatError; merlin.MerlinBppTranscript.
"""
from . import errors
from .config import Config, RangeProofSystem
from .curves import CURVE_NAMES, curve_ops
from .errors import FormatError, ProofError, VerificationError
from .protocol import (
    ProofBatch,
    PublicKey,
    RangeProof,
    RangeProver,
    WipProof,
    batch_prove,
    batch_verify,
    batch_verify_identify,
    prove,
    stack_commitments,
    verify,
)
from .transcript import (
    DeterministicRng,
    DeterministicTranscript,
    Fs256Transcript,
    ShaTranscript,
    SystemRng,
)

__version__ = "0.1.0"

__all__ = [
    "CURVE_NAMES",
    "Config",
    "DeterministicRng",
    "DeterministicTranscript",
    "FormatError",
    "Fs256Transcript",
    "ProofBatch",
    "ProofError",
    "PublicKey",
    "RangeProof",
    "RangeProofSystem",
    "RangeProver",
    "ShaTranscript",
    "SystemRng",
    "VerificationError",
    "WipProof",
    "batch_prove",
    "batch_verify",
    "batch_verify_identify",
    "curve_ops",
    "errors",
    "prove",
    "stack_commitments",
    "verify",
    "__version__",
]
