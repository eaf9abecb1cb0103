"""bulletproofsplus_tpu_torch — the PyTorch/CUDA port of bulletproofsplus_tpu.

This slice ports batch range-proof verification on edwards25519: field and
curve arithmetic on (..., 8) tensors of 32-bit limbs, the joint-ladder and
fixed-base MSMs, the exponent-vector programs and the random-linear-
combination batch verifier. Four hand-written Hopper kernels (csrc/) carry
it: K1 Montgomery multiply, K2 joint ladder, K3 grouped point sum, K4
fixed-base lookup. On CPU tensors every kernel wrapper runs its plain
PyTorch version; on CUDA tensors it launches the kernel. The package never
imports jax or bulletproofsplus_tpu.

Public API:
    curve_ops, PublicKey, RangeProof, ProofBatch, batch_verify, verify,
    DeterministicTranscript, VerificationError, FormatError
"""
from .curves import curve_ops
from .errors import FormatError, ProofError, VerificationError
from .protocol import (
    ProofBatch,
    PublicKey,
    RangeProof,
    WipProof,
    batch_verify,
    stack_commitments,
    verify,
)
from .transcript import DeterministicTranscript

__all__ = [
    "DeterministicTranscript",
    "FormatError",
    "ProofBatch",
    "ProofError",
    "PublicKey",
    "RangeProof",
    "VerificationError",
    "WipProof",
    "batch_verify",
    "curve_ops",
    "stack_commitments",
    "verify",
]
