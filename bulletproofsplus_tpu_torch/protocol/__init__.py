"""The verifier's protocol layer: containers, exponent vectors, batch verify."""
from .batch import batch_verify
from .publickey import PublicKey
from .range import ProofBatch, RangeProof, stack_commitments, verify
from .wip import WipProof

__all__ = ["ProofBatch", "PublicKey", "RangeProof", "WipProof", "batch_verify",
           "stack_commitments", "verify"]
