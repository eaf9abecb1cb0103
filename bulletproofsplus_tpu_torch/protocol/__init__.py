"""The protocol layer: containers, the batch prover, exponent vectors, batch verify."""
from .batch import batch_verify, batch_verify_identify
from .batchprove import batch_prove
from .publickey import PublicKey
from .range import ProofBatch, RangeProof, RangeProver, prove, stack_commitments, verify
from .wip import WipProof

__all__ = ["ProofBatch", "PublicKey", "RangeProof", "RangeProver", "WipProof",
           "batch_prove", "batch_verify", "batch_verify_identify", "prove",
           "stack_commitments", "verify"]
