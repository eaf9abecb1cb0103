"""Error taxonomy, mirroring the reference's src/errors.rs.

A copy of bulletproofsplus_tpu/errors.py: the port cannot import the JAX
package (its __init__ imports jax), so it carries its own classes.

The reference defines `ProofError` (7 variants), `MPCError`, and `R1CSError`
(errors.rs:14-161); only `VerificationError` is produced on the active code
path (range/mod.rs:508, weighted_inner_product_proof.rs:326). We mirror the
taxonomy as an exception hierarchy so API users can catch the same classes of
failure.
"""
from __future__ import annotations


class ProofError(Exception):
    """Base class for proof failures (reference errors.rs:14-50)."""


class VerificationError(ProofError):
    """Proof verification failed (reference errors.rs:17)."""

    def __init__(self, msg: str = "Proof verification failed."):
        super().__init__(msg)


class FormatError(ProofError):
    """Proof data could not be parsed (reference errors.rs:19)."""

    def __init__(self, msg: str = "Proof data could not be parsed."):
        super().__init__(msg)


class WrongNumBlindingFactors(ProofError):
    """Wrong number of blinding factors supplied (reference errors.rs:23)."""


class InvalidBitsize(ProofError):
    """Invalid bitsize, must have n = 8, 16, 32, or 64 (reference errors.rs:27)."""


class InvalidAggregation(ProofError):
    """Aggregation size m must be a power of two (reference errors.rs:31-35)."""


class InvalidGeneratorsLength(ProofError):
    """Too few generators for proof (reference errors.rs:37-41)."""


class ProvingError(ProofError):
    """Internal error during proof creation (reference errors.rs:48-49)."""


class MPCError(Exception):
    """Multiparty-computation protocol errors (reference errors.rs:72-116)."""


class MaliciousDealer(MPCError):
    """Dealer gave a malicious (zero) challenge value."""


class R1CSError(Exception):
    """Constraint-system proof errors (reference errors.rs:123-150)."""
