"""Carry values of the JAX package over to the port, through canonical ints.

The JAX package holds a field element as L W-bit limbs (12-bit int32 on the
TPU, 24-bit int64 on the CPU backend) in Montgomery form with R = 2^(W·L),
e.g. 32 × 12 bits (R = 2^384) for bls12-381's Fq; the port holds the field
spec's L' 32-bit words (8, or 12 for bls12-381's Fq) with R = 2^(32·L').
Nothing here imports jax:
arrays come in as anything numpy can read (jax arrays included), each
element is decoded to its canonical integer and re-encoded in the port's
layout. W defaults to the JAX package's rule: 12 bits for int32 limbs, 24
for int64. Points keep their coordinate count: 4 (extended Edwards) or 3
(projective Weierstrass), so the same helpers carry either family. Every
helper places its result on `device`, by default the CUDA card (pass "cpu"
for the CPU).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .device import entry_device
from .protocol.publickey import PublicKey
from .protocol.range import ProofBatch, RangeProver


def jax_limb_bits(arr: np.ndarray) -> int:
    return 12 if arr.dtype == np.int32 else 24


def _limb_ints(arr: np.ndarray, limb_bits: int) -> List[int]:
    rows = arr.reshape(-1, arr.shape[-1])
    out = []
    for row in rows.tolist():
        x = 0
        for limb in reversed(row):
            x = (x << limb_bits) | int(limb)
        out.append(x)
    return out


def field_from_jax(arr, fops, montgomery: bool = True, limb_bits: int | None = None,
                   device=None) -> torch.Tensor:
    """JAX field array (..., L) → port tensor (..., fops.L) in the same form
    (Montgomery or plain) over the port's FieldOps `fops`."""
    device = entry_device(device)
    arr = np.asarray(arr)
    W = limb_bits or jax_limb_bits(arr)
    vals = _limb_ints(arr, W)
    if montgomery:
        rinv = pow(1 << (W * arr.shape[-1]), -1, fops.p)
        out = fops.encode([v * rinv % fops.p for v in vals], device)
    else:
        out = fops.encode_plain(vals, device)
    return out.reshape(*arr.shape[:-1], fops.L)


def points_from_jax(arr, curve, limb_bits: int | None = None, device=None) -> torch.Tensor:
    """JAX points (..., C, L) → port points (..., C, curve.fp.L), C = curve.COORDS."""
    if np.shape(arr)[-2] != curve.COORDS:
        raise ValueError(f"{curve.name} points have {curve.COORDS} coordinates")
    return field_from_jax(arr, curve.fp, True, limb_bits, device)


def publickey_from_jax(jpk, curve, device=None) -> PublicKey:
    """A JAX PublicKey (g, h, G_vec, H_vec) → the port's PublicKey."""
    device = entry_device(device)

    def pts(a):
        return points_from_jax(a, curve, device=device)

    return PublicKey(curve=curve, g=pts(jpk.g), h=pts(jpk.h),
                     G_vec=pts(jpk.G_vec), H_vec=pts(jpk.H_vec))


def proof_batch_from_jax(jbatch, curve, device=None) -> ProofBatch:
    """A JAX ProofBatch → the port's ProofBatch (scalars stay Montgomery)."""
    device = entry_device(device)

    def pts(a):
        return points_from_jax(a, curve, device=device)

    def sc(a):
        return field_from_jax(a, curve.fn, True, device=device)

    return ProofBatch(A=pts(jbatch.A), L_vec=pts(jbatch.L_vec),
                      R_vec=pts(jbatch.R_vec), A_wip=pts(jbatch.A_wip),
                      B=pts(jbatch.B), r_prime=sc(jbatch.r_prime),
                      s_prime=sc(jbatch.s_prime), d_prime=sc(jbatch.d_prime))


def commitments_from_jax(V, curve, device=None) -> torch.Tensor:
    """JAX commitments (K, m, C, L) or (m, C, L) → port points."""
    return points_from_jax(V, curve, device=device)


def range_prover_from_jax(jprover, curve, device=None) -> RangeProver:
    """A JAX RangeProver (witness ints and commitments) → the port's."""
    V = points_from_jax(np.stack([np.asarray(c) for c in jprover.commitment_vec]),
                        curve, device=device)
    return RangeProver(v_vec=[int(v) for v in jprover.v_vec],
                       gamma_vec=[int(g) for g in jprover.gamma_vec],
                       commitment_vec=list(V.unbind(0)))
