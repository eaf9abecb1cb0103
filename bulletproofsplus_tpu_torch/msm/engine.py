"""Multi-scalar multiplication over variable points.

Port of bulletproofsplus_tpu/msm/engine.py. Every MSM runs the J-way joint
ladder (K2): consecutive groups of J (scalar, point) pairs share their
doublings and give one point per group (`msm_partials`), then the grouped
sum (K3) reduces the groups. J follows the lane count as in
engine.py:241-262. The JAX package's width canonicalization and XLA scan
ladder exist to bound TPU compile counts; PyTorch runs eagerly, so the port
has one path.

Scalars are PLAIN-form (non-Montgomery) (..., N, S) limbs over the scalar
field, S = curve.fn.L; points are (..., N, C, L) with C = curve.COORDS and
L = curve.fp.L.
"""
from __future__ import annotations

import torch

from ..curves.cuda_curve import joint_ladder_msm_grouped, sum_points_grouped


def joint_width(lanes: int) -> int:
    """Pairs per joint-ladder group by total lane count (engine.py:253-254)."""
    return 8 if lanes >= 4096 else 4 if lanes >= 2048 else 2


def scalar_mul(curve, scalars, points, nbits: int | None = None):
    """out[i] = scalars[i]·points[i]: the 1-way ladder (K2 with J = 1)."""
    nbits = nbits or curve.fn.order_bits
    out = joint_ladder_msm_grouped(curve, scalars[..., None, :],
                                   points[..., None, :, :], nbits, 1)
    return out[..., 0, :, :]


def tree_sum(curve, points):
    """Σ points over axis -3 (K3); leading axes are independent sums."""
    return sum_points_grouped(curve, points)


def msm_partials(curve, scalars, points, nbits: int | None = None):
    """The MSM's unreduced terms: K2's group outputs (..., ⌈N/J⌉, C, L),
    whose sum over axis -3 is Σ_i scalars[i]·points[i]. Pads the pair axis
    to a multiple of J with zero scalars and identity points."""
    nbits = nbits or curve.fn.order_bits
    lead = points.shape[:-3]
    W = points.shape[-3]
    S = curve.fn.L
    scalars = scalars.expand(*lead, W, S)
    lanes = W
    for d in lead:
        lanes *= d
    J = joint_width(lanes)
    W2 = -(-W // J) * J
    if W2 != W:
        scalars = torch.cat([scalars, scalars.new_zeros(*lead, W2 - W, S)], dim=-2)
        pad = curve.identity_like((*lead, W2 - W), points.device)
        points = torch.cat([points, pad], dim=-3)
    return joint_ladder_msm_grouped(curve, scalars, points, nbits, J)


def msm(curve, scalars, points, nbits: int | None = None):
    """Σ_i scalars[i]·points[i] over axis -3; leading axes are independent
    MSMs: K3 over msm_partials."""
    return tree_sum(curve, msm_partials(curve, scalars, points, nbits))
