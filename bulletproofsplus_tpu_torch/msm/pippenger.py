"""The Pippenger bucket MSM, and the switches that route to it.

Port of bulletproofsplus_tpu/msm/pippenger.py. Each (point, window) pair
costs one bucket add; the doublings are shared by the whole MSM (one Horner
pass a row), where the joint ladder (msm/engine.py) pays about nbits
doublings for every group of J pairs. The kernels are curves/cuda_curve.py's
`bucket_msm` (csrc/pippenger.cu): buckets in global memory, a thread per
(row, slice, window) owning its buckets, so no atomics, then a merge of the
slices, the per-window sums and Horner. The JAX package's slice grid
(`_pick_grid`, BPP_PIPPENGER_K) sizes a TPU scan; the kernel chooses its own
slices from the card (cuda_curve.bucket_layout), so BPP_PIPPENGER_K is not
read.

The switches are read from the environment at call time, under the JAX
package's names and defaults: BPP_PIPPENGER (off unless set to other than
"0"), BPP_PIPPENGER_MIN (4,096 lanes) and BPP_PIPPENGER_C (the window, 6
bits). The JAX package asserts that the window divides its 12- or 24-bit
limbs; here any window of 1 to 16 bits works (a digit that straddles two
32-bit words is read from their 64-bit pair).
"""
from __future__ import annotations

import math
import os

import torch

from ..curves.cuda_curve import bucket_msm


def window() -> int:
    """The bucket window c in bits (BPP_PIPPENGER_C, default 6)."""
    c = int(os.environ.get("BPP_PIPPENGER_C", "6"))
    if not 1 <= c <= 16:
        raise ValueError("BPP_PIPPENGER_C must be 1 to 16")
    return c


def pippenger_enabled() -> bool:
    """Whether a large enough row MSM takes the buckets: BPP_PIPPENGER set to
    anything but "0" (pippenger.py:198-207); off by default."""
    env = os.environ.get("BPP_PIPPENGER")
    return env is not None and env != "0"


def pippenger_min_lanes() -> int:
    """Lanes from which the coefficient prover's rows take the buckets
    (BPP_PIPPENGER_MIN, default 4,096; pippenger.py:210-214)."""
    return int(os.environ.get("BPP_PIPPENGER_MIN", "4096"))


def shared_rows(points, lead):
    """points (..., N, C, L) broadcast to the MSMs' leading shape `lead`, as
    (prow, N, C, L) rows for bucket_msm: leading axes that the points only
    broadcast over (size 1 or stride 0) are dropped, so K proofs over one
    key's generators read one copy; the rest must be the trailing axes of
    `lead`, else the points are expanded to it."""
    pts = points
    while pts.dim() > 3 and (pts.shape[0] == 1 or pts.stride(0) == 0):
        pts = pts[0]
    plead = tuple(pts.shape[:-3])
    if plead and tuple(lead[len(lead) - len(plead):]) != plead:
        pts = points.expand(*lead, *points.shape[-3:])
        plead = tuple(lead)
    return pts.reshape(math.prod(plead), *pts.shape[-3:])


def msm_pippenger(curve, scalars, points, nbits: int | None = None):
    """Σ_i scalars[i]·points[i] over axis -3 of points, engine.msm's contract
    (pippenger.py:156-195): plain-form scalars (..., N, S), points
    (..., N, C, L); leading axes are independent MSMs and broadcast."""
    nbits = nbits or curve.fn.order_bits
    N, S = points.shape[-3], curve.fn.L
    lead = torch.broadcast_shapes(scalars.shape[:-2], points.shape[:-3])
    pts = shared_rows(points, lead)
    scal = scalars.expand(*lead, N, S).reshape(-1, N, S)
    out = bucket_msm(curve, scal, pts, nbits, window())
    return out.reshape(*lead, *out.shape[-2:])
