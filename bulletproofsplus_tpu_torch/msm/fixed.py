"""Fixed-base MSM via precomputed window tables (BGMW).

Port of bulletproofsplus_tpu/msm/fixed.py. For fixed base points P_i the
doublings of a ladder move into a one-time table

    T[k, j, i] = k · (2^(4j) · P_i)     k ∈ [0, 16), j ∈ [0, nwin)

after which Σ_i s_i·P_i = Σ_i Σ_j T[d_ij, j, i], a lookup and one add per
(window, point) lane (K4, whose partial points `fixed_msm_partials` gives,
then K3 over them). Signed tables hold
entries k ∈ [1, 8] (half the memory) for balanced digits; negative digits
negate the selected point and digit 0 selects the identity.

The table is entry-major (nent, nwin·N, C, L), which is also the kernel's
layout, so no separate kernel layout exists. At 2mn = 2048 edwards25519
points the unsigned table holds 16·64·2048 points of 128 bytes: 268 MB; at
2mn = 8192 secp256k1 points 16·64·8192 points of 96 bytes: 805 MB; at
2mn = 32768 bls12-381 points 16·64·32768 points of 144 bytes: 4.83 GB, still
under the 7 GiB budget, so every cell's verifier takes the unsigned table.
The budget is BPP_FIXED_BASE_MAX_BYTES, as in the JAX package; above it no
table is built and the generator lanes run on the joint ladder
(protocol/batch.py::verify_stacked). Over a mesh, each device holds the
table of its own slice of the generators (`precompute_slice_tables`), a
table of its own and not a view of the whole one, since the layout is
entry-major.
"""
from __future__ import annotations

import os

import torch

from ..curves.cuda_curve import (
    WINDOW,
    fixed_digits,
    fixed_lookup_partials,
    sum_points_grouped,
)

DEFAULT_MAX_BYTES = 7 * 1024**3


def point_bytes(curve) -> int:
    """Device bytes of one point: C coordinates of L × 32-bit limbs."""
    return curve.COORDS * curve.fp.L * 4


def table_bytes(curve, n_points: int, nbits: int | None = None,
                signed: bool = False) -> int:
    """Device bytes of the window table for n_points fixed bases."""
    nbits = nbits or curve.fn.order_bits
    if signed:
        nent, nwin = 1 << (WINDOW - 1), curve.fn.signed_window_count(nbits, WINDOW)
    else:
        nent, nwin = 1 << WINDOW, -(-nbits // WINDOW)
    return nent * nwin * n_points * point_bytes(curve)


def fixed_base_mode(curve, n_points: int, max_bytes: int | None = None):
    """"unsigned" when its table fits max_bytes (one select fewer per
    lookup); else "signed" when that fits; else None: no table fits and
    verify runs the generator lanes on the ladder, as the JAX package does.
    max_bytes defaults to BPP_FIXED_BASE_MAX_BYTES, else 7 GiB
    (bulletproofsplus_tpu/msm/fixed.py::_budget). At 7 GiB signed tables
    fit up to 2mn ≈ 110,000 on edwards25519, ≈ 146,000 on secp256k1 and
    ≈ 102,000 on bls12-381."""
    if max_bytes is None:
        max_bytes = int(os.environ.get("BPP_FIXED_BASE_MAX_BYTES", DEFAULT_MAX_BYTES))
    if table_bytes(curve, n_points) <= max_bytes:
        return "unsigned"
    if table_bytes(curve, n_points, signed=True) <= max_bytes:
        return "signed"
    return None


def _window_chain(curve, points, nwin: int):
    """Q[..., j, :] = 2^(4j)·P: (..., nwin, N, C, L) for points (..., N, C, L)."""
    chain = [points]
    for _ in range(nwin - 1):
        q = chain[-1]
        for _ in range(WINDOW):
            q = curve.dbl(q)
        chain.append(q)
    return torch.stack(chain, dim=-4)


def precompute_tables(curve, points, nbits: int | None = None):
    """Unsigned table (16, nwin·N, C, L) for base points (N, C, L):
    T[0] = identity, T[k] = T[k-1] + Q (the JAX package's scan order).
    Leading axes of points are independent tables: (..., 16, nwin·N, C, L)."""
    nbits = nbits or curve.fn.order_bits
    Q = _window_chain(curve, points, -(-nbits // WINDOW)).flatten(-4, -3)
    T = [curve.identity_like(Q.shape[:-2], Q.device)]
    for _ in range(1, 1 << WINDOW):
        T.append(curve.add(T[-1], Q))
    return torch.stack(T, dim=-4)


def precompute_tables_signed(curve, points, nbits: int | None = None):
    """Signed table (8, nwin_s·N, C, L): entry k-1 = k·Q for k ∈ [1, 8];
    leading axes as precompute_tables'."""
    nbits = nbits or curve.fn.order_bits
    nwin = curve.fn.signed_window_count(nbits, WINDOW)
    Q = _window_chain(curve, points, nwin).flatten(-4, -3)
    T = [Q]
    for _ in range(1, 1 << (WINDOW - 1)):
        T.append(curve.add(T[-1], Q))
    return torch.stack(T, dim=-4)


def precompute_slice_tables(curve, points, devices, slices, signed: bool = False,
                            nbits: int | None = None) -> list:
    """The tables of equal slices of points (N, C, L): slice i holds points
    [i·N/P, (i+1)·N/P) for P = len(devices), and its table is the one
    precompute_tables (or _signed) builds from those points alone, built on
    devices[i]. Returns the tables of the slice indices `slices`, in order.
    Slices on one device are built together, one pass for all of them."""
    per = points.shape[0] // len(devices)
    build = precompute_tables_signed if signed else precompute_tables
    out = {}
    for dev in dict.fromkeys(devices[i] for i in slices):
        mine = [i for i in slices if devices[i] == dev]
        pts = torch.stack([points[i * per:(i + 1) * per] for i in mine]).to(dev)
        tables = build(curve, pts, nbits)          # (len(mine), nent, nwin·per, C, L)
        out.update(zip(mine, tables.unbind(0)))
    return [out[i] for i in slices]


def fixed_msm_partials(curve, scalars, table, nbits: int | None = None):
    """K4's partial points (P, C, L), whose sum is Σ_i scalars[i]·P_i over
    the table's base points; scalars plain (N, S). The flavor follows the
    table's entry count (8 = signed)."""
    nbits = nbits or curve.fn.order_bits
    signed = table.shape[0] == 1 << (WINDOW - 1)
    return fixed_lookup_partials(curve, table, fixed_digits(curve, scalars, nbits, signed),
                                 signed)


def fixed_msm(curve, scalars, table, nbits: int | None = None):
    """Σ_i scalars[i]·P_i over the table's base points: K3 over
    fixed_msm_partials."""
    return sum_points_grouped(curve, fixed_msm_partials(curve, scalars, table, nbits))
