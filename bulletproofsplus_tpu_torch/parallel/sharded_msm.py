"""MSMs sharded over a device mesh.

Port of bulletproofsplus_tpu/parallel/sharded_msm.py. An MSM's pair axis is
independent work until the final sum: each device reduces its own slice of
(scalar, point) pairs to one partial point (K2's group outputs, or K4's
partials over its own table slice, then one K3 over them: `shard_partial`),
and the partial points are copied to the first device of the mesh row and
summed there by one more K3 (`gather_sum`). One host thread enqueues every
shard's launches on its own device without waiting for any of them, so
distinct cards run their shards at the same time.

Shards pad only to a multiple of the mesh axis, with zero scalars and
identity points; the JAX package pads each shard to a power of two
(:121, :207) to bound its compile count, which an eager program does not
need (at BASELINE config 5 it would grow 39,938 lanes to 65,536).
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from ..msm.engine import msm_partials, tree_sum
from ..msm.fixed import fixed_msm_partials


def pad_pairs(curve, scalars, points, total: int):
    """Pad the pair axis (scalars (..., N, S), points (..., N, C, L)) to
    `total` with zero scalars and identity points."""
    n = points.shape[-3]
    if total == n:
        return scalars, points
    lead = points.shape[:-3]
    scalars = torch.cat([scalars, scalars.new_zeros(*lead, total - n, scalars.shape[-1])],
                        dim=-2)
    points = torch.cat([points, curve.identity_like((*lead, total - n), points.device)],
                       dim=-3)
    return scalars, points


def shard_partial(curve, device, scalars=None, points=None, gen_scalars=None, table=None,
                  nbits: int | None = None):
    """One shard's partial point(s) (..., C, L) on `device`: K2 over its
    (scalar, point) pairs (plain scalars (..., N, S), points (..., N, C, L))
    and K4 over its generator slice (gen_scalars (N', S) against `table`,
    the slice's own table on `device`), then one K3 over both, as
    protocol/batch.py::verify_stacked sums its two MSMs."""
    parts = []
    if points is not None:
        parts.append(msm_partials(curve, scalars.to(device, non_blocking=True),
                                  points.to(device, non_blocking=True), nbits))
    if table is not None:
        parts.append(fixed_msm_partials(curve, gen_scalars.to(device, non_blocking=True),
                                        table, nbits))
    return tree_sum(curve, torch.cat(parts, dim=-3))


def gather_sum(curve, parts, device):
    """Σ of the shards' partial points (each (..., C, L) on its device):
    copied to `device` in mesh order and summed by one K3."""
    with record_function("bpp::shard_gather"):
        return tree_sum(curve, torch.stack([p.to(device, non_blocking=True) for p in parts],
                                           dim=-3))


def all_processes(ok: bool, mesh) -> bool:
    """This process's verdict, and with a mesh over several processes
    theirs too: one all-reduce (MIN) of an int on a CPU tensor."""
    if mesh.world <= 1:
        return ok
    import torch.distributed as dist

    t = torch.tensor([int(ok)], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def replicated_all_identity(curve, expected, mesh) -> bool:
    """Whether every point of `expected` (..., C, L) is the identity, in
    every process of the mesh (all_processes)."""
    with record_function("bpp::verdict"):
        return all_processes(bool(curve.is_identity(expected).all()), mesh)


def sharded_msm(curve, scalars, points, mesh, axis: str = "tp", nbits: int | None = None):
    """Σ scalars[i]·points[i] (plain scalars (N, S), points (N, C, L)) with
    the pair axis split over mesh[axis]: device j takes pairs [j·N', (j+1)·N')
    of N padded to a multiple P·N'; the result (C, L) is on the axis's first
    device."""
    devs = mesh.axis_devices(axis)
    P = len(devs)
    per = -(-points.shape[0] // P)
    scalars, points = pad_pairs(curve, scalars, points, per * P)
    with record_function("bpp::sharded_msm"):
        parts = [shard_partial(curve, d, scalars[j * per:(j + 1) * per],
                               points[j * per:(j + 1) * per], nbits=nbits)
                 for j, d in enumerate(devs)]
    return gather_sum(curve, parts, devs[0])


def sharded_msm_rows(curve, scalars, points, mesh, nbits: int | None = None):
    """B independent MSMs (plain scalars (B, N, S), points (B, N, C, L)) over
    this process's mesh rows: row b on mesh row b mod dp, its pairs split
    over the row's tp devices. The rows pad to a multiple of dp with
    zero-scalar rows (their MSM is the identity). Returns (B, C, L) on the
    first device. On a mesh that spans processes each process passes the
    rows of its own mesh rows."""
    rows = mesh.devices
    dp, tp = len(rows), len(rows[0])
    B, n = points.shape[:2]
    Bp = -(-B // dp) * dp
    per = -(-n // tp)
    if Bp != B:
        scalars = torch.cat([scalars, scalars.new_zeros(Bp - B, *scalars.shape[1:])])
        points = torch.cat([points, curve.identity_like((Bp - B, n), points.device)])
    scalars, points = pad_pairs(curve, scalars, points, per * tp)
    with record_function("bpp::sharded_msm"):
        parts = [[shard_partial(curve, d, scalars[r::dp, t * per:(t + 1) * per],
                                points[r::dp, t * per:(t + 1) * per], nbits=nbits)
                  for t, d in enumerate(row)] for r, row in enumerate(rows)]
    outs = [gather_sum(curve, p, row[0]) for p, row in zip(parts, rows)]
    first = rows[0][0]
    with record_function("bpp::shard_gather"):
        # outs[r][j] is row j·dp + r
        return torch.stack([o.to(first, non_blocking=True) for o in outs], dim=1).reshape(
            Bp, *outs[0].shape[1:])[:B]


def sharded_fixed_msm(curve, scalars, table, mesh, axis: str = "tp",
                      nbits: int | None = None):
    """Fixed-base MSM (msm/fixed.py) with the generator axis split over
    mesh[axis]: scalars (N, S) plain; `table` the JAX package's one table
    sharded over the axis, here its slices, one per device of the axis,
    slice j built on device j from generators [j·N/P, (j+1)·N/P)
    (PublicKey.fixed_tables(mn, devices) or msm.fixed.precompute_slice_tables).
    Each device looks up its own slice (K4, then K3); the P partials are
    summed on the first device. N must split evenly over the axis."""
    devs = mesh.axis_devices(axis)
    P = len(devs)
    if scalars.shape[0] % P or len(table) != P:
        raise ValueError("table point axis must divide the mesh axis")
    per = scalars.shape[0] // P
    with record_function("bpp::sharded_msm"):
        parts = [shard_partial(curve, d, gen_scalars=scalars[j * per:(j + 1) * per],
                               table=table[j], nbits=nbits)
                 for j, d in enumerate(devs)]
    return gather_sum(curve, parts, devs[0])
