"""Batch verification: K proofs → one random-linear-combination MSM.

Port of bulletproofsplus_tpu/protocol/batch.py, homogeneous path
(`_batch_verify_fused_jit` :34-87, `_batch_verify_fused` :147-194,
`batch_verify` :197-257). Every proof's verification is "MSM == identity";
weighting proof k by a random 128-bit w_k and summing keeps one MSM whose
identity implies every term's, with overwhelming probability. The proofs
share the pk generators, so their G/H/g/h exponents merge by field adds:
the 2mn generator lanes run on fixed-base tables (K4) and only the
K·(2·log2(mn)+m+3)+2 proof-specific lanes run the joint ladder (K2); one
K3 launch sums the ladder's group outputs and K4's partial points together,
so no point add runs between the two MSMs. When no table fits
BPP_FIXED_BASE_MAX_BYTES (PublicKey.fixed_tables gives None), the generator
lanes join the ladder's lanes, as in the JAX package (batch.py:187-192).

The challenges come from the fs256 branch of `_batch_verify_fused`
(batch.py:157-172) when every transcript is an unused Fs256Transcript (the
default): protocol/fs256.py::fs256_replay derives them on the card, with no
host decode or hash. Otherwise the host replays them (range.py::replay_batch).
`batch_verify_identify` (batch.py:389-433) names the proofs that fail by
bisecting a failed batch into sub-batches.

Over a device mesh (parallel/mesh.py) the same exponents and merge feed
sharded MSMs, as in the JAX package's mesh branches (:240-272, :314-333,
:353-386): with dp > 1 rows dividing K, one group MSM a row
(`_batch_verify_dp`), else the merged MSM split over a row's tp devices
(`_verify_tp`); the verdict is all-reduced over processes when the mesh
spans several.
"""
from __future__ import annotations

import secrets
from typing import List

import torch
from torch.profiler import record_function

from ..errors import VerificationError
from ..hashers_device import words_tensor
from ..msm import msm_partials, tree_sum
from ..msm.fixed import fixed_msm_partials
from ..parallel.sharded_msm import (
    all_processes,
    gather_sum,
    pad_pairs,
    replicated_all_identity,
    shard_partial,
    sharded_msm_rows,
)
from ..transcript import Fs256Transcript
from .fs256 import fs256_replay
from .range import (
    ProofBatch,
    replay_batch,
    stack_commitments,
    vinputs_multiple_batched,
    vinputs_single_batched,
)


def replay_challenges(curve, n: int, m: int, batch: ProofBatch, V_all, transcripts):
    """The K proofs' challenges as Montgomery tensors (y, z (K, 8), es
    (K, logn, 8), e_final (K, 8)): replayed on the card when every
    transcript is an unused fs256 one, each from its own start state (its
    label's), else on the host and encoded."""
    if all(getattr(t, "device_graph", False) and getattr(t, "_counter", None) == 0
           for t in transcripts):
        with record_function("bpp::fs256_replay"):
            state = words_tensor(Fs256Transcript.stacked_state_words(transcripts),
                                 batch.A.device)
            return fs256_replay(curve, m, V_all, batch.A, batch.L_vec, batch.R_vec,
                                batch.A_wip, batch.B, state)
    fn, dev = curve.fn, batch.A.device
    ys, zs, ess, efs = replay_batch(curve, n, m, transcripts, batch, V_all)
    return (fn.encode(ys, dev), fn.encode(zs, dev),
            fn.encode([e for es in ess for e in es], dev).reshape(len(ys), -1, fn.L),
            fn.encode(efs, dev))


def exponent_lanes(curve, n: int, m: int, batch: ProofBatch, V_all, challenges):
    """bpp::exponents: every proof's exponent vectors (Montgomery) and the
    points its unique scalars pair with: (uniq_s (K, u, 8), G_exp and H_exp
    (K, mn, 8), g_exp and h_exp (K, 8), the point tensors whose
    concatenation (K, u, C, L) pairs with uniq_s)."""
    fn = curve.fn
    with record_function("bpp::exponents"):
        args = (*challenges, batch.r_prime, batch.s_prime, batch.d_prime)
        if m == 1:
            uniq_s, G_exp, H_exp, g_exp, h_exp = vinputs_single_batched(fn, n, *args)
            head = [batch.B, batch.A_wip, batch.A]   # pairs [1, e, e²]
        else:
            uniq_s, G_exp, H_exp, g_exp, h_exp = vinputs_multiple_batched(fn, n, m, *args)
            head = [batch.A, batch.A_wip, batch.B]   # pairs [1, e⁻¹, e⁻²]
    return (uniq_s, G_exp, H_exp, g_exp, h_exp,
            [h[:, None] for h in head] + [batch.L_vec, batch.R_vec, V_all])


def merge_lanes(curve, pk, lanes, W, groups: int = 1):
    """The RLC merge (inside the caller's bpp::rlc_merge range): the K
    proofs' lanes (exponent_lanes) weighted by W (K, 8) and merged into
    `groups` groups of K/groups consecutive proofs. Returns plain scalars
    and their points: var_s (groups, V, 8) with var_p (groups, V, C, L),
    each group's proof-specific lanes then g and h; gen_s (groups, 2mn, 8),
    paired with G_vec[:mn] ‖ H_vec[:mn]."""
    fn = curve.fn
    uniq_s, G_exp, H_exp, g_exp, h_exp, uniq_pts = lanes

    def gsum(x, w):   # Σ over each group's proofs of w_k·x_k
        wx = fn.mul(x, w)
        return fn.sum(wx.reshape(groups, -1, *wx.shape[1:]), axis=1)

    Wg = W[:, None, :]
    gen_s = fn.from_mont(torch.cat([gsum(G_exp, Wg), gsum(H_exp, Wg)], dim=1))
    var_s = fn.from_mont(torch.cat([fn.mul(uniq_s, Wg).reshape(groups, -1, fn.L),
                                    gsum(g_exp, W)[:, None], gsum(h_exp, W)[:, None]], dim=1))
    gh = torch.stack([pk.g, pk.h])
    var_p = torch.cat([torch.cat(uniq_pts, dim=1).reshape(groups, -1, *pk.g.shape),
                       gh.expand(groups, *gh.shape)], dim=1)
    return var_s, var_p, gen_s


def verify_stacked(curve, pk, n: int, m: int, batch: ProofBatch, V_all,
                   challenges, W, mesh=None) -> bool:
    """Whether Σ_k w_k·(proof k's verification MSM) is the identity.

    batch: K proofs on pk's device; V_all (K, m, C, L); challenges the
    Montgomery (y, z, es, e_final) of replay_challenges; W (K, 8)
    Montgomery weights. With a mesh, the MSM runs split over the tp axis
    of this process's first row (the JAX package's tp path,
    batch.py:314-333): the generator lanes on each device's own table
    slice, the others on the ladder, or every lane on the ladder when no
    table fits or tp does not divide 2mn."""
    mn = n * m
    lanes = exponent_lanes(curve, n, m, batch, V_all, challenges)
    with record_function("bpp::rlc_merge"):
        var_s, var_p, gen_s = (x[0] for x in merge_lanes(curve, pk, lanes, W))
        if mesh is None:
            tables = pk.fixed_tables(mn)
        else:
            tp = mesh.axis_devices("tp")
            tables = pk.fixed_tables(mn, tp) if (2 * mn) % len(tp) == 0 else None
        if tables is None:   # no table fits the budget: the generators join the ladder
            var_s = torch.cat([var_s, gen_s])
            var_p = torch.cat([var_p, pk.G_vec[:mn], pk.H_vec[:mn]])
    if mesh is not None:
        return _verify_tp(curve, var_s, var_p, gen_s, tables, mesh)
    with record_function("bpp::variable_msm"):
        parts = msm_partials(curve, var_s, var_p)
    if tables is not None:
        with record_function("bpp::fixed_msm"):
            parts = torch.cat([parts, fixed_msm_partials(curve, gen_s, tables)])
    with record_function("bpp::msm_sum"):
        total = tree_sum(curve, parts)
    with record_function("bpp::identity_check"):
        return bool(curve.is_identity(total))


def _verify_tp(curve, var_s, var_p, gen_s, tables, mesh) -> bool:
    """The merged MSM split over the tp devices of this process's first
    mesh row: device j takes its slice of the ladder lanes and, with
    tables, its own slice of the generator lanes, and sums both with one
    K3; the partials meet on the row's first device."""
    devs = mesh.axis_devices("tp")
    P = len(devs)
    per = -(-var_p.shape[0] // P)
    var_s, var_p = pad_pairs(curve, var_s, var_p, per * P)
    gper = gen_s.shape[0] // P
    with record_function("bpp::sharded_msm"):
        parts = [shard_partial(curve, d, var_s[j * per:(j + 1) * per],
                               var_p[j * per:(j + 1) * per],
                               None if tables is None else gen_s[j * gper:(j + 1) * gper],
                               None if tables is None else tables[j])
                 for j, d in enumerate(devs)]
    return replicated_all_identity(curve, gather_sum(curve, parts, devs[0]), mesh)


def _batch_verify_dp(curve, pk, n: int, m: int, batch: ProofBatch, V_all, transcripts,
                     draw, mesh) -> bool:
    """dp group MSMs over a ("dp", "tp") mesh (batch.py:353-386): the K
    proofs merge into dp groups of K/dp consecutive proofs, group b's MSM
    (its proofs' lanes and all 2mn generator lanes, on the ladder as in the
    JAX package) runs on mesh row b split over the row's tp devices. This
    process replays, weighs and merges only the proofs of its own rows;
    every group's result must be the identity in every process."""
    K, dp = len(batch), mesh.dp
    g, here = K // dp, len(mesh.devices)
    lo, hi = mesh.row0 * g, (mesh.row0 + here) * g
    mine = batch if (lo, hi) == (0, K) else batch.take(slice(lo, hi))
    try:
        challenges = replay_challenges(curve, n, m, mine, V_all[lo:hi], transcripts[lo:hi])
    except VerificationError:   # a zero challenge here: reject, with every process
        return all_processes(False, mesh)
    W = curve.fn.encode([draw() for _ in range(hi - lo)], pk.device)
    lanes = exponent_lanes(curve, n, m, mine, V_all[lo:hi], challenges)
    with record_function("bpp::rlc_merge"):
        var_s, var_p, gen_s = merge_lanes(curve, pk, lanes, W, here)
        gens = torch.cat([pk.G_vec, pk.H_vec])
        scalars = torch.cat([var_s, gen_s], dim=1)
        points = torch.cat([var_p, gens.expand(here, *gens.shape)], dim=1)
    rows = sharded_msm_rows(curve, scalars, points, mesh.local())
    return replicated_all_identity(curve, rows, mesh)


def one_aggregation(n: int, proofs) -> None:
    """Raise the JAX package's TypeError on a list of proofs whose m differ
    (n·m = 2^rounds), before any card work; stack_commitments raises it on
    commitment lists of different lengths. JAX's batch_verify fails on such
    a batch in a field add whose shapes do not broadcast (batch.py:294),
    its batch_verify_identify in stack_commitments (batch.py:415,
    range.py:650-659); no reference verifies one."""
    if isinstance(proofs, ProofBatch):
        return
    ms = sorted({(1 << len(p.proof.L_vec)) // n for p in proofs})
    if len(ms) > 1:
        raise TypeError(f"a batch mixes aggregation sizes m = {ms}: batch verification "
                        "takes proofs of one m")


def batch_verify(curve, pk, n: int, proofs, commitment_lists,
                 transcripts=None, mesh=None, rng=None) -> None:
    """Verify K proofs over one pk in a single MSM; raises VerificationError.

    proofs: a ProofBatch or a sequence of RangeProof; commitment_lists: a
    (K, m, C, L) tensor or K equal-length lists of (C, L) points, all on
    pk's device; proofs of different m raise TypeError, as in the JAX
    package. transcripts: K fresh transcripts, by default
    Fs256Transcript(m) each, or of the kinds that proved the proofs
    (DeterministicTranscript, ShaTranscript, MerlinBppTranscript, or a mix).
    mesh: a parallel.Mesh to shard the MSM over (batch.py:240-272): with
    dp > 1 rows dividing K, dp group MSMs, one a row; otherwise the one
    merged MSM over the first row's tp devices. Over a mesh that spans
    processes, every process passes the same batch and only the verdicts
    cross. rng: callable returning the 128-bit RLC weights; the default
    draws them from `secrets`, and must stay unpredictable to the prover."""
    if len(proofs) != len(commitment_lists):
        raise VerificationError("proof/commitment count mismatch")
    K = len(proofs)
    if K == 0:
        return
    one_aggregation(n, proofs)
    draw = rng or (lambda: secrets.randbits(128))
    V_all = stack_commitments(curve, commitment_lists)
    batch = proofs if isinstance(proofs, ProofBatch) else ProofBatch.from_proofs(proofs)
    m = V_all.shape[1]
    if transcripts is None:
        transcripts = [Fs256Transcript(m) for _ in range(K)]
    if len(transcripts) != K:
        raise ValueError("need one transcript per proof")
    if n * m != 1 << batch.rounds or pk.length < n * m:
        raise VerificationError()
    pk = pk.prefix(n * m)
    if mesh is not None and mesh.dp > 1 and K % mesh.dp == 0:
        ok = _batch_verify_dp(curve, pk, n, m, batch, V_all, transcripts, draw, mesh)
    else:
        challenges = replay_challenges(curve, n, m, batch, V_all, transcripts)
        W = curve.fn.encode([draw() for _ in range(K)], pk.device)
        ok = verify_stacked(curve, pk, n, m, batch, V_all, challenges, W, mesh)
    if not ok:
        raise VerificationError("batch verification failed")


def batch_verify_identify(curve, pk, n: int, proofs, commitment_lists,
                          transcript_factory=None, mesh=None, rng=None) -> List[int]:
    """Verify K proofs in one batch and, if it fails, bisect: each half is
    verified as a batch of its own until the failing proofs are isolated.
    Returns the sorted indices of the proofs that fail ([] when the batch
    verifies); a failed batch costs O(bad · log K) sub-batch verifies.

    transcript_factory: index → a FRESH transcript for that proof, called
    for every dispatch (transcripts are stateful and each dispatch replays
    them); None gives fresh default transcripts (Fs256Transcript) each
    time. mesh, rng: as batch_verify's; proofs of different m raise
    TypeError, as in the JAX package."""
    one_aggregation(n, proofs)
    V_all = stack_commitments(curve, commitment_lists)
    batch = proofs if isinstance(proofs, ProofBatch) else ProofBatch.from_proofs(proofs)
    if len(batch) != V_all.shape[0]:
        raise VerificationError("proof/commitment count mismatch")

    def rec(lo: int, hi: int) -> List[int]:
        trs = (None if transcript_factory is None
               else [transcript_factory(i) for i in range(lo, hi)])
        try:
            batch_verify(curve, pk, n, batch.take(slice(lo, hi)), V_all[lo:hi],
                         transcripts=trs, mesh=mesh, rng=rng)
            return []
        except VerificationError:
            if hi - lo == 1:
                return [lo]
            mid = (lo + hi) // 2
            return rec(lo, mid) + rec(mid, hi)

    return rec(0, len(batch))
