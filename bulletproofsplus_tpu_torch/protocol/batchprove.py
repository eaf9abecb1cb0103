"""Batch proving: K range proofs over one pk as one pass of batched programs.

Port of the known-ahead branch of bulletproofsplus_tpu/protocol/
batchprove.py::batch_prove (:124-327, the branch at :275-327). A
homogeneous batch (same n, same m) gains a leading K axis on every tensor:
the bit commitment (K5 + K3), the setup programs, then the whole fold of
protocol/wip.py, so every kernel launch serves all K proofs at once.

Challenges come from transcripts whose challenges are known ahead
(DeterministicTranscript); blinds are drawn ahead from any rng in the
reference's order (every α first, then per proof its (d_L, d_R) per round
and its four final blinds), the sequence the interactive path draws, so the
bytes do not depend on it. The JAX package's K-chunking (:179-212) bounds
TPU compile time and memory and its CPU gate (:171-177) is XLA machinery;
neither is carried over: the port proves the whole batch in one pass.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from ..transcript import SystemRng
from .range import (
    ProofBatch,
    bit_commitment_batched,
    bit_decompose,
    prove,
    prove_setup_multiple_batched,
    prove_setup_single_batched,
    validate,
)
from .wip import wip_prove_known_batched


def batch_prove(curve, pk, n: int, provers: Sequence,
                transcripts: Optional[Sequence] = None,
                rngs: Optional[Sequence] = None):
    """Prove K range statements (RangeProvers over the shared pk) on the
    key's device. Returns a ProofBatch, whose index k is the RangeProof
    that `prove` gives for prover k with the same transcript and rng; a
    batch mixing aggregation sizes proves each statement alone and returns
    a list of RangeProof.

    transcripts: K DeterministicTranscript(m), the only mode ported so far
    (there is no default). rngs: K blinding sources, by default SystemRng."""
    K = len(provers)
    if K == 0:
        return []
    m = len(provers[0].v_vec)
    if any(len(p.v_vec) != m for p in provers):
        return [prove(curve, pk, n, p,
                      transcripts[i] if transcripts else None,
                      rngs[i] if rngs else None)
                for i, p in enumerate(provers)]
    validate(pk, n, m)
    if transcripts is None:
        raise NotImplementedError(
            "no default transcript: pass K DeterministicTranscript(m) (the "
            "sound fs256 mode is not ported yet)")
    if len(transcripts) != K or (rngs is not None and len(rngs) != K):
        raise ValueError("need one transcript (and one rng) per prover")
    if not all(getattr(t, "challenges_known_ahead", False) for t in transcripts):
        raise NotImplementedError(
            "only transcripts whose challenges are known ahead are ported; the "
            "fs256 and ShaTranscript provers come with a later slice")
    fn = curve.fn
    rngs = list(rngs) if rngs else [SystemRng(fn.p) for _ in range(K)]
    pk = pk.prefix(n * m)
    dev = pk.device
    logn = (n * m).bit_length() - 1

    alphas = [r.alpha() for r in rngs]
    ys, zs, es, dLs, dRs, finals, efs = [], [], [], [], [], [], []
    for t, r in zip(transcripts, rngs):
        y, z = t.challenge_yz(curve, None, None)
        ys.append(y)
        zs.append(z)
        for _ in range(logn):
            d_L, d_R = r.round_blinds()
            dLs.append(d_L)
            dRs.append(d_R)
            es.append(t.round_challenge(curve, None, None))
        finals.append(r.final_blinds())
        efs.append(t.final_challenge(curve, None, None))

    def rows(vals):
        return fn.encode(vals, dev).reshape(K, -1, fn.L)

    with record_function("bpp::bit_commitment"):
        bits = torch.from_numpy(
            np.stack([bit_decompose(p.v_vec, n, m) for p in provers])).to(dev)
        A = bit_commitment_batched(curve, fn.encode_plain(alphas, dev), bits,
                                   pk.G_vec, pk.H_vec, pk.h)
    with record_function("bpp::prove_setup"):
        y_m, z_m, alpha_m = fn.encode(ys, dev), fn.encode(zs, dev), fn.encode(alphas, dev)
        if m == 1:
            gamma = fn.encode([p.gamma_vec[0] for p in provers], dev)
            setup = prove_setup_single_batched(fn, n, y_m, z_m, bits, gamma, alpha_m)
        else:
            gamma = rows([g for p in provers for g in p.gamma_vec])
            setup = prove_setup_multiple_batched(fn, n, m, y_m, z_m, bits, gamma,
                                                 alpha_m)
        a_vec, b_vec, power_of_y, alpha_hat = setup
        blinds = rows([x for f in finals for x in f])          # (K, 4, 8)
        known = (rows(es), rows(dLs), rows(dRs), blinds[:, 0], blinds[:, 1],
                 blinds[:, 2], blinds[:, 3], fn.encode(efs, dev))
    L_vec, R_vec, A_wip, B, r_p, s_p, d_p = wip_prove_known_batched(
        curve, a_vec, b_vec, power_of_y, alpha_hat, pk.G_vec, pk.H_vec, pk.g,
        pk.h, *known)
    return ProofBatch(A=A, L_vec=L_vec, R_vec=R_vec, A_wip=A_wip, B=B,
                      r_prime=r_p, s_prime=s_p, d_prime=d_p)
