"""Batch proving: K range proofs over one pk as one pass of batched programs.

Port of bulletproofsplus_tpu/protocol/batchprove.py::batch_prove (:124-375):
the known-ahead branch (:275-327) and the fs256 branch (:329-375). A
homogeneous batch (same n, same m) gains a leading K axis on every tensor:
the bit commitment (K5 + K3), the setup programs, then the whole fold of
protocol/wip.py, so every kernel launch serves all K proofs at once.

Challenges come from DeterministicTranscript (known ahead) or from
Fs256Transcript, the default, whose chain runs on the card: y and z from A
and the commitments (the JAX package draws these two on the host,
:225-241, which here would be a Python decode of K·m points; the bytes are
the same), then every round's and the final challenge inside the fold
(protocol/fs256.py), each step one launch of the fs256 chain kernel.
Blinds are drawn ahead from any rng in the reference's order (every α
first, then per proof its (d_L, d_R) per round and its four final blinds),
the sequence the interactive path draws, so the bytes do not depend on it. Other transcripts (ShaTranscript, Merlin) take
the JAX package's interactive path, not ported yet. The JAX package's
K-chunking (:179-212) bounds TPU compile time and memory and its CPU gate
(:171-177) is XLA machinery; neither is carried over: the port proves the
whole batch in one pass.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from ..hashers_device import words_tensor
from ..transcript import Fs256Transcript, SystemRng
from .fs256 import absorb_and_draw, statement_step, wip_prove_fs256_batched
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

    transcripts: K transcripts, by default Fs256Transcript(m) each; all
    DeterministicTranscript (challenges known ahead) or all Fs256Transcript.
    Each fs256 transcript ends in the state and counter of the host twin
    that proved its statement. rngs: K blinding sources, by default
    SystemRng."""
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
    transcripts = (list(transcripts) if transcripts is not None
                   else [Fs256Transcript(m) for _ in range(K)])
    if len(transcripts) != K or (rngs is not None and len(rngs) != K):
        raise ValueError("need one transcript (and one rng) per prover")
    known = all(getattr(t, "challenges_known_ahead", False) for t in transcripts)
    if not known and not all(getattr(t, "device_graph", False) for t in transcripts):
        raise NotImplementedError(
            "only DeterministicTranscript and Fs256Transcript are ported; "
            "ShaTranscript and Merlin need the interactive prover")
    fn = curve.fn
    rngs = list(rngs) if rngs else [SystemRng(fn.p) for _ in range(K)]
    pk = pk.prefix(n * m)
    dev = pk.device
    logn = (n * m).bit_length() - 1

    alphas = [r.alpha() for r in rngs]
    dLs, dRs, finals = [], [], []
    for r in rngs:
        for _ in range(logn):
            d_L, d_R = r.round_blinds()
            dLs.append(d_L)
            dRs.append(d_R)
        finals.append(r.final_blinds())

    def rows(vals):
        return fn.encode(vals, dev).reshape(K, -1, fn.L)

    with record_function("bpp::bit_commitment"):
        bits = torch.from_numpy(
            np.stack([bit_decompose(p.v_vec, n, m) for p in provers])).to(dev)
        A = bit_commitment_batched(curve, fn.encode_plain(alphas, dev), bits,
                                   pk.G_vec, pk.H_vec, pk.h)
    if known:
        yz = [t.challenge_yz(curve, None, None) for t in transcripts]
        y_m, z_m = fn.encode([y for y, _ in yz], dev), fn.encode([z for _, z in yz], dev)
    else:
        with record_function("bpp::fs256_statement"):
            counts = [t._counter for t in transcripts]
            base = (None if not any(counts) else
                    torch.tensor(counts, dtype=torch.int32, device=dev))
            state = words_tensor(Fs256Transcript.stacked_state_words(transcripts), dev)
            # one stack of all K·m commitments (a copy launch per 128, not
            # per proof)
            V_all = torch.stack([v for p in provers for v in p.commitment_vec]).reshape(
                K, m, *A.shape[1:])
            yz, state = absorb_and_draw(curve, state, base, statement_step(m),
                                        torch.cat([V_all, A[:, None]], dim=1))
            y_m, z_m = yz[:, 0], yz[:, 1]
    with record_function("bpp::prove_setup"):
        alpha_m = fn.encode(alphas, dev)
        if m == 1:
            gamma = fn.encode([p.gamma_vec[0] for p in provers], dev)
            setup = prove_setup_single_batched(fn, n, y_m, z_m, bits, gamma, alpha_m)
        else:
            gamma = rows([g for p in provers for g in p.gamma_vec])
            setup = prove_setup_multiple_batched(fn, n, m, y_m, z_m, bits, gamma,
                                                 alpha_m)
        a_vec, b_vec, power_of_y, alpha_hat = setup
        blinds = rows([x for f in finals for x in f])          # (K, 4, 8)
        fold_in = (a_vec, b_vec, power_of_y, alpha_hat, pk.G_vec, pk.H_vec, pk.g, pk.h)
        fold_blinds = (rows(dLs), rows(dRs), blinds[:, 0], blinds[:, 1], blinds[:, 2],
                       blinds[:, 3])
    if known:
        es, efs = [], []
        for t in transcripts:
            es += [t.round_challenge(curve, None, None) for _ in range(logn)]
            efs.append(t.final_challenge(curve, None, None))
        L_vec, R_vec, A_wip, B, r_p, s_p, d_p = wip_prove_known_batched(
            curve, *fold_in, rows(es), *fold_blinds, fn.encode(efs, dev))
    else:
        L_vec, R_vec, A_wip, B, r_p, s_p, d_p, state = wip_prove_fs256_batched(
            curve, *fold_in, state, *fold_blinds, base=base)
        words = state.cpu().numpy()
        for t, w in zip(transcripts, words):
            t.set_state_words(w, logn + 3)
    return ProofBatch(A=A, L_vec=L_vec, R_vec=R_vec, A_wip=A_wip, B=B,
                      r_prime=r_p, s_prime=s_p, d_prime=d_p)
