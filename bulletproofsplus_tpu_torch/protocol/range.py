"""Range-proof containers, the prover's setup and the verifier's exponents.

Port of bulletproofsplus_tpu/protocol/range.py. Verify side: `RangeProof`,
`ProofBatch`, `_replay_challenges` (:380-394, batched as `replay_batch`
:662-715: the host replay, for every transcript but an unused fs256 one,
which the card replays), the exponent programs
`_vinputs_multiple_batched` (:1017-1114) and `_vinputs_single_prog`
(:1117-1192, here with the same leading K axis), and `verify` (:209-235,
:502-542). Prove side: `RangeProver` (:133-146),
`_bit_decompose` (:149-153), the bit commitment `_bit_commitment_batch_prog`
(:254-282), the setup programs `_prove_setup_multiple_prog` (:857-894) and
`_prove_setup_single_prog` (:310-341) with the leading K axis the JAX
package adds by vmap (batchprove.py:59-72), and `prove` (:178-206). Every
input and output of these programs carries a leading K axis and every
field product runs on whole (K, ·) tensors, so K1 sees one launch per
operation.

Single `verify` and `prove` are the K = 1 cases of batch verification
(protocol/batch.py::verify_stacked) and batch proving
(protocol/batchprove.py::batch_prove).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from ..curves.cuda_curve import ladder_scalar_mul, sum_points_grouped
from ..errors import (
    InvalidAggregation,
    InvalidBitsize,
    InvalidGeneratorsLength,
    ProofError,
    VerificationError,
)
from ..transcript import Fs256Transcript
from .wip import WipProof


@dataclasses.dataclass
class RangeProof:
    """A (the bit commitment) + the WIP argument (range/mod.rs:25-28)."""

    A: torch.Tensor   # (C, L), C = curve.COORDS, L = curve.fp.L
    proof: WipProof


@dataclasses.dataclass
class ProofBatch:
    """K homogeneous range proofs (same n, m) as stacked tensors."""

    A: torch.Tensor        # (K, C, L)
    L_vec: torch.Tensor    # (K, rounds, C, L)
    R_vec: torch.Tensor    # (K, rounds, C, L)
    A_wip: torch.Tensor    # (K, C, L)
    B: torch.Tensor        # (K, C, L)
    r_prime: torch.Tensor  # (K, 8) Montgomery
    s_prime: torch.Tensor  # (K, 8)
    d_prime: torch.Tensor  # (K, 8)

    @property
    def rounds(self) -> int:
        return self.L_vec.shape[1]

    def __len__(self) -> int:
        return self.A.shape[0]

    def take(self, index) -> "ProofBatch":
        """The sub-batch at `index` (a slice or an index tensor/list)."""
        if not isinstance(index, slice):
            index = torch.as_tensor(index, dtype=torch.long, device=self.A.device)
        return ProofBatch(**{f.name: getattr(self, f.name)[index]
                             for f in dataclasses.fields(self)})

    def __getitem__(self, i: int) -> RangeProof:
        return RangeProof(A=self.A[i], proof=WipProof(
            L_vec=self.L_vec[i], R_vec=self.R_vec[i], A=self.A_wip[i],
            B=self.B[i], r_prime=self.r_prime[i], s_prime=self.s_prime[i],
            d_prime=self.d_prime[i]))

    @classmethod
    def from_proofs(cls, proofs: Sequence[RangeProof]) -> "ProofBatch":
        return cls(
            A=torch.stack([p.A for p in proofs]),
            L_vec=torch.stack([p.proof.L_vec for p in proofs]),
            R_vec=torch.stack([p.proof.R_vec for p in proofs]),
            A_wip=torch.stack([p.proof.A for p in proofs]),
            B=torch.stack([p.proof.B for p in proofs]),
            r_prime=torch.stack([p.proof.r_prime for p in proofs]),
            s_prime=torch.stack([p.proof.s_prime for p in proofs]),
            d_prime=torch.stack([p.proof.d_prime for p in proofs]),
        )


@dataclasses.dataclass
class RangeProver:
    """Witness container (range/prover.rs:13-42): values, blinds and their
    commitments, (C, L) points on the key's device."""

    v_vec: List[int] = dataclasses.field(default_factory=list)
    gamma_vec: List[int] = dataclasses.field(default_factory=list)
    commitment_vec: List[torch.Tensor] = dataclasses.field(default_factory=list)

    def commit(self, pk, v: int, gamma: int) -> torch.Tensor:
        V = pk.commitment(v, gamma)
        self.v_vec.append(v)
        self.gamma_vec.append(gamma)
        self.commitment_vec.append(V)
        return V


def bit_decompose(v: Sequence[int], n: int, m: int) -> np.ndarray:
    """v_bits[i] = bit (i % n) of v[i // n] (range/mod.rs:263-277), (n·m,)."""
    mask = (1 << n) - 1
    vals = np.array([int(x) & mask for x in v], dtype=np.uint64)
    bits = (vals[:, None] >> np.arange(n, dtype=np.uint64)) & np.uint64(1)
    return bits.reshape(n * m).astype(bool)


def validate(pk, n: int, m: int) -> None:
    """The reference's argument checks (errors.rs:27, :31-35, :37-41)."""
    if n not in (8, 16, 32, 64):
        raise InvalidBitsize()
    if m < 1 or (m & (m - 1)) != 0:
        raise InvalidAggregation(m)
    if pk.length < n * m:
        raise InvalidGeneratorsLength()


def stack_commitments(curve, commitment_lists) -> torch.Tensor:
    """(K, m, C, L) commitments from a tensor (passed through) or K lists of
    (C, L) points (range.py:650-659); lists of different lengths raise
    TypeError, as the JAX package's reshape does. `curve` is taken for the
    JAX package's signature; the points carry their own shape."""
    if isinstance(commitment_lists, torch.Tensor):
        return commitment_lists
    lengths = sorted({len(V) for V in commitment_lists})
    if len(lengths) > 1:
        raise TypeError(f"commitment lists of lengths m = {lengths} do not stack into one "
                        "(K, m) batch")
    return torch.stack([torch.stack(list(V)) for V in commitment_lists])


def replay_batch(curve, n: int, m: int, transcripts, batch: "ProofBatch" = None,
                 V_all=None):
    """Host Fiat-Shamir replay of K proofs: (ys, zs, ess, efs) int lists;
    VerificationError on a zero challenge (range.py:392). When every
    transcript's challenges are known ahead no point is looked at;
    otherwise the transcripts (Fs256Transcript host twins, ShaTranscript,
    MerlinBppTranscript, or a mix) absorb the proofs' points (batch, V_all
    (K, m, C, L)), each stacked tensor fetched and decoded to affine once,
    as the JAX package's replay_batch does (range.py:662-715)."""
    fn = curve.fn
    K = len(transcripts)
    logn = (n * m).bit_length() - 1
    if all(getattr(tr, "challenges_known_ahead", False) for tr in transcripts):
        V = [[None] * m] * K
        A = Aw = B = [None] * K
        Ls = Rs = [[None] * logn] * K
    else:
        A, Aw, B = (curve.decode_points(t) for t in (batch.A, batch.A_wip, batch.B))
        L_flat = curve.decode_points(batch.L_vec)
        R_flat = curve.decode_points(batch.R_vec)
        V_flat = curve.decode_points(V_all)
        Ls = [L_flat[k * logn:(k + 1) * logn] for k in range(K)]
        Rs = [R_flat[k * logn:(k + 1) * logn] for k in range(K)]
        V = [V_flat[k * m:(k + 1) * m] for k in range(K)]
    ys, zs, ess, efs = [], [], [], []
    for k, tr in enumerate(transcripts):
        y, z = tr.challenge_yz(curve, V[k], A[k])
        es = [tr.round_challenge(curve, Ls[k][j], Rs[k][j]) % fn.p for j in range(logn)]
        e = tr.final_challenge(curve, Aw[k], B[k]) % fn.p
        if any(c == 0 for c in es) or e == 0 or y % fn.p == 0 or z % fn.p == 0:
            raise VerificationError()
        ys.append(y)
        zs.append(z)
        ess.append(es)
        efs.append(e)
    return ys, zs, ess, efs


def _s_vec(fn, allinv, challenges_sqr, width: int):
    """s_i = Π e_j⁻¹ · Π_{bits b of i} e²_{logn-1-b} (wip:372-380) as logn
    masked multiplies over (K, width)."""
    logn = challenges_sqr.shape[1]
    K = allinv.shape[0]
    idx = torch.arange(width, device=allinv.device)
    s_vec = allinv[:, None].expand(K, width, fn.L)
    for j in range(logn):
        s_vec = fn.select(((idx >> j) & 1).bool(),
                          fn.mul(s_vec, challenges_sqr[:, None, logn - 1 - j]), s_vec)
    return s_vec


def _prod(fn, xs):
    """Π over axis 1 of (K, k, 8)."""
    acc = xs[:, 0]
    for j in range(1, xs.shape[1]):
        acc = fn.mul(acc, xs[:, j])
    return acc


def vinputs_multiple_batched(fn, n: int, m: int, y_m, z_m, challenges, e,
                             r_prime, s_prime, d_prime):
    """Aggregated (m > 1) exponent vectors of K proofs, the e⁻² form.
    Inputs (K, 8) Montgomery, challenges (K, logn, 8). Returns
    (unique scalars (K, 3+2·logn+m, 8) paired with [A, A_wip, B, L, R, V],
    G_exp (K, mn, 8), H_exp (K, mn, 8), g_exp (K, 8), h_exp (K, 8))."""
    K = y_m.shape[0]
    dev = y_m.device
    mn = n * m
    logn = mn.bit_length() - 1
    idx = torch.arange(mn, device=dev)
    sum_2 = fn.encode((pow(2, n, fn.p) - 1) % fn.p, dev)
    two_pows = fn.encode([pow(2, i, fn.p) for i in range(n)], dev)

    minus_z = fn.neg(z_m)
    z_sqr = fn.mul(z_m, z_m)
    power_of_y_all = fn.powers_type2(y_m, mn + 1)          # (K, mn+1, 8)
    y_mn1 = power_of_y_all[:, mn]
    power_of_y = power_of_y_all[:, :mn]
    power_of_y_rev = power_of_y.flip(1)
    power_of_z = fn.powers_type2(z_sqr, m)                 # (K, m, 8)
    concat_z_and_2 = fn.mul(two_pows[idx % n].expand(K, mn, fn.L),
                            power_of_z[:, idx // n])

    # one Fermat chain inverts the round challenges, e and y together
    _, invs = fn.batch_invert(
        torch.cat([challenges, e[:, None], y_m[:, None]], dim=1), axis=1)
    challenges_inv = invs[:, :logn]
    e_inv = invs[:, logn]
    y_inv = invs[:, logn + 1]
    allinv = _prod(fn, challenges_inv)
    challenges_sqr = fn.mul(challenges, challenges)
    challenges_inv_sqr = fn.mul(challenges_inv, challenges_inv)
    s_vec = _s_vec(fn, allinv, challenges_sqr, mn)
    s_prime_vec = s_vec.flip(1)

    e_sqr_inv = fn.mul(e_inv, e_inv)
    r_prime_e_inv_y = fn.mul(fn.mul(r_prime, e_inv), y_m)
    s_prime_e_inv = fn.mul(s_prime, e_inv)

    pow_y_inv = fn.powers_type2(y_inv, mn)
    G_exp = fn.sub(minus_z[:, None].expand(K, mn, fn.L),
                   fn.mul(fn.mul(s_vec, pow_y_inv), r_prime_e_inv_y[:, None]))
    H_exp = fn.add(fn.neg(fn.mul(s_prime_e_inv[:, None], s_prime_vec)),
                   fn.add(fn.mul(concat_z_and_2, power_of_y_rev), z_m[:, None]))

    sum_y = fn.sum(power_of_y, axis=1)
    sum_z = fn.sum(power_of_z, axis=1)
    g_exp = fn.add(
        fn.neg(fn.mul(fn.mul(fn.mul(r_prime, s_prime), y_m), e_sqr_inv)),
        fn.sub(fn.mul(sum_y, fn.sub(z_m, z_sqr)),
               fn.mul(fn.mul(fn.mul(y_mn1, z_m), sum_2), sum_z)))
    h_exp = fn.neg(fn.mul(d_prime, e_sqr_inv))
    V_exp = fn.mul(power_of_z, y_mn1[:, None])

    unique = torch.cat([fn.one(dev).expand(K, 1, fn.L), e_inv[:, None],
                        e_sqr_inv[:, None], challenges_sqr, challenges_inv_sqr,
                        V_exp], dim=1)
    return unique, G_exp, H_exp, g_exp, h_exp


def vinputs_single_batched(fn, n: int, y_m, z_m, challenges, e, r_prime,
                           s_prime, d_prime):
    """Single-proof (m = 1) exponent vectors of K proofs, the e²-multiplied
    form (range/mod.rs:189-238, wip:238-328). Same signature and outputs as
    vinputs_multiple_batched; unique scalars pair with [B, A_wip, A, L, R, V]."""
    K = y_m.shape[0]
    dev = y_m.device
    logn = n.bit_length() - 1
    two_pows = fn.encode([pow(2, i, fn.p) for i in range(n)], dev)
    sum2 = fn.encode((pow(2, n, fn.p) - 1) % fn.p, dev)

    power_of_y_all = fn.powers_type2(y_m, n + 1)
    power_of_y = power_of_y_all[:, :n]
    power_of_y_rev = power_of_y.flip(1)
    V_exp_comm = power_of_y_all[:, n]                       # y^{n+1}
    z_sqr = fn.mul(z_m, z_m)
    G_exp_comm = fn.neg(z_m)[:, None].expand(K, n, fn.L)
    H_exp_comm = fn.add(fn.mul(two_pows, power_of_y_rev), z_m[:, None])
    g_exp_comm = fn.sub(fn.mul(fn.sum(power_of_y, axis=1), fn.sub(z_m, z_sqr)),
                        fn.mul(fn.mul(sum2, V_exp_comm), z_m))

    _, invs = fn.batch_invert(torch.cat([challenges, y_m[:, None]], dim=1), axis=1)
    challenges_inv = invs[:, :logn]
    y_inv = invs[:, logn]
    allinv = _prod(fn, challenges_inv)
    challenges_sqr = fn.mul(challenges, challenges)
    challenges_inv_sqr = fn.mul(challenges_inv, challenges_inv)
    s_vec = _s_vec(fn, allinv, challenges_sqr, n)
    s_prime_vec = s_vec.flip(1)

    e_sqr = fn.mul(e, e)
    r_prime_e_y = fn.mul(fn.mul(r_prime, e), y_m)
    s_prime_e = fn.mul(s_prime, e)
    Ls_exp = fn.mul(challenges_sqr, e_sqr[:, None])
    Rs_exp = fn.mul(challenges_inv_sqr, e_sqr[:, None])

    pow_y_inv = fn.powers_type2(y_inv, n)
    G_exp = fn.sub(fn.mul(G_exp_comm, e_sqr[:, None]),
                   fn.mul(fn.mul(s_vec, pow_y_inv), r_prime_e_y[:, None]))
    H_exp = fn.sub(fn.mul(H_exp_comm, e_sqr[:, None]),
                   fn.mul(s_prime_vec, s_prime_e[:, None]))
    g_exp = fn.add(fn.neg(fn.mul(fn.mul(r_prime, y_m), s_prime)),
                   fn.mul(g_exp_comm, e_sqr))
    h_exp = fn.neg(d_prime)
    V_exp = fn.mul(V_exp_comm, e_sqr)

    unique = torch.cat([fn.one(dev).expand(K, 1, fn.L), e[:, None], e_sqr[:, None],
                        Ls_exp, Rs_exp, V_exp[:, None]], dim=1)
    return unique, G_exp, H_exp, g_exp, h_exp


def bit_commitment_batched(curve, alpha_plain, bits, G_vec, H_vec, h):
    """K bit commitments A_k = h·α_k + Σ_i (bits[k, i] ? G_i : −H_i)
    (range/mod.rs:96-106, :259-277). alpha_plain (K, 8) plain form, bits
    (K, mn) bool → (K, C, L): h·α_k by K5 over K lanes, then one K3 launch
    over the (K, mn + 1) points."""
    K = bits.shape[0]
    h_alpha = ladder_scalar_mul(curve, alpha_plain, h.expand(K, *h.shape),
                                curve.fn.order_bits)
    chosen = curve.select(bits, G_vec, curve.neg(H_vec))     # (K, mn, C, L)
    return sum_points_grouped(curve, torch.cat([h_alpha[:, None], chosen], dim=1))


def _a_b_vectors(fn, bits, z_m, H_exp):
    """a = bits ? 1 − z : −z and b = bits ? H_exp : H_exp − 1, (K, width, 8)."""
    one = fn.one(z_m.device)
    shape = H_exp.shape
    a_vec = fn.select(bits, fn.sub(one, z_m)[:, None].expand(shape),
                      fn.neg(z_m)[:, None].expand(shape))
    b_vec = fn.select(bits, H_exp, fn.sub(H_exp, one))
    return a_vec, b_vec


def prove_setup_multiple_batched(fn, n: int, m: int, y_m, z_m, bits, gamma_m,
                                 alpha_m):
    """Everything between (y, z) and the WIP fold of K aggregated proofs
    (range/mod.rs:283-376). y, z, α (K, 8) Montgomery, bits (K, mn) bool,
    γ (K, m, 8) → (a_vec, b_vec, power_of_y (K, mn, 8), α̂ (K, 8)). The
    reference's Â is dead prover work and is not computed (range.py:314)."""
    K = y_m.shape[0]
    dev = y_m.device
    mn = n * m
    idx = torch.arange(mn, device=dev)
    two_pows = fn.encode([pow(2, i, fn.p) for i in range(n)], dev)
    power_of_y = fn.powers_type2(y_m, mn)                    # (K, mn, 8)
    power_of_z = fn.powers_type2(fn.mul(z_m, z_m), m)        # z², z⁴, ...
    # d[j·n + i] = 2^i · z^{2(j+1)}   (range/mod.rs:288-291)
    d = fn.mul(two_pows[idx % n].expand(K, mn, fn.L), power_of_z[:, idx // n])
    H_exp = fn.add(fn.mul(d, power_of_y.flip(1)), z_m[:, None])
    y_mn1 = fn.mul(power_of_y[:, mn - 1], y_m)                # y^{mn+1}
    a_vec, b_vec = _a_b_vectors(fn, bits, z_m, H_exp)
    pz_gamma_sum = fn.sum(fn.mul(power_of_z, gamma_m), axis=1)
    alpha_hat = fn.add(alpha_m, fn.mul(pz_gamma_sum, y_mn1))
    return a_vec, b_vec, power_of_y, alpha_hat


def prove_setup_single_batched(fn, n: int, y_m, z_m, bits, gamma_m, alpha_m):
    """The m = 1 setup of K proofs (range/mod.rs:112-184); γ (K, 8), other
    arguments and outputs as prove_setup_multiple_batched."""
    two_pows = fn.encode([pow(2, i, fn.p) for i in range(n)], y_m.device)
    power_of_y = fn.powers_type2(y_m, n)                     # (K, n, 8)
    H_exp = fn.add(fn.mul(two_pows, power_of_y.flip(1)), z_m[:, None])
    V_exp = fn.mul(power_of_y[:, n - 1], y_m)                 # y^{n+1}
    a_vec, b_vec = _a_b_vectors(fn, bits, z_m, H_exp)
    alpha_hat = fn.add(alpha_m, fn.mul(gamma_m, V_exp))
    return a_vec, b_vec, power_of_y, alpha_hat


def prove(curve, pk, n: int, prover: RangeProver, transcript=None,
          rng=None) -> RangeProof:
    """One range proof (range/mod.rs:31-55), the K = 1 case of batch_prove.
    transcript: by default Fs256Transcript(m), or any transcript batch_prove
    takes; rng: blinding source, by default SystemRng."""
    from .batchprove import batch_prove

    return batch_prove(curve, pk, n, [prover],
                       None if transcript is None else [transcript],
                       None if rng is None else [rng])[0]


def verify(curve, proof: RangeProof, pk, n: int, commitment_vec,
           transcript=None) -> None:
    """Raises VerificationError unless the proof verifies (range/mod.rs:57-78).
    transcript: by default Fs256Transcript(m), or a fresh transcript of the
    kind that proved it (DeterministicTranscript, ShaTranscript,
    MerlinBppTranscript)."""
    from .batch import replay_challenges, verify_stacked

    V = (commitment_vec if isinstance(commitment_vec, torch.Tensor)
         else torch.stack(list(commitment_vec)))
    m = V.shape[0]
    try:
        validate(pk, n, m)
    except ProofError as exc:
        raise VerificationError(str(exc) or "invalid arguments")
    transcript = transcript if transcript is not None else Fs256Transcript(m)
    batch = ProofBatch.from_proofs([proof])
    if n * m != 1 << batch.rounds:
        raise VerificationError()
    challenges = replay_challenges(curve, n, m, batch, V[None], [transcript])
    W = curve.fn.one(V.device)[None]
    if not verify_stacked(curve, pk.prefix(n * m), n, m, batch, V[None],
                          challenges, W):
        raise VerificationError()
