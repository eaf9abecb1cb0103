"""Batch verify above the fixed-base table budget, on the CPU.

When no window table over the 2mn generators fits BPP_FIXED_BASE_MAX_BYTES,
the JAX package runs the generator lanes on the joint ladder
(bulletproofsplus_tpu/protocol/batch.py:187-192). The port must do the same:
build no table, never call the fixed-base MSM, and give the same
accept/reject. Under the default 7 GiB budget it keeps the unsigned table.

A small edwards25519 statement (n = 8, m = 2, K = 2, deterministic mode) is
proven with the port itself; this file imports no jax."""
import pytest
import torch

import bulletproofsplus_tpu_torch as bt
from bulletproofsplus_tpu_torch.protocol import batch as batch_mod

# Tiny tensors: intra-op threads buy nothing and oversubscribe xdist workers.
torch.set_num_threads(1)

N, M, K = 8, 2, 2


@pytest.fixture(scope="module")
def proven():
    c = bt.curve_ops("edwards25519")
    pk = bt.PublicKey.new(c, N * M, "cpu")
    provers = []
    for k in range(K):
        p = bt.RangeProver()
        for i in range(M):
            p.commit(pk, (37 * k + 11 * i + 5) % (1 << N), 1000 + 7 * k + i)
        provers.append(p)
    proofs = bt.batch_prove(c, pk, N, provers, [bt.DeterministicTranscript(M)] * K,
                            [bt.DeterministicRng(M)] * K)
    V = torch.stack([torch.stack(p.commitment_vec) for p in provers])
    return c, proofs, V


def verify(c, proofs, V):
    """Batch-verify on a fresh key, so that no table is cached; returns the key."""
    pk = bt.PublicKey.new(c, N * M, "cpu")
    bt.batch_verify(c, pk, N, proofs, V, [bt.DeterministicTranscript(M)] * K)
    return pk


def tampered(proofs, c):
    bad = proofs.take(slice(None))
    bad.r_prime = bad.r_prime.clone()
    bad.r_prime[1] = c.fn.add(bad.r_prime[1], c.fn.one("cpu"))
    return bad


def test_over_budget_runs_generators_on_the_ladder(proven, monkeypatch):
    c, proofs, V = proven
    monkeypatch.setenv("BPP_FIXED_BASE_MAX_BYTES", "1")

    def no_fixed_msm(*args, **kwargs):
        raise AssertionError("fixed_msm_partials called above the table budget")

    monkeypatch.setattr(batch_mod, "fixed_msm_partials", no_fixed_msm)
    pk = verify(c, proofs, V)
    assert pk._fb_tables == {}
    assert pk.fixed_tables(N * M) is None
    with pytest.raises(bt.VerificationError):
        verify(c, tampered(proofs, c), V)


def test_default_budget_takes_the_unsigned_table(proven, monkeypatch):
    c, proofs, V = proven
    monkeypatch.delenv("BPP_FIXED_BASE_MAX_BYTES", raising=False)
    pk = verify(c, proofs, V)
    assert list(pk._fb_tables) == [N * M]
    assert pk._fb_tables[N * M].shape[0] == 16          # unsigned: 16 entries a window
    with pytest.raises(bt.VerificationError):
        verify(c, tampered(proofs, c), V)
