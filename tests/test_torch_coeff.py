"""The port's coefficient-form prover (protocol/wip_coeff.py) against golden
and the port's fold prover, on edwards25519 at n = 8, m = 2, the shape of
tests/test_protocol_tpu.py::test_coeff_prover_bit_exact.

BPP_PROVER=coeff proofs must equal golden's bytes and the fold prover's, on
the joint-ladder backend and on the bucket MSM (BPP_PIPPENGER=1,
BPP_PIPPENGER_MIN=0, which also sends the A row to the buckets), for one
statement (`prove`) and for a batch of two whose rows share the key's
generators (stride 0 over K). The JAX package's `wip_prove_coeff_prog`,
called eagerly at n·m = 16, takes close to three minutes on a CPU (its
joint-ladder MSM compiles), so golden stands in for it: the JAX package's
own test holds that program's bytes to golden's. The routing follows the
JAX package's: only the whole-fold branch (every transcript and rng known
ahead, BPP_FUSE_PROVER not 0) takes the coefficient program, and the fold
stays the default.
"""
import numpy as np
import pytest
import torch

from bulletproofsplus_tpu import serialize as jax_serialize
from bulletproofsplus_tpu.curves import curve_ops as jax_curve_ops
from bulletproofsplus_tpu.golden import CURVES, protocol
from bulletproofsplus_tpu.golden import PublicKey as GoldenPublicKey
from bulletproofsplus_tpu.golden import RangeProver as GoldenRangeProver
from bulletproofsplus_tpu.golden.protocol import DeterministicRng as GoldenDR
from bulletproofsplus_tpu.golden.protocol import DeterministicTranscript as GoldenDT
from bulletproofsplus_tpu.protocol.range import RangeProof as JaxRangeProof
import bulletproofsplus_tpu_torch as bt
from bulletproofsplus_tpu_torch import serialize
from bulletproofsplus_tpu_torch.protocol import batchprove, wip_coeff

# tiny tensors: intra-op threads buy nothing here and oversubscribe the host
# beside other xdist workers
torch.set_num_threads(1)

NAME, N, M, K = "edwards25519", 8, 2, 2
SWITCHES = ("BPP_PROVER", "BPP_PROVER_SCAN", "BPP_FUSE_PROVER", "BPP_PIPPENGER",
            "BPP_PIPPENGER_MIN", "BPP_PIPPENGER_C")
BACKENDS = {"ladder": {}, "pippenger": {"BPP_PIPPENGER": "1", "BPP_PIPPENGER_MIN": "0"}}


@pytest.fixture(autouse=True)
def jax_defaults(monkeypatch):
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)


def spy(monkeypatch, module, name):
    """Count the calls of module.name, which still runs."""
    calls = []
    inner = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or inner(*a, **k))
    return calls


@pytest.fixture(scope="module")
def statements():
    """(port curve, pk, provers, golden wire bytes, the fold prover's bytes):
    K statements of M values from a numpy seed, the fold's batch proven
    once for the module."""
    c, jc, gc = bt.curve_ops(NAME), jax_curve_ops(NAME), CURVES[NAME]
    rng = np.random.default_rng(61)
    rows = [[(int(rng.integers(0, 1 << N)), int.from_bytes(rng.bytes(32), "little") % gc.fn.p)
             for _ in range(M)] for _ in range(K)]
    pk = bt.PublicKey.new(c, N * M, "cpu")
    gpk = GoldenPublicKey.new(gc, N * M)
    provers, golden = [], []
    for row in rows:
        p, gp = bt.RangeProver(), GoldenRangeProver()
        for v, g in row:
            p.commit(pk, v, g)
            gp.commit(gc, gpk, v, g)
        provers.append(p)
        proof = protocol.prove(gc, gpk, N, gp, GoldenDT(M), GoldenDR(M))
        golden.append(jax_serialize.proof_to_bytes(jc, JaxRangeProof.from_golden(jc, proof)))
    fold = bt.batch_prove(c, pk, N, provers, [bt.DeterministicTranscript(M)] * K,
                          [bt.DeterministicRng(M)] * K)
    return c, pk, provers, golden, [serialize.proof_to_bytes(c, fold[k]) for k in range(K)]


def test_fold_is_the_default(statements):
    """The fold prover's bytes are golden's (the reference both others meet)."""
    _, _, _, golden, fold = statements
    assert fold == golden


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("batch", [1, K], ids=["prove", "batch2"])
def test_coeff_bytes_equal_golden_and_fold(statements, monkeypatch, backend, batch):
    """BPP_PROVER=coeff on each row-MSM backend: the bytes of `prove` (one
    statement) and of a batch of two (the rows' points one (2·log2 mn,
    mn + 2) tensor expanded over K) equal golden's and the fold's; the
    coefficient program ran, and the bucket MSM ran exactly on its backend
    (the L/R rows and the A row)."""
    c, pk, provers, golden, fold = statements
    monkeypatch.setenv("BPP_PROVER", "coeff")
    for name, value in BACKENDS[backend].items():
        monkeypatch.setenv(name, value)
    coeff = spy(monkeypatch, batchprove, "wip_prove_coeff_batched")
    buckets = spy(monkeypatch, wip_coeff, "msm_pippenger")
    if batch == 1:
        got = [bt.prove(c, pk, N, provers[0], bt.DeterministicTranscript(M),
                        bt.DeterministicRng(M))]
    else:
        proofs = bt.batch_prove(c, pk, N, provers, [bt.DeterministicTranscript(M)] * K,
                                [bt.DeterministicRng(M)] * K)
        got = [proofs[k] for k in range(K)]
    wire = [serialize.proof_to_bytes(c, p) for p in got]
    assert wire == golden[:batch] == fold[:batch]
    assert len(coeff) == 1
    assert len(buckets) == (2 if backend == "pippenger" else 0)


@pytest.mark.parametrize("env,coeff", [
    ({"BPP_PROVER": "coeff"}, True),
    ({"BPP_PROVER": "coeff", "BPP_FUSE_PROVER": "0"}, False),
    ({"BPP_PROVER": "scan"}, False),
    ({"BPP_PROVER": "unrolled"}, False),
    ({}, False),
], ids=["coeff", "coeff-unfused", "scan", "unrolled", "unset"])
def test_routing_follows_the_jax_package(statements, monkeypatch, env, coeff):
    """Which program the known-ahead branch hands the fold to: the
    coefficient program only under BPP_PROVER=coeff with every rng's blinds
    known ahead and BPP_FUSE_PROVER not 0 (wip.py:629-650, batchprove.py:
    271-316); scan and unrolled both mean the port's one fold. A SystemRng
    keeps the fold under BPP_PROVER=coeff, as the JAX package's
    interactive branch does."""
    c, pk, provers, _, _ = statements
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    ran = []

    class Stop(Exception):
        pass

    def stub(label):
        def run(*args):
            ran.append(label)
            raise Stop
        return run

    monkeypatch.setattr(batchprove, "wip_prove_coeff_batched", stub("coeff"))
    monkeypatch.setattr(batchprove, "wip_prove_known_batched", stub("fold"))
    with pytest.raises(Stop):
        bt.prove(c, pk, N, provers[0], bt.DeterministicTranscript(M), bt.DeterministicRng(M))
    assert ran == ["coeff" if coeff else "fold"]
    if coeff:
        with pytest.raises(Stop):
            bt.prove(c, pk, N, provers[0], bt.DeterministicTranscript(M),
                     bt.SystemRng(c.fn.p))
        assert ran == ["coeff", "fold"]
