"""The port's verifier slice against the JAX package and the golden oracle.

Statements are golden-made deterministic-mode proofs at n = 8, m = 2 and
m = 1 (K = 2). The port's exponent vectors must equal the JAX package's
exponent programs on the same (numpy-seeded) challenges, and the port must
accept and reject exactly what golden `protocol.verify` and JAX
`batch_verify` accept and reject. Comparisons are exact: canonical integers,
tensors of the port's own layout, or accept/reject polarity."""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bulletproofsplus_tpu import ProofBatch as JaxProofBatch
from bulletproofsplus_tpu import batch_verify as jax_batch_verify
from bulletproofsplus_tpu import serialize as jax_serialize
from bulletproofsplus_tpu.curves import curve_ops as jax_curve_ops
from bulletproofsplus_tpu.errors import VerificationError as JaxVerificationError
from bulletproofsplus_tpu.golden import CURVES, RangeProver, protocol
from bulletproofsplus_tpu.golden import PublicKey as GoldenPublicKey
from bulletproofsplus_tpu.golden.protocol import DeterministicRng
from bulletproofsplus_tpu.golden.protocol import DeterministicTranscript as GoldenDT
from bulletproofsplus_tpu.protocol.range import (
    RangeProof as JaxRangeProof,
    _vinputs_multiple_batched,
    _vinputs_single_prog,
)
from bulletproofsplus_tpu.protocol.publickey import PublicKey as JaxPublicKey
from bulletproofsplus_tpu.transcript import DeterministicTranscript as JaxDT
import bulletproofsplus_tpu_torch as bt
from bulletproofsplus_tpu_torch import convert, serialize
from bulletproofsplus_tpu_torch.errors import FormatError
from bulletproofsplus_tpu_torch.protocol.range import (
    vinputs_multiple_batched,
    vinputs_single_batched,
)

N = 8
K = 2
FIXTURE = "bulletproofsplus_tpu_torch/data/ed25519_n64_m16_det.bin"


def weights(seed):
    rnd = random.Random(seed)
    return lambda: rnd.getrandbits(128)


@pytest.fixture(scope="module")
def env():
    return bt.curve_ops(), jax_curve_ops("edwards25519"), CURVES["edwards25519"]


def _statements(gc, jc, m):
    """K golden proofs over one pk: [(golden proof, commitments, wire bytes)]."""
    gpk = GoldenPublicKey.new(gc, N * m)
    out = []
    for k in range(K):
        rng = np.random.default_rng(100 * m + k)
        prover = RangeProver()
        for _ in range(m):
            prover.commit(gc, gpk, int(rng.integers(0, 1 << N)),
                          int.from_bytes(rng.bytes(32), "little") % gc.fn.p)
        proof = protocol.prove(gc, gpk, N, prover, GoldenDT(m), DeterministicRng(m))
        wire = jax_serialize.proof_to_bytes(jc, JaxRangeProof.from_golden(jc, proof))
        out.append((proof, prover.commitment_vec, wire))
    return gpk, out


@pytest.fixture(scope="module")
def statements(env):
    _, jc, gc = env
    return {m: _statements(gc, jc, m) for m in (2, 1)}


def port_batch(c, stmts, tamper=False):
    batch = bt.ProofBatch.from_proofs(
        [serialize.proof_from_bytes(c, wire, "cpu") for _, _, wire in stmts])
    V = torch.stack([c.encode_points(comms) for _, comms, _ in stmts])
    if tamper:
        batch.r_prime = batch.r_prime.clone()
        batch.r_prime[1] = c.fn.add(batch.r_prime[1], c.fn.one("cpu"))
    return batch, V


def jax_batch(jc, stmts, tamper=False):
    batch = JaxProofBatch.from_proofs(
        [jax_serialize.proof_from_bytes(jc, wire) for _, _, wire in stmts])
    V = jnp.stack([jnp.asarray(jc.encode_points(comms)) for _, comms, _ in stmts])
    if tamper:
        one = jnp.asarray(jc.fn.one_np)
        batch = dataclasses.replace(
            batch, r_prime=batch.r_prime.at[1].set(jc.fn.add(batch.r_prime[1], one)))
    return batch, V


def golden_accepts(gc, gpk, stmts, tamper=False):
    """Whether golden verify accepts every statement (proof 1 tampered)."""
    for i, (proof, comms, _) in enumerate(stmts):
        if tamper and i == 1:
            w = dataclasses.replace(proof.proof,
                                    r_prime=(proof.proof.r_prime + 1) % gc.fn.p)
            proof = dataclasses.replace(proof, proof=w)
        try:
            protocol.verify(gc, proof, gpk, N, comms, GoldenDT(len(comms)))
        except Exception:
            return False
    return True


def port_accepts(c, pk, stmts, m, tamper=False):
    batch, V = port_batch(c, stmts, tamper)
    try:
        bt.batch_verify(c, pk, N, batch, V, [bt.DeterministicTranscript(m)] * K,
                        rng=weights(m))
    except bt.VerificationError:
        return False
    return True


@pytest.fixture(scope="module")
def jax_polarity(env, statements):
    """JAX batch_verify's verdicts on the m = 2 batch, valid and tampered
    (one cold compile for the module, then a warm second call)."""
    _, jc, _ = env
    jpk = JaxPublicKey.new(jc, N * 2)
    verdicts = []
    for tamper in (False, True):
        batch, V = jax_batch(jc, statements[2][1], tamper)
        try:
            jax_batch_verify(jc, jpk, N, batch, V, transcripts=[JaxDT(2)] * K,
                             rng=weights(7))
            verdicts.append(True)
        except JaxVerificationError:
            verdicts.append(False)
    return tuple(verdicts)


@pytest.mark.parametrize("m", [2, 1])
def test_exponent_vectors_match_jax(env, m):
    """The batched exponent programs on random (numpy-seeded) challenges and
    proof scalars, against the JAX package's programs."""
    c, jc, _ = env
    fn, jfn = c.fn, jc.fn
    logn = (N * m).bit_length() - 1
    rng = np.random.default_rng(m)

    def ints(count):
        return [int.from_bytes(rng.bytes(40), "little") % fn.p for _ in range(count)]

    cols = [ints(K), ints(K), ints(K * logn), ints(K), ints(K), ints(K), ints(K)]
    port_in = [fn.encode(v) for v in cols]
    port_in[2] = port_in[2].reshape(K, logn, 8)
    jax_in = [jnp.asarray(jfn.encode(v)) for v in cols]
    jax_in[2] = jax_in[2].reshape(K, logn, -1)
    if m == 1:
        got = vinputs_single_batched(fn, N, *port_in)
        want = jax.vmap(_vinputs_single_prog(jc, N))(*jax_in)
    else:
        got = vinputs_multiple_batched(fn, N, m, *port_in)
        want = _vinputs_multiple_batched(jc, N, m)(*jax_in)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert fn.decode(g) == jfn.decode(w.reshape(-1, w.shape[-1]))


@pytest.mark.parametrize("m", [2, 1])
def test_batch_verify_polarity_matches_golden(env, statements, m):
    c, _, gc = env
    gpk, stmts = statements[m]
    pk = bt.PublicKey.new(c, N * m, "cpu")
    for tamper in (False, True):
        assert port_accepts(c, pk, stmts, m, tamper) is not tamper
        assert golden_accepts(gc, gpk, stmts, tamper) is not tamper


def test_batch_verify_polarity_matches_jax(env, statements, jax_polarity):
    c = env[0]
    pk = bt.PublicKey.new(c, N * 2, "cpu")
    mine = tuple(port_accepts(c, pk, statements[2][1], 2, tamper)
                 for tamper in (False, True))
    assert mine == jax_polarity == (True, False)


@pytest.mark.parametrize("m", [2, 1])
def test_single_verify_matches_golden(env, statements, m):
    c = env[0]
    _, stmts = statements[m]
    pk = bt.PublicKey.new(c, 64, "cpu")   # longer than n·m: verify uses the prefix
    batch, V = port_batch(c, stmts)
    bt.verify(c, batch[0], pk, N, V[0], bt.DeterministicTranscript(m))
    bad, _ = port_batch(c, stmts, tamper=True)
    with pytest.raises(bt.VerificationError):
        bt.verify(c, bad[1], pk, N, V[1], bt.DeterministicTranscript(m))
    with pytest.raises(bt.VerificationError):
        bt.verify(c, batch[0], pk, 16, V[0], bt.DeterministicTranscript(m))


def test_proof_batch_from_jax_equals_port_decode(env, statements):
    c, jc, _ = env
    stmts = statements[2][1]
    jb, jV = jax_batch(jc, stmts)
    got = convert.proof_batch_from_jax(jb, c, "cpu")
    want, V = port_batch(c, stmts)
    for f in dataclasses.fields(want):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f.name
    assert torch.equal(convert.commitments_from_jax(jV, c, "cpu"), V)
    assert serialize.proof_to_bytes(c, want[0]) == stmts[0][2]


def test_batch_verify_argument_errors(env, statements):
    c = env[0]
    batch, V = port_batch(c, statements[2][1])
    pk = bt.PublicKey.new(c, N * 2, "cpu")
    with pytest.raises(bt.VerificationError):
        bt.batch_verify(c, pk, N, batch, V[:1], [bt.DeterministicTranscript(2)] * K)
    with pytest.raises(NotImplementedError):
        bt.batch_verify(c, pk, N, batch, V)
    with pytest.raises(bt.VerificationError):   # n·m does not match the rounds
        bt.batch_verify(c, pk, 16, batch, V, [bt.DeterministicTranscript(2)] * K)
    bt.batch_verify(c, pk, N, batch.take(slice(0, 0)), V[:0], [])


def test_point_decoding_rejects_torsion_and_off_curve():
    p = 2**255 - 19
    order2 = (p - 1).to_bytes(32, "little")          # (0, -1): order 2
    with pytest.raises(FormatError):
        serialize.point_from_bytes(order2)
    with pytest.raises(FormatError):                 # y = 2 has no x on the curve
        serialize.point_from_bytes((2).to_bytes(32, "little"))
    assert serialize.point_from_bytes(serialize.point_bytes(None)) is None


def test_committed_fixture_decodes():
    """The card's statements: ≥ 16 golden proofs at n = 64, m = 16."""
    c = bt.curve_ops()
    with open(FIXTURE, "rb") as f:
        n, m, rows = serialize.read_fixture(f.read())
    assert (n, m) == (64, 16) and len(rows) >= 16
    comms, wire = rows[0]
    proof = serialize.proof_from_bytes(c, wire, "cpu")
    assert proof.proof.rounds == 10
    assert len(serialize.points_from_bytes(comms)) == m
    assert serialize.proof_to_bytes(c, proof) == wire


class _ZeroRoundTranscript(bt.DeterministicTranscript):
    def round_challenge(self, curve=None, L=None, R=None) -> int:
        return 0


def test_zero_challenge_rejected_by_replay(env, statements):
    """The host replay rejects a zero challenge (range.py:392)."""
    c = env[0]
    batch, V = port_batch(c, statements[2][1])
    pk = bt.PublicKey.new(c, N * 2, "cpu")
    with pytest.raises(bt.VerificationError):
        bt.batch_verify(c, pk, N, batch, V, [_ZeroRoundTranscript(2)] * K)
