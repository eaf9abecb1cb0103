"""The fs256 chain (hashers_device.fs256_chain, csrc/fs256_chain.cu) on the
CPU: its plain version against the JAX package's host twin on all three
curves, and the card path's transcript labels (the port's plain path,
edwards25519, n = 8). Under the default label the chain also meets the
JAX in-graph replay: test_torch_fs256.py's
test_fs256_replay_matches_jax_and_host_twins runs fs256_replay, whose
chain is this one, beside JAX fs256_replay (JAX's eager replay compiles
some 80 XLA programs on the CPU, 13-30 s a curve, too long for this file).

Every chain of the port starts from the state it is given, the
transcripts' own, which carries their label. The JAX package's in-graph
replay (bulletproofsplus_tpu/protocol/fs256.py:154-160) always starts from
FS256_LABEL's state whatever the transcript's label: that is a defect the
port deliberately does not share. So a custom label is held against the
JAX host twin (`Fs256Transcript(m, label)`, which honours it) and only the
default label against the JAX in-graph replay.

Points come from a numpy seed as projective tensors with Z ≠ 1, the
identity among them. Every comparison is exact: canonical integers and
state words. No JAX `prove` runs here; the proofs are the port's."""
import numpy as np
import pytest
import torch

from bulletproofsplus_tpu.curves import curve_ops as jax_curve_ops
from bulletproofsplus_tpu.golden import CURVES
from bulletproofsplus_tpu.transcript import FS256_LABEL
from bulletproofsplus_tpu.transcript import Fs256Transcript as JaxFs256
import bulletproofsplus_tpu_torch as bt
from bulletproofsplus_tpu_torch import hashers_device as hd
from bulletproofsplus_tpu_torch.curves import CURVE_NAMES
from bulletproofsplus_tpu_torch.protocol import fs256
from bulletproofsplus_tpu_torch.protocol.batch import replay_challenges

# tiny tensors: intra-op threads buy nothing and oversubscribe xdist workers
torch.set_num_threads(1)

N = 8
CPU = "cpu"
CUSTOM = b"an exchange's own fs256 label.  "       # 32 bytes, as the twin asserts
LABELS = {"default": FS256_LABEL, "custom": CUSTOM}


def chain_points(name, K, count, seed):
    """(golden affine points (K, count), the same as projective port
    tensors (K, count, C, L) with Z ≠ 1): multiples of the base from a
    numpy seed, one of them the identity."""
    c, gc = bt.curve_ops(name), CURVES[name]
    rng = np.random.default_rng(seed)
    pts = [gc.mul(gc.base(), int(s)) for s in rng.integers(1, 1 << 62, K * count)]
    pts[1] = None
    scale = int(rng.integers(2, 1 << 30))
    coords = [x * scale % c.fp.p for A in pts for x in c.host.lift(A)]
    T = c.fp.encode(coords).reshape(K, count, c.COORDS, c.fp.L)
    return [pts[k * count:(k + 1) * count] for k in range(K)], T


def twin_replay(jc, twin, m, logn, P):
    """The host twin's verifier challenges over golden points laid out as
    the replay's rows: V_1..V_m, A, (L_r, R_r) a round, A_wip, B."""
    out = list(twin.challenge_yz(jc, P[:m], P[m]))
    for r in range(logn):
        out.append(twin.round_challenge(jc, P[m + 1 + 2 * r], P[m + 2 + 2 * r]))
    out.append(twin.final_challenge(jc, P[-2], P[-1]))
    return out


@pytest.mark.parametrize("label", list(LABELS))
@pytest.mark.parametrize("name", CURVE_NAMES)
def test_chain_plain_replay_matches_the_jax_twin(name, label):
    """The verifier's schedule over K = 2 transcripts at m = 2, log2(mn) =
    2: every challenge and the final state equal the JAX host twin's under
    the same label."""
    c, jc = bt.curve_ops(name), jax_curve_ops(name)
    K, m, logn = 2, 2, 2
    P, T = chain_points(name, K, m + 3 + 2 * logn, 40 + len(name))
    twins = [JaxFs256(m, LABELS[label]) for _ in range(K)]
    state = hd.words_tensor(np.stack([t.state_words() for t in twins]))
    cw = fs256.affine_words(c, T).reshape(K, T.shape[1], -1)
    ch, st = hd.fs256_chain_plain(c.fn, state, None, cw, fs256.replay_schedule(m, logn))
    assert ch.shape == (K, 3 + logn, 8) and st.shape == (K, 8)
    for k, twin in enumerate(twins):
        assert c.fn.decode(ch[k]) == twin_replay(jc, twin, m, logn, P[k])
        assert np.array_equal(st[k].numpy().view(np.uint32), twin.state_words())
        assert twin._counter == 3 + logn


@pytest.mark.parametrize("name", CURVE_NAMES)
def test_chain_plain_prover_steps_match_the_jax_twin(name):
    """The prover's one-step schedules (statement, each round, final) from
    transcripts that already drew 1 and 2 challenges (counter offsets on
    a nonzero base), one under a custom label: each step's challenges and
    state equal the JAX host twin's."""
    c, jc = bt.curve_ops(name), jax_curve_ops(name)
    K, m, logn = 2, 1, 3
    P, T = chain_points(name, K, m + 3 + 2 * logn, 50 + len(name))
    twins = [JaxFs256(m, CUSTOM), JaxFs256(m)]
    for k, twin in enumerate(twins):
        for _ in range(k + 1):
            twin.round_challenge(jc, P[k][0], P[k][1])
    base = torch.tensor([t._counter for t in twins], dtype=torch.int32)
    state = hd.words_tensor(np.stack([t.state_words() for t in twins]))
    steps = ([(fs256.statement_step(m), slice(0, m + 1))]
             + [(fs256.round_step(r), slice(m + 1 + 2 * r, m + 3 + 2 * r)) for r in range(logn)]
             + [(fs256.final_step(logn), slice(m + 1 + 2 * logn, None))])
    want = [[] for _ in twins]
    for k, twin in enumerate(twins):
        want[k] = twin_replay(jc, twin, m, logn, P[k])
    got = []
    for step, rows in steps:
        pts = T[:, rows]
        cw = fs256.affine_words(c, pts).reshape(K, pts.shape[1], -1)
        ch, state = hd.fs256_chain_plain(c.fn, state, base, cw, (step,))
        got.append(ch)
    got = torch.cat(got, dim=1)
    for k, twin in enumerate(twins):
        assert c.fn.decode(got[k]) == want[k]
        assert np.array_equal(state[k].numpy().view(np.uint32), twin.state_words())
    assert [t._counter for t in twins] == [k + 1 + 3 + logn for k in range(K)]


def test_zero_challenge_maps_to_one(monkeypatch):
    """A digest that reduces to 0 gives the challenge 1 in every schedule
    position: here the second of a statement step's two, on one of two
    transcripts, with the other and the state unaffected."""
    c = bt.curve_ops("edwards25519")
    twins = [bt.Fs256Transcript(1, CUSTOM), bt.Fs256Transcript(1)]
    state = hd.words_tensor(np.stack([t.state_words() for t in twins]))
    _, T = chain_points("edwards25519", 2, 2, 70)
    cw = fs256.affine_words(c, T).reshape(2, 2, -1)
    real = hd.digest_to_field_mont
    calls = []

    def zero_second(fn, d):
        calls.append(None)
        e = real(fn, d)
        return torch.cat([torch.zeros_like(e[:1]), e[1:]]) if len(calls) == 2 else e

    want, want_state = hd.fs256_chain_plain(c.fn, state, None, cw, (fs256.statement_step(1),))
    monkeypatch.setattr(hd, "digest_to_field_mont", zero_second)
    got, got_state = hd.fs256_chain(c.fn, state, None, cw, (fs256.statement_step(1),))
    assert c.fn.decode(got[0, 1]) == 1 and c.fn.decode(want[0, 1]) != 1
    assert torch.equal(got[1], want[1]) and torch.equal(got[0, 0], want[0, 0])
    assert torch.equal(got_state, want_state)


# -- C.2: transcript labels through the card path -------------------------------


@pytest.fixture(scope="module")
def mixed():
    """(pk, commitments (2, 1, C, L), the batch): the port's batch prove of
    two m = 1 statements, proof 0 under CUSTOM and proof 1 under the
    default label."""
    c = bt.curve_ops("edwards25519")
    pk = bt.PublicKey.new(c, N, CPU)
    provers = []
    for k in range(2):
        p = bt.RangeProver()
        p.commit(pk, 37 + 100 * k, 1000 + k)
        provers.append(p)
    trs = [bt.Fs256Transcript(1, CUSTOM), bt.Fs256Transcript(1)]
    batch = bt.batch_prove(c, pk, N, provers, trs, [bt.DeterministicRng(1)] * 2)
    V = bt.stack_commitments(c, [p.commitment_vec for p in provers])
    return pk, V, batch


def test_custom_label_proof_verifies_under_its_label(mixed):
    c = bt.curve_ops("edwards25519")
    pk, V, batch = mixed
    bt.verify(c, batch[0], pk, N, V[0], bt.Fs256Transcript(1, CUSTOM))


def test_default_label_proof_rejects_under_a_custom_label(mixed):
    c = bt.curve_ops("edwards25519")
    pk, V, batch = mixed
    with pytest.raises(bt.VerificationError):
        bt.verify(c, batch[1], pk, N, V[1], bt.Fs256Transcript(1, CUSTOM))


def test_card_replay_under_a_custom_label_matches_the_jax_twin(mixed):
    """replay_challenges sends unused fs256 transcripts to the card path
    (fs256_replay from their stacked states): its challenges equal the JAX
    host twin's under each proof's label, not the JAX in-graph replay's
    (which ignores the label)."""
    c, jc = bt.curve_ops("edwards25519"), jax_curve_ops("edwards25519")
    _, V, batch = mixed
    trs = [bt.Fs256Transcript(1, CUSTOM), bt.Fs256Transcript(1)]
    y, z, es, ef = replay_challenges(c, N, 1, batch, V, trs)
    pts = c.decode_points
    for k, label in enumerate((CUSTOM, FS256_LABEL)):
        twin = JaxFs256(1, label)
        want = list(twin.challenge_yz(jc, pts(V[k]), pts(batch.A[k])[0]))
        want += [twin.round_challenge(jc, L, R)
                 for L, R in zip(pts(batch.L_vec[k]), pts(batch.R_vec[k]))]
        want.append(twin.final_challenge(jc, pts(batch.A_wip[k])[0], pts(batch.B[k])[0]))
        got = [c.fn.decode(y[k]), c.fn.decode(z[k]), *c.fn.decode(es[k]), c.fn.decode(ef[k])]
        assert got == want


def test_batch_verify_over_mixed_labels_accepts(mixed):
    c = bt.curve_ops("edwards25519")
    pk, V, batch = mixed
    bt.batch_verify(c, pk, N, batch, V, [bt.Fs256Transcript(1, CUSTOM), bt.Fs256Transcript(1)])
