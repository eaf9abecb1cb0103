"""The port's interactive transcripts (ShaTranscript, MerlinBppTranscript)
against the JAX package, on edwards25519, secp256k1 and bls12-381 G1.

Layers, bottom up: Keccak-f[1600] and the merlin crate's transcript vector
through the port's copy; both transcripts against the JAX classes on the
same seeded affine points, identity included, and their zero challenge
mapped to 1; the blind order of the port's batch prover against the JAX
package's two orders; then whole proofs at n = 8, K = 2.

Proofs meet golden's prover driven by the JAX package's own transcripts
(`GoldenHost`, as tests/test_torch_fs256.py's GoldenFs256), not JAX `prove`:
in sha mode a JAX `prove` and `verify` at edwards25519, n = 8, m = 2 take
minutes of XLA:CPU compiles. Each (curve, m) batch holds one ShaTranscript
proof and one MerlinBppTranscript proof, proven once per module with
DeterministicRng; the port must verify them with fresh transcripts of the
same kinds and reject a tampered proof or the other kind's transcript.
A K = 2 batch mixing Fs256Transcript with ShaTranscript takes the
interactive path too, with a shared recording rng."""
import jax
import numpy as np
import pytest
import torch

from bulletproofsplus_tpu import merlin as jax_merlin
from bulletproofsplus_tpu import serialize as jax_serialize
from bulletproofsplus_tpu.curves import curve_ops as jax_curve_ops
from bulletproofsplus_tpu.golden import CURVES, protocol
from bulletproofsplus_tpu.golden import PublicKey as GoldenPublicKey
from bulletproofsplus_tpu.golden import RangeProver as GoldenRangeProver
from bulletproofsplus_tpu.golden.protocol import DeterministicRng as GoldenDR
from bulletproofsplus_tpu.protocol.range import RangeProof as JaxRangeProof
from bulletproofsplus_tpu.transcript import Fs256Transcript as JaxFs256
from bulletproofsplus_tpu.transcript import ShaTranscript as JaxSha
import bulletproofsplus_tpu_torch as bt
from bulletproofsplus_tpu_torch import merlin, serialize
from bulletproofsplus_tpu_torch.curves import CURVE_NAMES
from bulletproofsplus_tpu_torch.protocol import batchprove

# The port's CPU tests run tiny tensors: intra-op threads buy nothing at
# these sizes, and beside other xdist workers they oversubscribe the host.
torch.set_num_threads(1)

N = 8
K = 2
CPU = "cpu"


@pytest.fixture(autouse=True)
def release_jax_executables():
    """Drop the JAX package's compiled programs after each test, as the
    other port test files do."""
    yield
    jax.clear_caches()


def host_points(name, count, seed):
    """count seeded affine points of the curve's group (multiples of the
    base point by numpy-drawn scalars), one of them the identity (None)."""
    hc = bt.curve_ops(name).host
    rng = np.random.default_rng(seed)
    B = hc.lift(hc.base)
    pts = hc.to_affine([hc.mul(B, int.from_bytes(rng.bytes(48), "little") % (hc.order - 1) + 1)
                        for _ in range(count)])
    pts[seed % count] = None
    return pts


# -- Keccak, Merlin and the two transcripts ---------------------------------


def test_keccak_and_merlin_crate_vector():
    """Keccak-f[1600] of the zero state (XKCP) and the merlin crate's own
    transcript test (merlin-2.0 tests::transcript_kat), as
    tests/test_hashers_merlin.py holds the JAX package's copy."""
    st = bytearray(200)
    merlin.keccak_f1600(st)
    assert st[:8].hex() == "e7dde140798f25f1"
    t = merlin.MerlinTranscript(b"test protocol")
    t.append_message(b"some label", b"some data")
    assert t.challenge_bytes(b"challenge", 32).hex() == (
        "d5a21972d0d5fe320c0d263fac7fffb8145aa640af6e9bca177c03c7efcf0615")


@pytest.mark.parametrize("name", CURVE_NAMES)
def test_point_bytes_match_jax_with_the_identity(name):
    """The compressed encoding Merlin absorbs: the identity is (0, 1) on
    Edwards curves and 0x00 and zero bytes on Weierstrass curves, as JAX
    serialize.point_bytes (:74-89) gives it."""
    c, jc = bt.curve_ops(name), jax_curve_ops(name)
    for P in host_points(name, 4, 3):
        assert serialize.point_bytes(c, P) == jax_serialize.point_bytes(jc, P)
    ident = serialize.point_bytes(c, None)
    assert ident == (bytes([1] + [0] * 31) if c.COORDS == 4
                     else bytes(serialize.point_len(c)))


TRANSCRIPTS = {"sha": (bt.ShaTranscript, JaxSha),
               "merlin": (merlin.MerlinBppTranscript, jax_merlin.MerlinBppTranscript)}


@pytest.mark.parametrize("kind", sorted(TRANSCRIPTS))
@pytest.mark.parametrize("name", CURVE_NAMES)
def test_transcript_matches_jax(name, kind):
    """A statement of m = 2 commitments, four rounds and the final
    challenge on seeded points, the identity among them (as V, L, R, A or
    B depending on the curve's seed): every challenge equal to the JAX
    class's, and on point tensors as on affine tuples."""
    c, jc = bt.curve_ops(name), jax_curve_ops(name)
    seed = CURVE_NAMES.index(name)
    pts = host_points(name, 13, seed)
    tensors = c.encode_points(pts, CPU)

    def run(t, curve, P):
        got = [t.challenge_yz(curve, [P[0], P[1]], P[2])]
        got += [t.round_challenge(curve, P[i], P[i + 1]) for i in range(3, 11, 2)]
        return got + [t.final_challenge(curve, P[11], P[12])]

    ours_cls, jax_cls = TRANSCRIPTS[kind]
    want = run(jax_cls(2), jc, pts)
    assert run(ours_cls(2), c, pts) == want
    assert run(ours_cls(2), c, tensors) == want
    assert all(0 < x < c.fn.p for x in want[1:])


class _OneOrder:
    """A curve stand-in whose group order is 1: every challenge reduces to
    0, which both transcripts map to 1."""

    class fn:
        p = 1

    fp = bt.curve_ops("edwards25519").fp
    COORDS = 4


@pytest.mark.parametrize("kind", sorted(TRANSCRIPTS))
def test_zero_challenge_maps_to_one(kind):
    for cls in TRANSCRIPTS[kind]:
        t = cls(1)
        assert t.challenge_yz(_OneOrder, [None], None) == (1, 1)
        assert t.round_challenge(_OneOrder, None, None) == 1
        assert t.final_challenge(_OneOrder, None, None) == 1


# -- the blind order ---------------------------------------------------------


class RecordingRng:
    """One rng shared by every proof of a batch: draws 100, 101, ... in call
    order and records each call's kind."""

    def __init__(self):
        self.calls, self._next = [], 100

    def _take(self, kind, count):
        self.calls.append(kind)
        self._next += count
        return tuple(range(self._next - count, self._next))

    def alpha(self):
        return self._take("alpha", 1)[0]

    def round_blinds(self):
        return self._take("round", 2)

    def final_blinds(self):
        return self._take("final", 4)


def jax_interactive_order(logn):
    """The JAX interactive branch's calls for K proofs (batchprove.py
    :403-407, :430): every α, then round by round one (d_L, d_R) a proof,
    then every proof's final blinds."""
    return ["alpha"] * K + ["round"] * (K * logn) + ["final"] * K


@pytest.mark.parametrize("per_proof", [True, False])
def test_draw_blinds_orders(per_proof):
    """Per proof (the JAX whole-fold branches, batchprove.py:280-288): every
    α, then each proof's rounds and finals; otherwise the interactive
    order. Either way proof k gets the values drawn for it."""
    logn = 3
    rng = RecordingRng()
    alphas, dLs, dRs, finals = batchprove.draw_blinds([rng] * K, logn, per_proof)
    want = (["alpha"] * K + (["round"] * logn + ["final"]) * K if per_proof
            else jax_interactive_order(logn))
    assert rng.calls == want
    assert alphas == [100, 101]
    if per_proof:
        assert dLs[:logn] == [102, 104, 106] and finals[0] == (108, 109, 110, 111)
    else:
        assert dLs[:logn] == [102, 106, 110] and dRs[logn:] == [105, 109, 113]
        assert finals == [(114, 115, 116, 117), (118, 119, 120, 121)]


# -- proofs ------------------------------------------------------------------


def witnesses(m, count, seed, order):
    """count lists of m (v, γ) pairs from a numpy seed, γ below the group
    order."""
    rng = np.random.default_rng(seed)
    return [[(int(rng.integers(0, 1 << N)), int.from_bytes(rng.bytes(32), "little") % order)
             for _ in range(m)] for _ in range(count)]


class GoldenHost:
    """A JAX-package transcript driven by golden's prover. Golden asks for
    y and z without arguments, so the adapter absorbs the statement itself:
    the commitments and A = h·α + Σ (bit ? G : −H), computed as golden
    computes it."""

    def __init__(self, jc, twin, gpk, gc, row, m, alpha):
        self.jc, self.twin = jc, twin
        bits = protocol._bit_decompose([v for v, _ in row], N, m)
        self.V = [gc.add(gc.mul(gpk.g, v), gc.mul(gpk.h, g)) for v, g in row]
        self.A = gc.sum([gc.mul(gpk.h, alpha)]
                        + [gpk.G_vec[i] if b else gc.neg(gpk.H_vec[i])
                           for i, b in enumerate(bits)])

    def challenge_yz(self):
        return self.twin.challenge_yz(self.jc, self.V, self.A)

    def round_challenge(self, L, R):
        return self.twin.round_challenge(self.jc, L, R)

    def final_challenge(self, A, B):
        return self.twin.final_challenge(self.jc, A, B)


class ReplayRng:
    """One proof's blinds, handed to golden as they were drawn for it."""

    def __init__(self, alpha, rounds, finals):
        self._alpha, self._rounds, self._finals = alpha, list(rounds), finals

    def alpha(self):
        return self._alpha

    def round_blinds(self):
        return self._rounds.pop(0)

    def final_blinds(self):
        return self._finals


def golden_bytes(name, m, rows, twins, rngs):
    """Wire bytes of golden's proofs of `rows` under the JAX transcripts
    `twins` and golden rngs `rngs`."""
    jc, gc = jax_curve_ops(name), CURVES[name]
    gpk = GoldenPublicKey.new(gc, N * m)
    out = []
    for row, twin, rng in zip(rows, twins, rngs):
        gp = GoldenRangeProver()
        for v, g in row:
            gp.commit(gc, gpk, v, g)
        t = GoldenHost(jc, twin, gpk, gc, row, m, rng.alpha())
        assert t.V == list(gp.commitment_vec)
        proof = protocol.prove(gc, gpk, N, gp, t, rng)
        out.append(jax_serialize.proof_to_bytes(jc, JaxRangeProof.from_golden(jc, proof)))
    return out


def port_provers(pk, rows):
    provers = []
    for row in rows:
        p = bt.RangeProver()
        for v, g in row:
            p.commit(pk, v, g)
        provers.append(p)
    return provers


def sha_merlin(m):
    return [bt.ShaTranscript(m), merlin.MerlinBppTranscript(m)]


def jax_sha_merlin(m):
    return [JaxSha(m), jax_merlin.MerlinBppTranscript(m)]


CASES = [(name, m) for name in CURVE_NAMES for m in (1, 2)]
_PROVEN: dict = {}
_KEYS: dict = {}


def key(name, m):
    """One small-multiple key per (curve, m), shared by the module so the
    verifier builds its fixed-base tables once."""
    if (name, m) not in _KEYS:
        _KEYS[name, m] = bt.PublicKey.new(bt.curve_ops(name), N * m, CPU)
    return _KEYS[name, m]


def proven(name, m):
    """(provers, batch, transcripts, rows): proof 0 under ShaTranscript and
    proof 1 under MerlinBppTranscript, one batch, DeterministicRng."""
    if (name, m) not in _PROVEN:
        c = bt.curve_ops(name)
        rows = witnesses(m, K, 40 + m + 10 * CURVE_NAMES.index(name), c.fn.p)
        provers = port_provers(key(name, m), rows)
        trs = sha_merlin(m)
        batch = bt.batch_prove(c, key(name, m), N, provers, trs, [bt.DeterministicRng(m)] * K)
        _PROVEN[name, m] = provers, batch, trs, rows
    return _PROVEN[name, m]


def transcript_state(t):
    """What a finished transcript holds: the SHA-512 digest and counter, or
    the STROBE state and position."""
    if hasattr(t, "_h"):
        return t._h.digest(), t._counter
    return bytes(t.t.strobe.state), t.t.strobe.pos


@pytest.mark.parametrize("name,m", CASES, ids=[f"{n}-m{m}" for n, m in CASES])
def test_interactive_prove_matches_golden(name, m):
    """Proof bytes equal golden's proofs under fresh JAX transcripts of the
    same kinds, and each port transcript ends where its JAX twin ends."""
    c = bt.curve_ops(name)
    _, batch, trs, rows = proven(name, m)
    twins = jax_sha_merlin(m)
    want = golden_bytes(name, m, rows, twins, [GoldenDR(m)] * K)
    assert [serialize.proof_to_bytes(c, batch[k]) for k in range(K)] == want
    for t, twin in zip(trs, twins):
        assert transcript_state(t) == transcript_state(twin)


@pytest.mark.parametrize("name,m", CASES, ids=[f"{n}-m{m}" for n, m in CASES])
def test_interactive_proofs_verify(name, m):
    """batch_verify with fresh transcripts of the proving kinds accepts the
    batch (the host replay, one decode per stacked tensor) and rejects it
    with proof 1's r′ changed; at m = 1, `verify` accepts the ShaTranscript
    proof and rejects it under a MerlinBppTranscript."""
    c = bt.curve_ops(name)
    provers, batch, _, _ = proven(name, m)
    pk = key(name, m)
    V = bt.stack_commitments(c, [p.commitment_vec for p in provers])
    bt.batch_verify(c, pk, N, batch, V, sha_merlin(m))
    bad = batch.take(slice(None))
    bad.r_prime = bad.r_prime.clone()
    bad.r_prime[1] = c.fn.add(bad.r_prime[1], c.fn.one(CPU))
    with pytest.raises(bt.VerificationError):
        bt.batch_verify(c, pk, N, bad, V, sha_merlin(m))
    if m == 1:
        bt.verify(c, batch[0], pk, N, V[0], bt.ShaTranscript(m))
        with pytest.raises(bt.VerificationError):
            bt.verify(c, batch[0], pk, N, V[0], merlin.MerlinBppTranscript(m))


def test_mixed_fs256_sha_batch_with_a_shared_rng(monkeypatch):
    """[Fs256Transcript, ShaTranscript] in one batch take the interactive
    path: the fs256 transcript draws on its host twin. One recording rng
    shared by both proofs is drawn in the JAX interactive order, and golden
    under JAX twins given each proof's draws makes the same bytes. Each
    round costs one decode of the batch's L and R; the batch verifies with
    fresh transcripts of the same kinds (the host replay)."""
    name, m = "edwards25519", 1
    c = bt.curve_ops(name)
    logn = N.bit_length() - 1
    rows = witnesses(m, K, 77, c.fn.p)
    provers = port_provers(key(name, m), rows)
    rng = RecordingRng()
    decodes = []
    real = type(c).decode_points
    monkeypatch.setattr(type(c), "decode_points",
                        lambda self, t: decodes.append(tuple(t.shape)) or real(self, t))
    trs = [bt.Fs256Transcript(m), bt.ShaTranscript(m)]
    batch = bt.batch_prove(c, key(name, m), N, provers, trs, [rng] * K)
    monkeypatch.undo()
    assert rng.calls == jax_interactive_order(logn)
    # A, then the K·m commitments, then (K, 2) L and R a round, then (K, 2) A and B
    C, L = c.COORDS, c.fp.L
    assert decodes == [(K, C, L), (K * m, C, L)] + [(K, 2, C, L)] * (logn + 1)
    draws = [ReplayRng(100 + k,
                       [(102 + 2 * (K * j + k), 103 + 2 * (K * j + k)) for j in range(logn)],
                       tuple(range(102 + 2 * K * logn + 4 * k, 106 + 2 * K * logn + 4 * k)))
             for k in range(K)]
    twins = [JaxFs256(m), JaxSha(m)]
    want = golden_bytes(name, m, rows, twins, draws)
    assert [serialize.proof_to_bytes(c, batch[k]) for k in range(K)] == want
    assert trs[0]._state == twins[0]._state
    assert trs[0]._counter == twins[0]._counter == logn + 3
    V = bt.stack_commitments(c, [p.commitment_vec for p in provers])
    bt.batch_verify(c, key(name, m), N, batch, V, [bt.Fs256Transcript(m), bt.ShaTranscript(m)])
