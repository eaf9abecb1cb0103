"""The port's fs256 transcript against the JAX package, on edwards25519,
secp256k1 and bls12-381 G1.

Layers, bottom up: the plain SHA-256 against hashlib and JAX
`sha256_words`; the field packing and digest reduction against JAX's on four
fields; the host twin `Fs256Transcript` against JAX's on the same affine
points, identity included; the port's device chain (`absorb_and_draw`,
the chain kernel's plain version on CPU tensors) against its host twin; `fs256_replay`
against JAX `fs256_replay` and both host twins; and whole proofs at n = 8.
Every comparison is exact: canonical integers, words, proof bytes and the
transcripts' final state and counter.

Proofs are compared two ways. JAX `prove` runs eagerly on the CPU for about
a minute a statement on edwards25519 (and past two minutes, with XLA:CPU
running out of compile memory at m = 2, on secp256k1), so it is compared on
edwards25519 at m = 1 and 2. On every curve and m, the proofs meet golden's
prover driven by the JAX package's own host twin (`GoldenFs256`, seconds a
statement): the same prover whose deterministic bytes the JAX package's
tests hold equal to JAX `prove`, with the JAX transcript deriving every
challenge. bls12-381 is held that way and by accept and reject only, not by
JAX compiles. Each batch is proven once per module."""
import dataclasses
import hashlib
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bulletproofsplus_tpu import serialize as jax_serialize
from bulletproofsplus_tpu.curves import curve_ops as jax_curve_ops
from bulletproofsplus_tpu.fields import ALL_SPECS, field_ops
from bulletproofsplus_tpu.golden import CURVES, protocol
from bulletproofsplus_tpu.golden import PublicKey as GoldenPublicKey
from bulletproofsplus_tpu.golden import RangeProver as GoldenRangeProver
from bulletproofsplus_tpu.golden.protocol import DeterministicRng as GoldenDR
from bulletproofsplus_tpu.hashers_device import digest_to_field_mont as jax_digest
from bulletproofsplus_tpu.hashers_device import field_be_words as jax_be_words
from bulletproofsplus_tpu.hashers_device import sha256_words as jax_sha256_words
from bulletproofsplus_tpu.protocol.fs256 import fs256_replay as jax_fs256_replay
from bulletproofsplus_tpu.protocol.publickey import PublicKey as JaxPublicKey
from bulletproofsplus_tpu.protocol.range import RangeProof as JaxRangeProof
from bulletproofsplus_tpu.protocol.range import RangeProver as JaxRangeProver
from bulletproofsplus_tpu.protocol.range import prove as jax_prove
from bulletproofsplus_tpu.transcript import DeterministicRng as JaxDR
from bulletproofsplus_tpu.transcript import Fs256Transcript as JaxFs256
from bulletproofsplus_tpu.utils.convert import int_to_limbs
import bulletproofsplus_tpu_torch as bt
from bulletproofsplus_tpu_torch import hashers_device as hd
from bulletproofsplus_tpu_torch import serialize
from bulletproofsplus_tpu_torch.curves import CURVE_NAMES
from bulletproofsplus_tpu_torch.fields import (
    BLS12_381_FQ,
    ED25519_FL,
    ED25519_FP,
    SECP256K1_FN,
    FieldOps,
)
from bulletproofsplus_tpu_torch.protocol import batch as batch_mod
from bulletproofsplus_tpu_torch.protocol import fs256
from bulletproofsplus_tpu_torch.protocol.range import replay_batch

# The port's CPU tests run tiny tensors: intra-op threads buy nothing at
# these sizes, and beside other xdist workers they oversubscribe the host.
torch.set_num_threads(1)

N = 8
K = 2
CPU = "cpu"
SPECS = {"ed25519_fp": ED25519_FP, "ed25519_fl": ED25519_FL,
         "secp256k1_fn": SECP256K1_FN, "bls12_381_fq": BLS12_381_FQ}


@pytest.fixture(autouse=True)
def release_jax_executables():
    """Drop the JAX package's compiled programs after each test, as the
    other port test files do: one process keeping every XLA:CPU executable
    alive passes the kernel's memory-map limit."""
    yield
    jax.clear_caches()


def digest_bytes(words) -> bytes:
    return b"".join((int(x) & 0xFFFFFFFF).to_bytes(4, "big") for x in np.asarray(words))


def message_words(msg: bytes) -> np.ndarray:
    return np.frombuffer(msg, dtype=">u4").astype(np.uint32)


# -- SHA-256 and the field packing ------------------------------------------


def test_sha256_plain_matches_hashlib():
    """Lengths of 0 to 4 blocks, padding that spills into a block of its own
    (60, 100 and 228 bytes leave fewer than 9 bytes), and the wrapper takes
    the plain version for a CPU tensor without a launch."""
    before = hd.sha256_words.launches
    for msg_len in (0, 4, 32, 44, 60, 64, 100, 160, 228, 256):
        msg = (bytes(range(200)) * 2)[:msg_len]
        d = hd.sha256_words(hd.words_tensor(message_words(msg)), msg_len)
        assert d.shape == (8,) and d.dtype == torch.int32
        assert digest_bytes(d) == hashlib.sha256(msg).digest(), msg_len
    assert hd.sha256_words.launches == before
    with pytest.raises(ValueError):
        hd.sha256_words(torch.zeros(3, dtype=torch.int32), 10)


@pytest.mark.parametrize("msg_bytes", [36, 164])
def test_sha256_plain_matches_jax_on_a_batch(msg_bytes):
    """A (2, 3) batch of seeded words (high bits set), the lengths of a
    challenge half and of an (L, R) absorb at 8 words a coordinate."""
    words = np.random.default_rng(msg_bytes).integers(
        0, 1 << 32, size=(2, 3, msg_bytes // 4), dtype=np.uint64).astype(np.uint32)
    got = hd.sha256_words_plain(hd.words_tensor(words), msg_bytes)
    want = np.asarray(jax_sha256_words(jnp.asarray(words), msg_bytes))
    assert got.shape == (2, 3, 8)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    for i, j in ((0, 0), (1, 2)):
        msg = words[i, j].astype(">u4").tobytes()
        assert digest_bytes(got[i, j]) == hashlib.sha256(msg).digest()


@pytest.mark.parametrize("spec_name", list(SPECS))
def test_field_words_and_digest_match_jax(spec_name):
    spec, jspec = SPECS[spec_name], ALL_SPECS[spec_name]
    f, jf = FieldOps(spec), field_ops(jspec)
    rng = random.Random(5)
    xs = [rng.randrange(spec.modulus) for _ in range(4)] + [0, 1, spec.modulus - 1]
    got = hd.field_be_words(f, f.encode_plain(xs))
    want = np.asarray(jax_be_words(jf, jnp.asarray(np.stack(
        [int_to_limbs(x, jf.L, jf.W) for x in xs]))))
    assert np.array_equal(got.numpy().view(np.uint32), want)
    for i, x in enumerate(xs):
        assert digest_bytes(got[i]) == x.to_bytes(hd.field_nbytes(f), "big")

    digests = [hashlib.sha512(spec_name.encode() + bytes([i])).digest() for i in range(3)]
    digests.append(b"\xff" * 64)
    words = np.stack([message_words(d) for d in digests])
    e = f.decode(hd.digest_to_field_mont(f, hd.words_tensor(words)))
    assert e == [int.from_bytes(d, "big") % spec.modulus for d in digests]
    assert e == jf.decode(np.asarray(jax_digest(jf, jnp.asarray(words))))


# -- the transcript ----------------------------------------------------------


def sample_points(gc):
    return [gc.mul(gc.base(), 7), gc.mul(gc.base(), 1234567), None, gc.mul(gc.base(), 99)]


@pytest.mark.parametrize("name", CURVE_NAMES)
def test_transcript_matches_jax(name):
    """The whole chain on the same affine points, the identity among them;
    the port's twin is also given the port's point tensors for some."""
    c, jc, gc = bt.curve_ops(name), jax_curve_ops(name), CURVES[name]
    P = sample_points(gc)
    T = c.encode_points(P)
    mine, ref = bt.Fs256Transcript(2), JaxFs256(2)
    assert np.array_equal(mine.state_words(), ref.state_words())
    assert mine.challenge_yz(c, [T[0], P[2]], T[1]) == ref.challenge_yz(jc, P[:3:2], P[1])
    assert mine.round_challenge(c, T[2], P[3]) == ref.round_challenge(jc, P[2], P[3])
    assert mine.round_challenge(c, P[0], P[1]) == ref.round_challenge(jc, P[0], P[1])
    assert mine.final_challenge(c, P[3], T[2]) == ref.final_challenge(jc, P[3], None)
    assert np.array_equal(mine.state_words(), ref.state_words())
    assert mine._counter == ref._counter == 5
    assert not mine.challenges_known_ahead and mine.device_graph
    words = np.arange(8, dtype=np.uint32) * 0x9E3779B9
    mine.set_state_words(words.view(np.int32), 3)
    ref.set_state_words(words, 3)
    assert np.array_equal(mine.state_words(), ref.state_words()) and mine._counter == 8


@pytest.mark.parametrize("name", CURVE_NAMES)
def test_device_chain_matches_host_twin(name):
    """absorb_and_draw (one chain step: absorb, then a challenge) on CPU
    tensors with a leading axis of two transcripts in different states,
    against the host twin row by row; points as projective tensors with
    Z ≠ 1, identity included."""
    c, gc = bt.curve_ops(name), CURVES[name]
    P = sample_points(gc)
    scaled = [x * 5 % c.fp.p for A in P for x in c.host.lift(A)]   # the same points
    proj = c.fp.encode(scaled).reshape(len(P), c.COORDS, c.fp.L)
    twins = [bt.Fs256Transcript(2), bt.Fs256Transcript(4)]
    state = hd.words_tensor(np.stack([t.state_words() for t in twins]))
    rows = torch.stack([proj[[0, 2]], proj[[3, 1]]])            # (2, 2, C, L)
    e, state = fs256.absorb_and_draw(c, state, None, hd.Step(b"LR  ", (0, 2), ((b"e   ", 1),)),
                                     rows)
    ef, state = fs256.absorb_and_draw(c, state, None,
                                      hd.Step(b"AB  ", (0, 2), ((b"ef  ", 2),)), rows.flip(1))
    for k, (t, (i, j)) in enumerate(zip(twins, ((0, 2), (3, 1)))):
        t._absorb_points(c, b"LR  ", [P[i], P[j]])
        assert c.fn.decode(e[k, 0]) == t._challenge(c, b"e   ")
        t._absorb_points(c, b"AB  ", [P[j], P[i]])
        assert c.fn.decode(ef[k, 0]) == t._challenge(c, b"ef  ")
        assert digest_bytes(state[k]) == t._state


def test_zero_challenge_maps_to_one_on_the_card_and_rejects_on_the_host(monkeypatch):
    """A digest that reduces to 0 gives the challenge 1 in the chain (its
    plain version, which the card's kernel equals word for word), as on the
    host twin; the host replay rejects a transcript that hands it a zero
    challenge (range.py:392)."""
    c = bt.curve_ops("edwards25519")
    state = hd.words_tensor(np.stack([bt.Fs256Transcript(2).state_words()] * 2))
    real = hd.digest_to_field_mont
    monkeypatch.setattr(hd, "digest_to_field_mont",
                        lambda fn, d: torch.cat([torch.zeros_like(real(fn, d[:1])),
                                                 real(fn, d[1:])]))
    e, _ = hd.fs256_chain(c.fn, state, None, torch.zeros(2, 0, 16, dtype=torch.int32),
                          (hd.Step(None, (0, 0), ((b"e   ", 1),)),))
    assert c.fn.decode(e[0, 0]) == 1 and c.fn.decode(e[1, 0]) not in (0, 1)

    class ZeroRound(bt.DeterministicTranscript):
        def round_challenge(self, curve=None, L=None, R=None):
            return curve.fn.p

    with pytest.raises(bt.VerificationError):
        replay_batch(c, N, 2, [ZeroRound(2)])


# -- proofs ----------------------------------------------------------------


def witnesses(m, count, seed, order):
    """count lists of m (v, γ) pairs from a numpy seed, γ below the group order."""
    rng = np.random.default_rng(seed)
    return [[(int(rng.integers(0, 1 << N)), int.from_bytes(rng.bytes(32), "little") % order)
             for _ in range(m)] for _ in range(count)]


class GoldenFs256:
    """The JAX package's host twin driven by golden's prover. Golden asks
    for y and z without arguments, so the adapter absorbs the statement
    itself: the commitments and A = h·α + Σ (bit ? G : −H), computed as
    golden computes it."""

    def __init__(self, jc, twin, gpk, gc, row, m):
        self.jc, self.twin = jc, twin
        bits = protocol._bit_decompose([v for v, _ in row], N, m)
        self.V = [gc.add(gc.mul(gpk.g, v), gc.mul(gpk.h, g)) for v, g in row]
        self.A = gc.sum([gc.mul(gpk.h, GoldenDR(m).alpha())]
                        + [gpk.G_vec[i] if b else gc.neg(gpk.H_vec[i])
                           for i, b in enumerate(bits)])

    def challenge_yz(self):
        return self.twin.challenge_yz(self.jc, self.V, self.A)

    def round_challenge(self, L, R):
        return self.twin.round_challenge(self.jc, L, R)

    def final_challenge(self, A, B):
        return self.twin.final_challenge(self.jc, A, B)


def golden_fs256(name, m, rows, twins):
    """Wire bytes of golden's proofs of `rows` under the JAX twins `twins`."""
    jc, gc = jax_curve_ops(name), CURVES[name]
    gpk = GoldenPublicKey.new(gc, N * m)
    out = []
    for row, twin in zip(rows, twins):
        gp = GoldenRangeProver()
        for v, g in row:
            gp.commit(gc, gpk, v, g)
        t = GoldenFs256(jc, twin, gpk, gc, row, m)
        assert t.V == list(gp.commitment_vec)
        proof = protocol.prove(gc, gpk, N, gp, t, GoldenDR(m))
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


# (curve, m) → K: batch_prove at m = 2, `prove` (K = 1) at m = 1
CASES = [("edwards25519", 2), ("edwards25519", 1), ("secp256k1", 2), ("secp256k1", 1),
         ("bls12_381", 2)]
_PROVEN: dict = {}


def proven(name, m):
    """(pk, provers, proofs (ProofBatch), transcripts, rows), proven once
    per module with Fs256Transcript and DeterministicRng."""
    if (name, m) not in _PROVEN:
        c, gc = bt.curve_ops(name), CURVES[name]
        rows = witnesses(m, K if m > 1 else 1, 30 + m, gc.fn.p)
        pk = bt.PublicKey.new(c, N * m, CPU)
        provers = port_provers(pk, rows)
        trs = [bt.Fs256Transcript(m) for _ in rows]
        if m > 1:
            batch = bt.batch_prove(c, pk, N, provers, trs, [bt.DeterministicRng(m)] * K)
        else:
            batch = bt.ProofBatch.from_proofs(
                [bt.prove(c, pk, N, provers[0], trs[0], bt.DeterministicRng(1))])
        _PROVEN[name, m] = pk, provers, batch, trs, rows
    return _PROVEN[name, m]


@pytest.mark.parametrize("name,m", CASES, ids=[f"{n}-m{m}" for n, m in CASES])
def test_fs256_prove_matches_golden_under_the_jax_twin(name, m):
    """Proof bytes, and each transcript's final state and counter, equal
    golden's proofs under fresh JAX twins; the batch verifies by default (on
    the device replay) and a tampered r′ rejects."""
    c = bt.curve_ops(name)
    pk, provers, batch, trs, rows = proven(name, m)
    twins = [JaxFs256(m) for _ in rows]
    want = golden_fs256(name, m, rows, twins)
    assert [serialize.proof_to_bytes(c, batch[k]) for k in range(len(rows))] == want
    logn = (N * m).bit_length() - 1
    for t, twin in zip(trs, twins):
        assert np.array_equal(t.state_words(), twin.state_words())
        assert t._counter == twin._counter == logn + 3
    V = bt.stack_commitments(c, [p.commitment_vec for p in provers])
    bt.batch_verify(c, pk, N, batch, V)
    bad = batch.take(slice(None))
    bad.r_prime = bad.r_prime.clone()
    bad.r_prime[-1] = c.fn.add(bad.r_prime[-1], c.fn.one(CPU))
    with pytest.raises(bt.VerificationError):
        bt.batch_verify(c, pk, N, bad, V)


@pytest.mark.parametrize("m", [1, 2])
def test_fs256_prove_matches_jax_prove(m):
    """JAX `prove` of the first statement under a JAX Fs256Transcript, on
    edwards25519: the same bytes, final state and counter as the port's."""
    name = "edwards25519"
    c, jc = bt.curve_ops(name), jax_curve_ops(name)
    _, _, batch, trs, rows = proven(name, m)
    jpk = JaxPublicKey.new(jc, N * m)
    jp = JaxRangeProver()
    for v, g in rows[0]:
        jp.commit(jpk, v, g)
    twin = JaxFs256(m)
    want = jax_serialize.proof_to_bytes(jc, jax_prove(jc, jpk, N, jp, twin, JaxDR(m)))
    assert serialize.proof_to_bytes(c, batch[0]) == want
    assert np.array_equal(trs[0].state_words(), twin.state_words())
    assert trs[0]._counter == twin._counter


def test_fs256_replay_matches_jax_and_host_twins():
    """The device replay of the m = 2 edwards25519 batch against JAX
    fs256_replay on the same points, the port's host replay (replay_batch)
    and the JAX host twin; the verifier defaults to the device replay."""
    name, m = "edwards25519", 2
    c, jc = bt.curve_ops(name), jax_curve_ops(name)
    fn = c.fn
    _, provers, batch, _, _ = proven(name, m)
    V = bt.stack_commitments(c, [p.commitment_vec for p in provers])
    y, z, es, ef = fs256.fs256_replay(c, m, V, batch.A, batch.L_vec, batch.R_vec,
                                      batch.A_wip, batch.B)
    got = (fn.decode(y), fn.decode(z), fn.decode(es), fn.decode(ef))
    ys, zs, ess, efs = replay_batch(c, N, m, [bt.Fs256Transcript(m) for _ in range(K)],
                                    batch, V)
    assert got == (ys, zs, [e for row in ess for e in row], efs)

    def jx(t):
        return jnp.asarray(jc.encode_points(c.decode_points(t))).reshape(
            *t.shape[:-2], jc.COORDS, -1)

    jy, jz, jes, jef = jax_fs256_replay(jc, m, jx(V), jx(batch.A), jx(batch.L_vec),
                                        jx(batch.R_vec), jx(batch.A_wip), jx(batch.B))
    jfn = jc.fn
    assert got == tuple(jfn.decode(np.asarray(t).reshape(-1, np.asarray(t).shape[-1]))
                        for t in (jy, jz, jes, jef))
    for k in range(K):
        twin = JaxFs256(m)
        pts = c.decode_points
        assert twin.challenge_yz(jc, pts(V[k]), pts(batch.A[k])[0]) == (ys[k], zs[k])
        assert [twin.round_challenge(jc, L, R) for L, R in
                zip(pts(batch.L_vec[k]), pts(batch.R_vec[k]))] == ess[k]
        assert twin.final_challenge(jc, pts(batch.A_wip[k])[0], pts(batch.B[k])[0]) == efs[k]


def test_used_transcripts_take_the_host_replay(monkeypatch):
    """Transcripts that already drew a challenge: the prover continues their
    chains on the card (counters offset), the verifier replays on the host
    (the device replay is not called) and accepts, and both end where
    golden's prover under equally used JAX twins ends, byte for byte."""
    name, m = "edwards25519", 1
    c, jc, gc = bt.curve_ops(name), jax_curve_ops(name), CURVES[name]
    pk, provers, _, _, rows = proven(name, m)
    ctx = [gc.mul(gc.base(), 5), None]

    def used(t, curve):
        t.round_challenge(curve, *ctx)
        return t

    tp = used(bt.Fs256Transcript(m), c)
    proof = bt.prove(c, pk, N, provers[0], tp, bt.DeterministicRng(m))
    twin = used(JaxFs256(m), jc)
    assert serialize.proof_to_bytes(c, proof) == golden_fs256(name, m, rows, [twin])[0]
    assert np.array_equal(tp.state_words(), twin.state_words())
    assert tp._counter == twin._counter == 1 + N.bit_length() - 1 + 3

    def no_device_replay(*a):
        raise AssertionError("a used transcript must take the host replay")

    monkeypatch.setattr(batch_mod, "fs256_replay", no_device_replay)
    tv = used(bt.Fs256Transcript(m), c)
    bt.verify(c, proof, pk, N, torch.stack(provers[0].commitment_vec), tv)
    assert np.array_equal(tv.state_words(), tp.state_words())
    with pytest.raises(bt.VerificationError):
        bt.verify(c, proof, pk, N, torch.stack(provers[0].commitment_vec),
                  bt.DeterministicTranscript(m))


def test_verify_defaults_to_the_device_replay(monkeypatch):
    """`verify` and `batch_verify` without transcripts replay fresh fs256
    chains on the card (one call each); a tampered proof rejects."""
    name, m = "edwards25519", 2
    c = bt.curve_ops(name)
    pk, provers, batch, _, _ = proven(name, m)
    V = bt.stack_commitments(c, [p.commitment_vec for p in provers])
    calls = []
    real = batch_mod.fs256_replay
    monkeypatch.setattr(batch_mod, "fs256_replay",
                        lambda *a: calls.append(a[1]) or real(*a))
    bt.verify(c, batch[1], pk, N, V[1])
    bt.batch_verify(c, pk, N, batch, V)
    assert calls == [m, m]
    bad = dataclasses.replace(batch[0], A=batch[1].A)
    with pytest.raises(bt.VerificationError):
        bt.verify(c, bad, pk, N, V[0])
