"""The port's verifier slice against the JAX package and the golden oracle, on
edwards25519, secp256k1 and bls12-381 G1.

Statements are golden-made deterministic-mode proofs at n = 8, m = 2 and
m = 1 (K = 2). The port's exponent vectors must equal the JAX package's
exponent programs on the same (numpy-seeded) challenges, and the port must
accept and reject exactly what golden `protocol.verify` and JAX
`batch_verify` accept and reject. Comparisons are exact: canonical integers,
tensors of the port's own layout, or accept/reject polarity."""
import dataclasses
import functools
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
from bulletproofsplus_tpu_torch.curves import CURVE_NAMES
from bulletproofsplus_tpu_torch.errors import FormatError
from bulletproofsplus_tpu_torch.protocol.range import (
    vinputs_multiple_batched,
    vinputs_single_batched,
)

# The port's CPU tests run tiny tensors: intra-op threads buy nothing at
# these sizes, and beside other xdist workers they oversubscribe the host (a
# bls12-381 batch prove took 28 s alone and 895 s beside three workers).
torch.set_num_threads(1)

N = 8
K = 2
DATA = "bulletproofsplus_tpu_torch/data/"
# JAX batch_verify compiles for over ten minutes at bls12-381's 32 limbs on
# a CPU, so that curve's polarity meets golden only
# (test_batch_verify_polarity_matches_golden).
JAX_VERIFY_CURVES = ("edwards25519", "secp256k1")


@pytest.fixture(autouse=True)
def release_jax_executables():
    """Drop the JAX package's compiled programs after each test. Each
    XLA:CPU executable holds about a dozen memory maps while a jit cache
    keeps it, and one process running this file's JAX references passes the
    kernel's default limit of 65,530 maps (vm.max_map_count) and crashes
    inside XLA. The persistent compilation cache reloads what a later test
    needs."""
    yield
    jax.clear_caches()


def weights(seed):
    rnd = random.Random(seed)
    return lambda: rnd.getrandbits(128)


@functools.lru_cache(maxsize=None)
def port_pk(name):
    """One CPU key of 64 generators per curve, longer than every n·m here:
    verification takes its prefix, and the prefixes share the key's
    fixed-base tables, so each (curve, n·m) builds its tables once."""
    return bt.PublicKey.new(bt.curve_ops(name), 64, "cpu")


@pytest.fixture(scope="module", params=CURVE_NAMES)
def env(request):
    name = request.param
    return bt.curve_ops(name), jax_curve_ops(name), CURVES[name]


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
    V = torch.stack([c.encode_points(comms, "cpu") for _, comms, _ in stmts])
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
    port_in[2] = port_in[2].reshape(K, logn, fn.L)
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
    pk = port_pk(c.name)
    for tamper in (False, True):
        assert port_accepts(c, pk, stmts, m, tamper) is not tamper
        assert golden_accepts(gc, gpk, stmts, tamper) is not tamper


@pytest.mark.parametrize("env", JAX_VERIFY_CURVES, indirect=True)
def test_batch_verify_polarity_matches_jax(env, statements, jax_polarity):
    c = env[0]
    pk = port_pk(c.name)
    mine = tuple(port_accepts(c, pk, statements[2][1], 2, tamper)
                 for tamper in (False, True))
    assert mine == jax_polarity == (True, False)


@pytest.mark.parametrize("m", [2, 1])
def test_single_verify_matches_golden(env, statements, m):
    c = env[0]
    _, stmts = statements[m]
    pk = port_pk(c.name)                 # longer than n·m: verify uses the prefix
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


@pytest.fixture(scope="module")
def ed_statements():
    """The m = 2 edwards25519 statements, for the tests that do not depend
    on the curve."""
    name = "edwards25519"
    return bt.curve_ops(name), _statements(CURVES[name], jax_curve_ops(name), 2)[1]


def test_batch_verify_argument_errors(ed_statements, monkeypatch):
    """Argument errors; without transcripts the verifier replays fresh fs256
    chains on the card (the default, as in the JAX package), and a
    transcript that is neither known ahead nor fs256 takes the host replay
    (range.replay_batch, which decodes the proofs' points)."""
    from bulletproofsplus_tpu_torch.protocol import batch as batch_mod

    c, stmts = ed_statements
    batch, V = port_batch(c, stmts)
    pk = port_pk(c.name)
    with pytest.raises(bt.VerificationError):
        bt.batch_verify(c, pk, N, batch, V[:1], [bt.DeterministicTranscript(2)] * K)

    class Fs256Replay(Exception):
        pass

    def replay(curve, m, *tensors):
        assert curve is c and m == 2 and tensors[0] is V
        raise Fs256Replay

    monkeypatch.setattr(batch_mod, "fs256_replay", replay)
    with pytest.raises(Fs256Replay):
        bt.batch_verify(c, pk, N, batch, V)

    class Interactive(bt.DeterministicTranscript):
        challenges_known_ahead = False

    class HostReplay(Exception):
        pass

    def host_replay(curve, n, m, transcripts, b, V_all):
        assert b is batch and V_all is V and len(transcripts) == K
        raise HostReplay

    monkeypatch.setattr(batch_mod, "replay_batch", host_replay)
    with pytest.raises(HostReplay):
        bt.batch_verify(c, pk, N, batch, V, [Interactive(2)] * K)
    with pytest.raises(bt.VerificationError):   # n·m does not match the rounds
        bt.batch_verify(c, pk, 16, batch, V, [bt.DeterministicTranscript(2)] * K)
    bt.batch_verify(c, pk, N, batch.take(slice(0, 0)), V[:0], [])


def test_point_decoding_rejects_torsion_and_off_curve():
    c = bt.curve_ops("edwards25519")
    p = 2**255 - 19
    order2 = (p - 1).to_bytes(32, "little")          # (0, -1): order 2
    with pytest.raises(FormatError):
        serialize.point_from_bytes(c, order2)
    with pytest.raises(FormatError):                 # y = 2 has no x on the curve
        serialize.point_from_bytes(c, (2).to_bytes(32, "little"))
    assert serialize.point_from_bytes(c, serialize.point_bytes(c, None)) is None


def test_secp256k1_point_encoding_matches_jax():
    """SEC1 compressed points: the round trip and the JAX package's bytes,
    the identity as 0x00 ‖ 32 zero bytes, and rejection of the 0x04 prefix,
    x ≥ p, an x whose x³ + 7 is not a square, and a 0x00 prefix with
    nonzero bytes."""
    c, jc, gc = bt.curve_ops("secp256k1"), jax_curve_ops("secp256k1"), CURVES["secp256k1"]
    pts = [gc.mul(gc.base(), k) for k in (1, 2, 3, 5, 1 << 200)] + [None]
    for A in pts:
        enc = serialize.point_bytes(c, A)
        assert enc == jax_serialize.point_bytes(jc, A) and len(enc) == 33
        assert serialize.point_from_bytes(c, enc) == A
    assert serialize.point_bytes(c, None) == bytes(33)
    p = gc.fp.p
    x = pts[0][0].to_bytes(32, "big")
    nonres = next(v for v in range(1, 100) if pow(v**3 + 7, (p - 1) // 2, p) != 1)
    bad = [b"\x04" + x, b"\x02" + p.to_bytes(32, "big"),
           b"\x03" + ((1 << 256) - 1).to_bytes(32, "big"),
           b"\x02" + nonres.to_bytes(32, "big"), b"\x00" + bytes(31) + b"\x01",
           b"\x02" + x[:31]]
    for data in bad:
        with pytest.raises(FormatError):
            serialize.point_from_bytes(c, data)
        with pytest.raises(Exception):
            jax_serialize.point_from_bytes(jc, data)


def test_bls12_381_point_encoding_matches_jax():
    """49-byte compressed G1 points: the round trip and the JAX package's
    bytes, the identity as 0x00 ‖ 48 zero bytes, and rejection of the 0x04
    prefix, x ≥ p, an x whose x³ + 4 is not a square, a 0x00 prefix with
    nonzero bytes, a short encoding, and a point of the curve outside the
    prime-order subgroup (cofactor 0x396C8C005555E1568C00AAAB0000AAAB)."""
    c, jc, gc = bt.curve_ops("bls12_381"), jax_curve_ops("bls12_381"), CURVES["bls12_381"]
    pts = [gc.mul(gc.base(), k) for k in (1, 2, 3, 5, 1 << 200)] + [None]
    for A in pts:
        enc = serialize.point_bytes(c, A)
        assert enc == jax_serialize.point_bytes(jc, A) and len(enc) == 49
        assert serialize.point_from_bytes(c, enc) == A
    assert serialize.point_bytes(c, None) == bytes(49) and serialize.point_len(c) == 49
    p = gc.fp.p
    x = pts[0][0].to_bytes(48, "big")
    residue = [pow(v**3 + 4, (p - 1) // 2, p) == 1 for v in range(1, 100)]
    nonres = 1 + residue.index(False)
    xt = 1 + residue.index(True)                   # (xt, y) lies on the curve
    yt = c.host.sqrt(xt**3 + 4)
    assert not c.host.in_subgroup((xt, yt)) and c.host.in_subgroup(pts[4])
    assert not jax_serialize.in_subgroup(jc, (xt, yt))
    bad = [b"\x04" + x, b"\x02" + p.to_bytes(48, "big"),
           b"\x03" + ((1 << 384) - 1).to_bytes(48, "big"),
           b"\x02" + nonres.to_bytes(48, "big"), b"\x00" + bytes(47) + b"\x01",
           b"\x02" + x[:47], b"\x02" + xt.to_bytes(48, "big")]
    for data in bad:
        with pytest.raises(FormatError):
            serialize.point_from_bytes(c, data)
        with pytest.raises(Exception):
            jax_serialize.point_from_bytes(jc, data)


@pytest.mark.parametrize("curve,name,shape,rounds", [
    ("edwards25519", "ed25519_n64_m16_det.bin", (64, 16, 16), 10),
    ("secp256k1", "secp256k1_n64_m64_det.bin", (64, 64, 8), 12),
    ("bls12_381", "bls12_381_n64_m256_det.bin", (64, 256, 4), 14)])
def test_committed_fixture_decodes(curve, name, shape, rounds):
    """The card's statements: 16 golden proofs at n = 64, m = 16
    (edwards25519, format BPPF1), 8 at n = 64, m = 64 (secp256k1, BPPF2)
    and 4 at n = 64, m = 256 (bls12-381, BPPF2, 49-byte points), each
    decoded by the port (every bls12-381 point subgroup-checked) and
    re-encoded to the same bytes."""
    c = bt.curve_ops(curve)
    with open(DATA + name, "rb") as f:
        got_curve, n, m, rows = serialize.read_fixture(f.read())
    assert got_curve == curve and (n, m, len(rows)) == shape
    comms, wire = rows[0]
    proof = serialize.proof_from_bytes(c, wire, "cpu")
    assert proof.proof.rounds == rounds
    V = serialize.points_from_bytes(c, comms)
    assert len(V) == m and all(A is not None for A in V)
    assert b"".join(serialize.point_bytes(c, A) for A in V) == comms
    assert serialize.proof_to_bytes(c, proof) == wire


def test_fixture_formats_reject_garbage():
    with pytest.raises(FormatError):
        serialize.read_fixture(b"BPPF3" + bytes(10))
    name = b"secp256k1"
    head = b"BPPF2" + bytes([len(name)]) + name + (8).to_bytes(2, "big") * 2
    assert serialize.read_fixture(head + bytes(2)) == ("secp256k1", 8, 8, [])
    with pytest.raises(FormatError):
        serialize.read_fixture(head + bytes(3))
    with pytest.raises(FormatError):
        serialize.read_fixture(head[:-1])


class _ZeroRoundTranscript(bt.DeterministicTranscript):
    def round_challenge(self, curve=None, L=None, R=None) -> int:
        return 0


def test_zero_challenge_rejected_by_replay(ed_statements):
    """The host replay rejects a zero challenge (range.py:392)."""
    c, stmts = ed_statements
    batch, V = port_batch(c, stmts)
    pk = port_pk(c.name)
    with pytest.raises(bt.VerificationError):
        bt.batch_verify(c, pk, N, batch, V, [_ZeroRoundTranscript(2)] * K)
