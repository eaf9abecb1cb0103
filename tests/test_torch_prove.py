"""The port's prover slice against the JAX package and the golden oracle, on
edwards25519, secp256k1 and bls12-381 G1.

Statements sit at n = 8, m ∈ {1, 2}, K = 2, with witnesses from a numpy
seed. The port's K5 plain version must equal the JAX Pallas ladder in
interpret mode and golden scalar multiplication; its bit commitment and
setup programs must equal the JAX package's programs; and its proofs must
be byte-identical to golden `protocol.prove` and JAX `prove` in the
deterministic mode, accepted by the port's `batch_verify` and rejected once
tampered. Every comparison is exact: canonical integers or wire bytes.

JAX `prove` runs eagerly on the CPU and takes about a minute for one
m = 1 statement (more for m = 2), so it is compared once, on the first
statement of the m = 1 batch, on edwards25519 and secp256k1 (at bls12-381's
32 limbs it runs for many minutes); golden, whose bytes the JAX package's
own tests hold equal to JAX's, is compared on every statement of every
curve. Each batch is
proven once per module. `prove` is the K = 1 batch: here its delegation is
checked, and tests/test_torch_cuda.py proves with it on the card."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bulletproofsplus_tpu import serialize as jax_serialize
from bulletproofsplus_tpu.curves import curve_ops as jax_curve_ops
from bulletproofsplus_tpu.curves.pallas_curve import ladder_scalar_mul as jax_ladder
from bulletproofsplus_tpu.golden import CURVES, protocol
from bulletproofsplus_tpu.golden import PublicKey as GoldenPublicKey
from bulletproofsplus_tpu.golden import RangeProver as GoldenRangeProver
from bulletproofsplus_tpu.golden.protocol import DeterministicRng as GoldenDR
from bulletproofsplus_tpu.golden.protocol import DeterministicTranscript as GoldenDT
from bulletproofsplus_tpu.protocol.publickey import PublicKey as JaxPublicKey
from bulletproofsplus_tpu.protocol.range import (
    RangeProof as JaxRangeProof,
    RangeProver as JaxRangeProver,
    _bit_commitment_batch_prog,
    _bit_decompose,
    _prove_setup_multiple_prog,
    _prove_setup_single_prog,
    prove as jax_prove,
)
from bulletproofsplus_tpu.transcript import DeterministicRng as JaxDR
from bulletproofsplus_tpu.transcript import DeterministicTranscript as JaxDT
from bulletproofsplus_tpu.transcript import SystemRng as JaxSystemRng
import bulletproofsplus_tpu_torch as bt
from bulletproofsplus_tpu_torch import convert, serialize
from bulletproofsplus_tpu_torch.curves import CURVE_NAMES
from bulletproofsplus_tpu_torch.curves import cuda_curve as cc
from bulletproofsplus_tpu_torch.errors import InvalidBitsize
from bulletproofsplus_tpu_torch.protocol import batchprove
from bulletproofsplus_tpu_torch.protocol.range import (
    bit_commitment_batched,
    bit_decompose,
    prove_setup_multiple_batched,
    prove_setup_single_batched,
)

# The port's CPU tests run tiny tensors: intra-op threads buy nothing at
# these sizes, and beside other xdist workers they oversubscribe the host (a
# bls12-381 batch prove took 28 s alone and 895 s beside three workers).
torch.set_num_threads(1)

N = 8
K = 2
CPU = "cpu"
# The JAX bit-commitment program (3.5 minutes) and JAX `prove` (longer) run
# too long at bls12-381's 32 limbs on a CPU: that curve meets golden there.
JAX_PROVE_CURVES = ("edwards25519", "secp256k1")
FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "bulletproofsplus_tpu_torch", "data", "ed25519_n64_m16_det.bin")


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


@pytest.fixture(scope="module", params=CURVE_NAMES)
def env(request):
    name = request.param
    return bt.curve_ops(name), jax_curve_ops(name), CURVES[name]


@pytest.fixture(scope="module")
def proven_for(env):
    """m → (m, port pk, port provers, port ProofBatch, golden wire bytes,
    witness rows), each batch proven once for the module."""
    c, jc, gc = env
    cache = {}

    def get(m):
        if m not in cache:
            rows = witnesses(m, 40 + m, gc.fn.p)
            pk = bt.PublicKey.new(c, N * m, CPU)
            provers = port_provers(pk, rows)
            batch = bt.batch_prove(c, pk, N, provers, [bt.DeterministicTranscript(m)] * K,
                                   [bt.DeterministicRng(m)] * K)
            cache[m] = m, pk, provers, batch, golden_wire(jc, gc, m, rows), rows
        return cache[m]

    return get


def witnesses(m, seed, order):
    """K lists of m (v, γ) pairs from a numpy seed, γ below the group order."""
    rng = np.random.default_rng(seed)
    return [[(int(rng.integers(0, 1 << N)), int.from_bytes(rng.bytes(32), "little") % order)
             for _ in range(m)] for _ in range(K)]


def golden_wire(jc, gc, m, rows):
    """Golden deterministic proofs of `rows` as wire bytes."""
    gpk = GoldenPublicKey.new(gc, N * m)
    out = []
    for row in rows:
        gp = GoldenRangeProver()
        for v, g in row:
            gp.commit(gc, gpk, v, g)
        proof = protocol.prove(gc, gpk, N, gp, GoldenDT(m), GoldenDR(m))
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


@pytest.fixture(params=[2, 1], ids=["m2", "m1"])
def proven(request, proven_for):
    return proven_for(request.param)


def test_k5_plain_matches_pallas_ladder():
    """nbits = 16 as tests/test_pallas.py does, two leading axes, a zero
    scalar and the identity point among the lanes. The Weierstrass form
    meets golden instead (test_k5_plain_matches_golden_full_width and
    tests/test_torch_curve_kernels.py::test_plain_kernels_match_golden):
    its interpret-mode Pallas kernels cost minutes each on a CPU."""
    name = "edwards25519"
    c, jc, gc = bt.curve_ops(name), jax_curve_ops(name), CURVES[name]
    rng = np.random.default_rng(5)
    ks = [int(x) for x in rng.integers(0, 1 << 16, size=6)]
    ks[2] = 0
    pts = [gc.mul(gc.base(), 3 + i) for i in range(6)]
    pts[4] = None
    C = c.COORDS
    before = cc.ladder_scalar_mul.launches
    got = cc.ladder_scalar_mul(c, c.fn.encode_plain(ks).reshape(2, 3, 8),
                               c.encode_points(pts).reshape(2, 3, C, 8), 16)
    want = jax_ladder(jc, jnp.asarray(jc.fn.encode_plain(ks)).reshape(2, 3, -1),
                      jnp.asarray(jc.encode_points(pts)).reshape(2, 3, C, -1), 16,
                      interpret=True)
    assert got.shape == (2, 3, C, 8)
    assert c.decode_points(got) == jc.decode_points(want.reshape(6, C, -1))
    assert cc.ladder_scalar_mul.launches == before


def test_k5_plain_matches_golden_full_width(env):
    """Scalars of the group order's width (the bit commitment's: 253 bits on
    edwards25519, 256 on secp256k1, 255 on bls12-381) on a few lanes."""
    c, _, gc = env
    rng = np.random.default_rng(6)
    ks = [int.from_bytes(rng.bytes(32), "little") % gc.fn.p for _ in range(3)]
    pts = [gc.mul(gc.base(), 7 + i) for i in range(3)]
    ks[1] = 0
    pts[2] = None
    got = cc.ladder_scalar_mul(c, c.fn.encode_plain(ks), c.encode_points(pts),
                               c.fn.order_bits)
    assert c.decode_points(got) == [gc.mul(p, k) for k, p in zip(ks, pts)]


@pytest.mark.parametrize("env", JAX_PROVE_CURVES, indirect=True)
@pytest.mark.parametrize("m", [1, 2])
def test_bit_commitment_matches_jax(env, m):
    c, jc, gc = env
    rows = witnesses(m, 10 + m, gc.fn.p)
    bits = np.stack([bit_decompose([v for v, _ in row], N, m) for row in rows])
    for row, b in zip(rows, bits):
        assert (b == _bit_decompose([v for v, _ in row], N, m)).all()
    alphas = [int(x) for x in np.random.default_rng(m).integers(1, 1 << 62, size=K)]
    pk = bt.PublicKey.new(c, N * m, CPU)
    jpk = JaxPublicKey.new(jc, N * m)
    got = bit_commitment_batched(c, c.fn.encode_plain(alphas), torch.from_numpy(bits),
                                 pk.G_vec, pk.H_vec, pk.h)
    want = _bit_commitment_batch_prog(jc)(jnp.asarray(jc.fn.encode_plain(alphas)),
                                          jnp.asarray(bits), jpk.G_vec, jpk.H_vec, jpk.h)
    assert c.decode_points(got) == jc.decode_points(want)


def test_bls12_381_bit_commitment_matches_golden():
    """The bit commitment A_k = h·α_k + Σ_i (bit ? G_i : −H_i) at bls12-381
    (K5 at 255 bits, then K3 over 12-word points) against golden."""
    name, m = "bls12_381", 2
    c, gc = bt.curve_ops(name), CURVES[name]
    rows = witnesses(m, 12, gc.fn.p)
    bits = np.stack([bit_decompose([v for v, _ in row], N, m) for row in rows])
    alphas = [int.from_bytes(np.random.default_rng(k).bytes(32), "little") % gc.fn.p
              for k in range(K)]
    pk = bt.PublicKey.new(c, N * m, CPU)
    got = bit_commitment_batched(c, c.fn.encode_plain(alphas), torch.from_numpy(bits),
                                 pk.G_vec, pk.H_vec, pk.h)
    gpk = GoldenPublicKey.new(gc, N * m)
    want = []
    for alpha, b in zip(alphas, bits):
        acc = gc.mul(gpk.h, alpha)
        for i, bit in enumerate(b):
            acc = gc.add(acc, gpk.G_vec[i] if bit else gc.neg(gpk.H_vec[i]))
        want.append(acc)
    assert c.decode_points(got) == want


@pytest.mark.parametrize("m", [1, 2])
def test_prove_setup_matches_jax(env, m):
    """The setup programs on numpy-seeded challenges, blinds and bits, against
    the JAX programs vmapped over K as batchprove.py:59-72 does."""
    c, jc, _ = env
    fn, jfn = c.fn, jc.fn
    rng = np.random.default_rng(20 + m)

    def ints(count):
        return [int.from_bytes(rng.bytes(40), "little") % fn.p for _ in range(count)]

    ys, zs, alphas, gammas = ints(K), ints(K), ints(K), ints(K * m)
    bits = rng.integers(0, 2, size=(K, N * m)).astype(bool)
    port_gamma = fn.encode(gammas).reshape(K, m, 8)
    jax_gamma = jnp.asarray(jfn.encode(gammas)).reshape(K, m, -1)
    if m == 1:
        got = prove_setup_single_batched(fn, N, fn.encode(ys), fn.encode(zs),
                                         torch.from_numpy(bits), port_gamma[:, 0],
                                         fn.encode(alphas))
        prog, jax_gamma = _prove_setup_single_prog(jc, N), jax_gamma[:, 0]
    else:
        got = prove_setup_multiple_batched(fn, N, m, fn.encode(ys), fn.encode(zs),
                                           torch.from_numpy(bits), port_gamma,
                                           fn.encode(alphas))
        prog = _prove_setup_multiple_prog(jc, N, m)
    want = jax.vmap(prog, in_axes=(0, 0, 0, 0, 0, None, None, None, None, None))(
        jnp.asarray(jfn.encode(ys)), jnp.asarray(jfn.encode(zs)), jnp.asarray(bits),
        jax_gamma, jnp.asarray(jfn.encode(alphas)), None, None, None, None, None)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert fn.decode(g) == jfn.decode(w.reshape(-1, w.shape[-1]))


def test_batch_prove_matches_golden(env, proven):
    c = env[0]
    m, pk, provers, batch, wire, _ = proven
    assert [serialize.proof_to_bytes(c, batch[k]) for k in range(K)] == wire
    assert batch.A.device.type == CPU and batch.rounds == (N * m).bit_length() - 1


def test_batch_verify_accepts_proven_batch(env, proven):
    c = env[0]
    m, pk, provers, batch, _, _ = proven
    V = bt.stack_commitments(c, [p.commitment_vec for p in provers])
    trs = [bt.DeterministicTranscript(m)] * K
    bt.batch_verify(c, pk, N, batch, V, trs)
    bad = batch.take(slice(None))
    bad.d_prime = bad.d_prime.clone()
    bad.d_prime[1] = c.fn.add(bad.d_prime[1], c.fn.one(CPU))
    with pytest.raises(bt.VerificationError):
        bt.batch_verify(c, pk, N, bad, V, trs)


@pytest.mark.parametrize("env", JAX_PROVE_CURVES, indirect=True)
def test_prove_matches_jax_and_golden(env, proven_for, monkeypatch):
    """JAX `prove` of the m = 1 batch's first statement: port bytes == JAX
    bytes == golden bytes, and the port's single `verify` accepts the port's
    proof. `prove` hands its statement to `batch_prove` as a batch of one."""
    c, jc, _ = env
    m, pk, provers, batch, wire, rows = proven_for(1)
    jpk = JaxPublicKey.new(jc, N)
    jp = JaxRangeProver()
    for v, g in rows[0]:
        jp.commit(jpk, v, g)
    want = jax_serialize.proof_to_bytes(jc, jax_prove(jc, jpk, N, jp, JaxDT(1), JaxDR(1)))
    assert serialize.proof_to_bytes(c, batch[0]) == want == wire[0]
    bt.verify(c, batch[0], pk, N, torch.stack(provers[0].commitment_vec),
              bt.DeterministicTranscript(1))

    seen = []
    monkeypatch.setattr(batchprove, "batch_prove", lambda *a: seen.append(a) or ["proof"])
    t, r = bt.DeterministicTranscript(1), bt.DeterministicRng(1)
    assert bt.prove(c, pk, N, provers[0], t, r) == "proof"
    ((curve, key, n, ps, ts, rs),) = seen
    assert curve is c and key is pk and n == N
    assert len(ps) == len(ts) == len(rs) == 1
    assert ps[0] is provers[0] and ts[0] is t and rs[0] is r


def test_mixed_aggregation_proves_each_alone(monkeypatch):
    """A batch mixing m proves each statement as its own K = 1 call and
    returns a list (batchprove.py:148-154)."""
    c = bt.curve_ops("edwards25519")
    pk = bt.PublicKey.new(c, 16, CPU)
    provers = port_provers(pk, [[(1, 2)], [(3, 4), (5, 6)]])
    seen = []
    monkeypatch.setattr(batchprove, "prove",
                        lambda curve, pk, n, p, t, r: seen.append((len(p.v_vec), t, r)) or p)
    trs, rngs = ["t0", "t1"], ["r0", "r1"]
    assert bt.batch_prove(c, pk, N, provers, trs, rngs) == provers
    assert seen == [(1, "t0", "r0"), (2, "t1", "r1")]


def test_batch_prove_argument_errors(monkeypatch):
    """Argument errors; without transcripts the prover draws fresh fs256
    challenges on the card (the default, as in the JAX package), and a
    transcript that is neither known ahead nor fs256 takes the interactive
    fold (host challenges a round)."""
    c = bt.curve_ops("edwards25519")
    pk = bt.PublicKey.new(c, 16, CPU)
    provers = port_provers(pk, [[(1, 2), (3, 4)]])
    assert bt.batch_prove(c, pk, N, []) == []

    class Fs256Statement(Exception):
        pass

    def absorb(curve, state, base, step, pts):
        assert step.absorb == b"stmt" and pts.shape[:2] == (1, 3) and base is None
        assert torch.equal(state[0], torch.from_numpy(
            bt.Fs256Transcript(2).state_words().view(np.int32)))
        raise Fs256Statement

    monkeypatch.setattr(batchprove, "absorb_and_draw", absorb)
    with pytest.raises(Fs256Statement):
        bt.batch_prove(c, pk, N, provers)
    with pytest.raises(Fs256Statement):
        bt.prove(c, pk, N, provers[0])

    class Interactive(bt.DeterministicTranscript):
        challenges_known_ahead = False

    class InteractiveFold(Exception):
        pass

    def interactive_fold(curve, transcripts, *tensors):
        assert curve is c and len(transcripts) == 1 and isinstance(transcripts[0], Interactive)
        raise InteractiveFold

    monkeypatch.setattr(batchprove, "wip_prove_interactive_batched", interactive_fold)
    with pytest.raises(InteractiveFold):
        bt.batch_prove(c, pk, N, provers, [Interactive(2)])
    with pytest.raises(InvalidBitsize):
        bt.batch_prove(c, pk, 12, provers, [bt.DeterministicTranscript(2)])


def test_rngs_match_jax():
    fl = CURVES["edwards25519"].fn.p
    for m in (1, 2):
        mine, ref = bt.DeterministicRng(m), JaxDR(m)
        assert (mine.alpha(), mine.round_blinds(), mine.final_blinds()) == (
            ref.alpha(), ref.round_blinds(), ref.final_blinds())
        assert mine.blinds_known_ahead and bt.DeterministicTranscript(m).challenges_known_ahead
    mine, ref = bt.SystemRng(fl), JaxSystemRng(fl)
    draws = [mine.alpha(), *mine.round_blinds(), *mine.final_blinds()]
    assert len(draws) == 7 and all(1 <= x < fl for x in draws)
    assert len(set(draws)) == 7 and ref.order == mine.order


def test_commit_and_range_prover_from_jax(env):
    """RangeProver.commit against JAX pk.commitment, and the JAX witness
    container carried over by convert.range_prover_from_jax."""
    c, jc, gc = env
    pk = bt.PublicKey.new(c, 16, CPU)
    jpk = JaxPublicKey.new(jc, 16)
    pairs = [(0, 1), (5, 0), ((1 << 64) - 1, gc.fn.p - 1)]
    mine, ref = bt.RangeProver(), JaxRangeProver()
    for v, g in pairs:
        mine.commit(pk, v, g)
        ref.commit(jpk, v, g)
    assert c.decode_points(torch.stack(mine.commitment_vec)) == jc.decode_points(
        jnp.stack(ref.commitment_vec))
    got = convert.range_prover_from_jax(ref, c, CPU)
    assert (got.v_vec, got.gamma_vec) == (mine.v_vec, mine.gamma_vec)
    assert torch.equal(torch.stack(got.commitment_vec), torch.stack(mine.commitment_vec))
    assert dataclasses.is_dataclass(got) and mine.commitment_vec[0].device.type == CPU


def test_entry_points_run_on_the_card_unless_asked():
    """Without a device the entry points place tensors on the CUDA card; on
    a machine without one they raise instead of falling back to the CPU."""
    c = bt.curve_ops()
    with open(FIXTURE, "rb") as f:
        wire = serialize.read_fixture(f.read())[3][0][1]
    jarr = np.zeros((1, 4, 22), np.int32)
    calls = [lambda: bt.PublicKey.new(c, 8).g, lambda: serialize.proof_from_bytes(c, wire).A,
             lambda: convert.points_from_jax(jarr, c)]
    for f in calls:
        if torch.cuda.is_available():
            assert f().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                f()
    pk = bt.PublicKey.new(c, 8, CPU)
    assert pk.G_vec.device.type == CPU and pk.commitment(1, 2).device.type == CPU
    assert serialize.proof_from_bytes(c, wire, CPU).A.device.type == CPU
