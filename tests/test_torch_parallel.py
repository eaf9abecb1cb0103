"""The port's distribution layer (bulletproofsplus_tpu_torch/parallel/)
against the JAX package and golden, on meshes that list the CPU several
times, as the conftest's eight virtual CPU devices stand in for chips.

Inputs come from numpy seeds; comparisons are exact (affine integers, wire
bytes, accept/reject). Where a JAX reference costs minutes of XLA:CPU
compile, golden stands in for it, as the JAX package's own tests hold the
JAX function against golden: JAX `sharded_msm` compiles for about 55 s a
mesh on XLA:CPU, so one mesh meets it and every mesh meets golden `msm`;
JAX `sharded_prove` compiled for more than seven minutes at n = 8, m = 1 on
two devices without finishing, so the sharded prover meets golden's bytes
(which JAX `prove` equals, tests/test_torch_prove.py) and JAX's argument
errors. Every kernel runs its plain PyTorch version here, one launch set a
shard, so a shard costs about what a whole MSM does."""
import dataclasses

import jax
import jax.numpy as jnp
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
from bulletproofsplus_tpu.parallel import default_mesh as jax_default_mesh
from bulletproofsplus_tpu.parallel import sharded_msm as jax_sharded_msm
from bulletproofsplus_tpu.parallel import sharded_prove as jax_sharded_prove
from bulletproofsplus_tpu.protocol.publickey import PublicKey as JaxPublicKey
from bulletproofsplus_tpu.protocol.range import RangeProof as JaxRangeProof
from bulletproofsplus_tpu.protocol.range import RangeProver as JaxRangeProver
from bulletproofsplus_tpu.transcript import DeterministicTranscript as JaxDT
from bulletproofsplus_tpu.transcript import Fs256Transcript as JaxFs256
from bulletproofsplus_tpu.transcript import ShaTranscript as JaxSha
import bulletproofsplus_tpu_torch as bt
from bulletproofsplus_tpu_torch import serialize
from bulletproofsplus_tpu_torch.msm import msm
from bulletproofsplus_tpu_torch.msm.fixed import precompute_slice_tables, precompute_tables
from bulletproofsplus_tpu_torch.parallel import (
    default_mesh,
    distributed_barrier,
    global_mesh,
    sharded_fixed_msm,
    sharded_msm,
    sharded_msm_rows,
    sharded_prove,
    warmup_collectives,
)
from bulletproofsplus_tpu_torch.parallel import mesh as mesh_mod
from bulletproofsplus_tpu_torch.protocol import batch as batch_mod

torch.set_num_threads(1)

CPU = "cpu"
N, M = 8, 2


@pytest.fixture(autouse=True)
def release_jax_executables():
    """Drop the JAX package's compiled programs after each test, as the
    other port test files do."""
    yield
    jax.clear_caches()


def cpu_mesh(n_devices, dp=1):
    return default_mesh(n_devices, dp=dp, devices=[CPU] * n_devices)


def random_pairs(name, count, seed):
    """count golden points (multiples of the base) and scalars below the
    group order, from a numpy seed."""
    gc = CURVES[name]
    rng = np.random.default_rng(seed)
    ks = [int.from_bytes(rng.bytes(32), "little") % gc.fn.p for _ in range(2 * count)]
    pts = [gc.mul(gc.base(), 1 + k) for k in ks[:count]]
    return pts, ks[count:]


# -- the mesh ------------------------------------------------------------------


def test_default_mesh_shapes_and_errors(monkeypatch):
    """(dp, tp) shapes as JAX default_mesh gives them; dp must divide the
    device count; a mesh of more devices than listed raises; on the card a
    mesh takes distinct cards and raises when there are too few, and with
    no card it raises instead of moving to the CPU."""
    m = cpu_mesh(8, dp=2)
    assert m.shape == dict(jax_default_mesh(8, dp=2).shape) == {"dp": 2, "tp": 4}
    assert m.devices == ((torch.device(CPU),) * 4,) * 2 and m.distinct_devices() == 1
    assert cpu_mesh(2).shape == {"dp": 1, "tp": 2}
    with pytest.raises(ValueError):
        cpu_mesh(6, dp=4)
    with pytest.raises(ValueError):
        default_mesh(4, devices=[CPU] * 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        default_mesh(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="distinct"):
        default_mesh(2)
    one = default_mesh(1)
    assert one.devices == ((torch.device("cuda", 0),),)


def test_global_mesh_keeps_rows_in_their_process(monkeypatch):
    """One process: every row is local. As rank 1 of 2 processes with two
    devices each: dp defaults to 2, this process drives row 1; dp not a
    multiple of the process count raises (JAX global_mesh's rule); the
    collectives' warm-up and the barrier are no-ops in one process."""
    g = global_mesh(devices=[CPU] * 4)
    assert g.shape == {"dp": 1, "tp": 4} and (g.row0, g.world) == (0, 1)
    warmup_collectives(g)
    distributed_barrier("test")
    assert global_mesh(dp=2, devices=[CPU] * 4).shape == {"dp": 2, "tp": 2}
    monkeypatch.setattr(mesh_mod, "_world", lambda: (2, 1))
    g = global_mesh(devices=[CPU] * 2)
    assert g.shape == {"dp": 2, "tp": 2} and (g.row0, g.world) == (1, 2)
    assert len(g.devices) == 1 and g.local().shape == {"dp": 1, "tp": 2}
    assert global_mesh(dp=4, devices=[CPU] * 2).shape == {"dp": 4, "tp": 1}
    with pytest.raises(ValueError, match="multiple of process_count"):
        global_mesh(dp=1, devices=[CPU] * 2)
    with pytest.raises(ValueError):
        g.axis_devices("dp")


# -- sharded MSMs ----------------------------------------------------------------

MSM_CASES = [(name, tp) for name in ("edwards25519", "secp256k1") for tp in (1, 2, 8)]


@pytest.mark.parametrize("name,tp", MSM_CASES, ids=[f"{n}-tp{t}" for n, t in MSM_CASES])
def test_sharded_msm_matches_msm_and_jax(name, tp):
    """N = 37 pairs (not a multiple of the mesh) over 1, 2 and 8 devices:
    the port's sharded_msm equals its msm and golden's; on edwards25519 over
    eight devices (the JAX package's own case, test_parallel.py:21-34) also
    JAX sharded_msm on the same inputs."""
    c, gc = bt.curve_ops(name), CURVES[name]
    pts, ks = random_pairs(name, 37, seed=tp)
    P = c.encode_points(pts, CPU)
    s = c.fn.encode_plain(ks, CPU)
    got = c.decode_point(sharded_msm(c, s, P, cpu_mesh(tp)))
    assert got == c.decode_point(msm(c, s, P)) == gc.msm(ks, pts)
    if (name, tp) == ("edwards25519", 8):
        jc = jax_curve_ops(name)
        ref = jax_sharded_msm(jc, jnp.asarray(jc.fn.encode_plain(ks)),
                              jnp.asarray(jc.encode_points(pts)), jax_default_mesh(8, dp=1))
        assert got == jc.decode_point(ref)


def test_sharded_msm_rows_pads_a_row():
    """B = 3 MSMs over a 2 × 4 mesh: row b on mesh row b mod 2, the third
    a padded row's partner; each equals its own msm and golden's."""
    name = "edwards25519"
    c, gc = bt.curve_ops(name), CURVES[name]
    pts, ks = random_pairs(name, 3 * 13, seed=21)
    P = c.encode_points(pts, CPU).reshape(3, 13, *c.identity(CPU).shape)
    s = c.fn.encode_plain(ks, CPU).reshape(3, 13, c.fn.L)
    got = c.decode_points(sharded_msm_rows(c, s, P, cpu_mesh(8, dp=2)))
    assert got == c.decode_points(msm(c, s, P))
    assert got == [gc.msm(ks[13 * b:13 * (b + 1)], pts[13 * b:13 * (b + 1)]) for b in range(3)]


def test_sharded_fixed_msm_matches_plain():
    """N = 16 generators over 8 devices (test_parallel.py:37-52): each
    device's table is the one precompute_tables builds from its slice
    alone, and the sum equals golden's msm; an axis that does not divide N
    raises."""
    name = "edwards25519"
    c, gc = bt.curve_ops(name), CURVES[name]
    pts, ks = random_pairs(name, 16, seed=11)
    P = c.encode_points(pts, CPU)
    s = c.fn.encode_plain(ks, CPU)
    mesh = cpu_mesh(8)
    tables = precompute_slice_tables(c, P, mesh.devices[0], list(range(8)))
    assert torch.equal(tables[5], precompute_tables(c, P[10:12]))
    assert c.decode_point(sharded_fixed_msm(c, s, tables, mesh)) == gc.msm(ks, pts)
    with pytest.raises(ValueError):
        sharded_fixed_msm(c, s[:15], tables, mesh)


# -- batch verification over a mesh ---------------------------------------------


@pytest.fixture(scope="module")
def proofs():
    """(curve, pk, batch, V, tampered): three golden deterministic-mode
    proofs at n = 8, m = 2 over the small-multiple key; the tampered copy
    has proof 1's r′ changed."""
    name = "edwards25519"
    c, jc, gc = bt.curve_ops(name), jax_curve_ops(name), CURVES[name]
    gpk = GoldenPublicKey.new(gc, N * M)
    rng = np.random.default_rng(5)
    wires, comms = [], []
    for _ in range(3):
        gp = GoldenRangeProver()
        for _ in range(M):
            gp.commit(gc, gpk, int(rng.integers(0, 1 << N)),
                      int.from_bytes(rng.bytes(32), "little") % gc.fn.p)
        proof = protocol.prove(gc, gpk, N, gp, GoldenDT(M), GoldenDR(M))
        wires.append(jax_serialize.proof_to_bytes(jc, JaxRangeProof.from_golden(jc, proof)))
        comms.append(c.encode_points(gp.commitment_vec, CPU))
    batch = bt.ProofBatch.from_proofs([serialize.proof_from_bytes(c, w, CPU) for w in wires])
    bad = batch.take(slice(None))
    bad.r_prime = bad.r_prime.clone()
    bad.r_prime[1] = c.fn.add(bad.r_prime[1], c.fn.one(CPU))
    return c, bt.PublicKey.new(c, N * M, CPU), batch, torch.stack(comms), bad


def verdict(c, pk, batch, V, mesh):
    try:
        bt.batch_verify(c, pk, N, batch, V, [bt.DeterministicTranscript(M)] * len(batch),
                        mesh=mesh)
        return True
    except bt.VerificationError:
        return False


# case: (devices, dp, K, fixed-base budget, path taken, tables used)
VERIFY_CASES = {
    "1x8-tables": (8, 1, 2, None, "tp", True),
    "1x8-no-tables": (8, 1, 2, "0", "tp", False),
    "2x4-dp": (8, 2, 2, None, "dp", False),
    "2x4-K3-falls-through": (8, 2, 3, None, "tp", True),
}


@pytest.mark.parametrize("case", list(VERIFY_CASES))
def test_batch_verify_over_mesh(case, proofs, monkeypatch):
    """As test_parallel.py:56-137: the batch accepts and the tampered one
    rejects over 1 × 8 with sliced fixed-base tables, over 1 × 8 with
    BPP_FIXED_BASE_MAX_BYTES=0 (every lane on the ladder), over 2 × 4 (the
    dp path: one group a row) and with K = 3 over 2 × 4 (dp does not divide
    K: the tp path over the first row, as batch.py:267-272 falls through)."""
    c, pk, batch, V, bad = proofs
    n_dev, dp, K, budget, path, with_tables = VERIFY_CASES[case]
    if budget is not None:
        monkeypatch.setenv("BPP_FIXED_BASE_MAX_BYTES", budget)
    taken = []
    for name in ("_batch_verify_dp", "_verify_tp"):
        def spy(*a, _f=getattr(batch_mod, name), _n=name):
            taken.append((_n, a[4] if _n == "_verify_tp" else None))
            return _f(*a)
        monkeypatch.setattr(batch_mod, name, spy)
    mesh = cpu_mesh(n_dev, dp=dp)
    assert verdict(c, pk, batch.take(slice(0, K)), V[:K], mesh)
    assert not verdict(c, pk, bad.take(slice(0, K)), V[:K], mesh)
    assert [t[0] for t in taken] == [f"_batch_verify_{path}" if path == "dp"
                                     else "_verify_tp"] * 2
    if path == "tp":
        tables = taken[0][1]
        assert (tables is not None) == with_tables
        if with_tables:
            assert len(tables) == mesh.shape["tp"]


def test_batch_verify_identify_over_mesh(proofs):
    """Bisection over a 1 × 2 mesh names the tampered proof of two."""
    c, pk, _, V, bad = proofs
    assert bt.batch_verify_identify(c, pk, N, bad.take(slice(0, 2)), V[:2],
                                    lambda i: bt.DeterministicTranscript(M),
                                    mesh=cpu_mesh(2)) == [1]


# -- the sharded prover --------------------------------------------------------------

V1, GAMMA1 = 77, 12345          # the m = 1 statement


def golden_bytes(transcript=None):
    """Golden's wire bytes for the m = 1 statement at n = 8 over the
    small-multiple key (deterministic rng; the reference's transcript
    unless one is given)."""
    name = "edwards25519"
    jc, gc = jax_curve_ops(name), CURVES[name]
    gpk = GoldenPublicKey.new(gc, N)
    gp = GoldenRangeProver()
    gp.commit(gc, gpk, V1, GAMMA1)
    t = GoldenDT(1) if transcript is None else transcript(jc, gpk, gc)
    proof = protocol.prove(gc, gpk, N, gp, t, GoldenDR(1))
    return jax_serialize.proof_to_bytes(jc, JaxRangeProof.from_golden(jc, proof))


@pytest.fixture(scope="module")
def single():
    """(system, statement, proof): the facade with mesh_devices=2 on the
    CPU, deterministic mode over the small-multiple key; its proof of the
    m = 1 statement is the port's `prove`."""
    system = bt.RangeProofSystem(bt.Config(curve="edwards25519", n=N, m=1,
                                           mode="deterministic", hash_generators=False,
                                           mesh_devices=2), device=CPU)
    st = system.statement([V1], gammas=[GAMMA1])
    return system, st, system.prove(st)


@pytest.mark.parametrize("tp", [2, 8], ids=["tp2", "mn-equals-P"])
def test_sharded_prove_deterministic_matches_prove_and_golden(tp, single):
    """Deterministic transcript and blinds over 2 devices (two rounds
    sharded, the last on one device) and over 8 = mn (no round sharded:
    the mn = P edge): the bytes equal the port's `prove` and golden's."""
    system, st, proof = single
    c = system.curve
    want = golden_bytes()
    assert serialize.proof_to_bytes(c, proof) == want
    got = sharded_prove(c, system.pk, N, st.prover, cpu_mesh(tp),
                        bt.DeterministicTranscript(1), bt.DeterministicRng(1))
    assert serialize.proof_to_bytes(c, got) == want


class GoldenFs256:
    """The JAX host twin driven by golden's prover (as in
    tests/test_torch_fs256.py): golden asks for y and z without arguments,
    so the adapter absorbs the commitment and A itself."""

    def __init__(self, jc, twin, gpk, gc):
        self.jc, self.twin = jc, twin
        bits = protocol._bit_decompose([V1], N, 1)
        self.V = [gc.add(gc.mul(gpk.g, V1), gc.mul(gpk.h, GAMMA1))]
        self.A = gc.sum([gc.mul(gpk.h, GoldenDR(1).alpha())]
                        + [gpk.G_vec[i] if b else gc.neg(gpk.H_vec[i])
                           for i, b in enumerate(bits)])

    def challenge_yz(self):
        return self.twin.challenge_yz(self.jc, self.V, self.A)

    def round_challenge(self, L, R):
        return self.twin.round_challenge(self.jc, L, R)

    def final_challenge(self, A, B):
        return self.twin.final_challenge(self.jc, A, B)


def test_sharded_prove_fs256_matches_golden_under_the_jax_twin(single):
    """A fresh Fs256Transcript over 2 devices: each round's challenge from
    the summed (L, R) by the chain's round step; the bytes equal golden's
    proof under a JAX host twin, the transcript ends in the twin's state
    and counter, and the proof verifies by default."""
    system, st, _ = single
    c = system.curve
    t = bt.Fs256Transcript(1)
    got = sharded_prove(c, system.pk, N, st.prover, cpu_mesh(2), t, bt.DeterministicRng(1))
    twin = JaxFs256(1)
    want = golden_bytes(lambda jc, gpk, gc: GoldenFs256(jc, twin, gpk, gc))
    assert serialize.proof_to_bytes(c, got) == want
    assert np.array_equal(t.state_words(), twin.state_words())
    assert t._counter == twin._counter == 3 + 3
    bt.verify(c, got, system.pk, N, st.commitments)


def test_sharded_prove_argument_errors(single):
    """JAX's ValueErrors, before any work: an interactive transcript, a
    used fs256 transcript, an axis that is not a power of two, and (the
    port alone: the conftest has eight devices) mn below the axis."""
    system, st, _ = single
    c = system.curve
    jc = jax_curve_ops("edwards25519")
    jpk = JaxPublicKey.new(jc, N)
    jprover = JaxRangeProver()
    jprover.commit(jpk, V1, GAMMA1)
    used = bt.Fs256Transcript(1)
    used.set_state_words(used.state_words(), 1)
    jused = JaxFs256(1)
    jused.set_state_words(jused.state_words(), 1)
    for mine, theirs, n_dev in ((bt.ShaTranscript(1), JaxSha(1), 2),
                                (used, jused, 2),
                                (bt.DeterministicTranscript(1), JaxDT(1), 3)):
        with pytest.raises(ValueError) as ours:
            sharded_prove(c, system.pk, N, st.prover, cpu_mesh(n_dev), mine)
        with pytest.raises(ValueError) as ref:
            jax_sharded_prove(jc, jpk, N, jprover, jax_default_mesh(n_dev, dp=1), theirs)
        assert str(ours.value) == str(ref.value)
    with pytest.raises(ValueError, match="mn >= P"):
        sharded_prove(c, system.pk, N, st.prover, cpu_mesh(16), bt.DeterministicTranscript(1))


def test_config_mesh_round_trip(single, monkeypatch):
    """Config(mesh_devices=2) on the CPU: a (1, 2) mesh of the CPU; the
    proof through its bytes and back batch-verifies over it (the tp path,
    sliced tables), and a tampered copy rejects."""
    system, st, proof = single
    c = system.curve
    assert system.mesh.shape == {"dp": 1, "tp": 2}
    assert system.mesh.devices == ((torch.device(CPU),) * 2,)
    calls = []
    tp = batch_mod._verify_tp
    monkeypatch.setattr(batch_mod, "_verify_tp", lambda *a: calls.append(a[4]) or tp(*a))
    back = system.proof_from_bytes(system.proof_to_bytes(proof))
    system.batch_verify([back], [st.commitments])
    bad = dataclasses.replace(back, proof=dataclasses.replace(
        back.proof, d_prime=c.fn.add(back.proof.d_prime, c.fn.one(CPU))))
    with pytest.raises(bt.VerificationError):
        system.batch_verify([bad], [st.commitments])
    assert len(calls) == 2 and all(len(t) == 2 for t in calls)
