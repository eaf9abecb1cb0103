"""Kernels K1–K5 (K1 with the field kernels around its product) and the fs256
transcript's SHA-256 against their plain versions, every point family and
width, and the port's prover and verifier on edwards25519, secp256k1 and
bls12-381 in the deterministic and fs256 modes, on an NVIDIA card.

Marked `cuda`: every test skips where torch sees no CUDA device (it decides
inside the test, so every worker collects the same tests). This file
imports neither jax nor the JAX package, so it runs on a machine that has
only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""
import hashlib
import os
import random

import pytest
import torch

import bulletproofsplus_tpu_torch as bt
from bulletproofsplus_tpu_torch import hashers_device as hd
from bulletproofsplus_tpu_torch import serialize
from bulletproofsplus_tpu_torch.curves import CURVE_NAMES
from bulletproofsplus_tpu_torch.curves import cuda_curve as cc
from bulletproofsplus_tpu_torch.fields import field_kernels as fk
from bulletproofsplus_tpu_torch.fields.mont_mul import mont_mul, mont_mul_plain
from bulletproofsplus_tpu_torch.msm import msm, msm_partials, tree_sum
from bulletproofsplus_tpu_torch.msm.fixed import (
    fixed_msm,
    fixed_msm_partials,
    precompute_tables,
    precompute_tables_signed,
)

pytestmark = pytest.mark.cuda
DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "bulletproofsplus_tpu_torch", "data")
FIXTURES = {"edwards25519": os.path.join(DATA, "ed25519_n64_m16_det.bin"),
            "secp256k1": os.path.join(DATA, "secp256k1_n64_m64_det.bin"),
            "bls12_381": os.path.join(DATA, "bls12_381_n64_m256_det.bin")}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda:0")


def points(c, count, seed, device):
    hc = c.host
    rnd = random.Random(seed)
    B = hc.lift(hc.base)
    step = hc.mul(B, rnd.randrange(1, 1 << 64))
    cur = hc.mul(B, rnd.randrange(1, 1 << 64))
    out = []
    for _ in range(count):
        out.append(cur)
        cur = hc.add(cur, step)
    return c.encode_points(hc.to_affine(out), device)


@pytest.fixture(params=CURVE_NAMES)
def c(request):
    return bt.curve_ops(request.param)


def carry_runs(p, words, count, seed):
    """count values below p whose word-wise sums, differences and products
    carry or borrow through long runs: p − 1, p − 2, words of all ones and
    of zeros under a top word below p's, and values in [p/2, p)."""
    rnd = random.Random(seed)
    low = 32 * (words - 1)
    top, ones = p >> low, (1 << low) - 1
    out = [p - 1, p - 2, 0, 1, ones, ((top - 1) << low) | ones, p - 1 - ones, p // 2, p // 2 + 1]
    while len(out) < count:
        kind = len(out) % 3
        if kind == 0:
            ws = [rnd.choice((0, 0xFFFFFFFF, 0xFFFFFFFF, rnd.getrandbits(32)))
                  for _ in range(words - 1)]
            out.append(sum(w << (32 * i) for i, w in enumerate(ws)) + (rnd.randrange(top) << low))
        elif kind == 1:
            out.append(rnd.randrange(p // 2, p))
        else:
            out.append(p - 1 - rnd.getrandbits(rnd.randrange(1, 32 * words)))
    return out


@pytest.mark.parametrize("which", ["fp", "fn"])
def test_k1_kernel_matches_plain(dev, c, which):
    f = getattr(c, which)
    rnd = random.Random(1)
    xs = ([rnd.randrange(f.p) for _ in range(497)] + [0, 1, f.p - 1]
          + [rnd.randrange(f.p // 2, f.p) for _ in range(500)])
    ys = ([rnd.randrange(f.p) for _ in range(497)] + [f.p - 1, f.p - 1, f.p - 1]
          + [rnd.randrange(f.p // 2, f.p) for _ in range(500)])
    a, b = f.encode(xs, dev), f.encode(ys, dev)
    before = mont_mul.launches
    got = mont_mul(a, b, f.spec)
    assert mont_mul.launches == before + 1
    assert torch.equal(got, mont_mul_plain(a, b, f.spec))
    assert f.decode(got) == [x * y % f.p for x, y in zip(xs, ys)]


@pytest.mark.parametrize("which", ["fp", "fn"])
def test_k1_kernel_on_carry_runs(dev, c, which):
    """Every pair of 40 carry-run operands: the kernel equals its plain
    version and a·b·R^-1 mod p."""
    f = getattr(c, which)
    vals = carry_runs(f.p, f.L, 40, 7)
    xs = [x for x in vals for _ in vals]
    ys = [y for _ in vals for y in vals]
    a, b = f.encode_plain(xs, dev), f.encode_plain(ys, dev)
    got = mont_mul(a, b, f.spec)
    assert torch.equal(got, mont_mul_plain(a, b, f.spec))
    rinv = pow(1 << (32 * f.L), -1, f.p)
    assert f.decode_plain(got) == [x * y * rinv % f.p for x, y in zip(xs, ys)]


@pytest.mark.parametrize("which", ["fp", "fn"])
def test_field_kernels_on_carry_runs(dev, c, which):
    """add, sub, neg, the product with broadcast operands (stride-0 reads),
    sums over a leading and an inner axis at odd and power-of-two lengths,
    and powers (p − 2, small, 0), all on carry-run values at the field's
    width: each kernel equals its plain version word for word and launches
    once."""
    f = getattr(c, which)
    spec, L = f.spec, f.L
    vals = carry_runs(f.p, L, 40, 11)
    xs = [x for x in vals for _ in vals]
    ys = [y for _ in vals for y in vals]
    a = f.encode_plain(xs, dev).reshape(40, 40, L)
    b = f.encode_plain(ys, dev).reshape(40, 40, L)
    pairs = [(a, b), (a, b[:, :1]), (a[0, 0], b), (a[:, 7:], b[:, :33]), (a[:, ::2], b[:, 1::2])]
    for x, y in pairs:
        for wrapper, plain in ((fk.fe_add, fk.fe_add_plain), (fk.fe_sub, fk.fe_sub_plain),
                               (mont_mul, mont_mul_plain)):
            before = wrapper.launches
            assert torch.equal(wrapper(x, y, spec), plain(x, y, spec))
            assert wrapper.launches == before + 1
        assert torch.equal(fk.fe_neg(x, spec), fk.fe_neg_plain(x, spec))
    rinv = pow(1 << (32 * L), -1, f.p)
    assert f.decode_plain(fk.fe_add(a, b, spec).reshape(-1, L)) == [
        (x + y) % f.p for x, y in zip(xs, ys)]
    assert f.decode_plain(mont_mul(a, b, spec).reshape(-1, L)) == [
        x * y * rinv % f.p for x, y in zip(xs, ys)]
    for length in (39, 40, 256, 257):
        t = f.encode_plain(carry_runs(f.p, L, 3 * length, length), dev)
        for shape, axis in (((length, 3, L), 0), ((3, length, L), 1)):
            before = fk.fe_sum.launches
            assert torch.equal(fk.fe_sum(t.reshape(shape), spec, axis),
                               fk.fe_sum_plain(t.reshape(shape), spec, axis))
            assert fk.fe_sum.launches == before + 1
    nonzero = [v for v in vals if v]
    m = f.encode(nonzero, dev)
    for e in (f.p - 2, 0, 1, 12345):
        assert torch.equal(fk.fe_pow(m, e, spec), fk.fe_pow_plain(m, e, spec))
    assert f.decode(f.inv(m)) == [pow(v, -1, f.p) for v in nonzero]


@pytest.mark.parametrize("which", ["fp", "fn"])
def test_fe_inv_kernel_matches_plain(dev, c, which):
    """The divstep inversion on the card: 0, 1, p − 1, powers of two and
    carry runs, then 256 random values, each equal word for word to its
    plain version and to fe_pow_plain(a, p − 2) (0 ↦ 0), one launch a call;
    FieldOps.inv launches it once."""
    f = getattr(c, which)
    spec, p = f.spec, f.p
    rnd = random.Random(31)
    vals = ([0, 1, 2, p - 1, p - 2] + [1 << k for k in range(0, p.bit_length() - 1, 9)]
            + carry_runs(p, f.L, 40, 13))
    for xs in (vals, [rnd.randrange(p) for _ in range(256)]):
        a = f.encode(xs, dev)
        before = fk.fe_inv.launches
        got = fk.fe_inv(a, spec)
        assert fk.fe_inv.launches == before + 1
        want = fk.fe_inv_plain(a.cpu(), spec)
        assert torch.equal(got.cpu(), want)
        assert torch.equal(want, fk.fe_pow_plain(a.cpu(), p - 2, spec))
        assert f.decode(got) == [pow(x, -1, p) if x else 0 for x in xs]
    before, pows = fk.fe_inv.launches, fk.fe_pow.launches
    f.inv(a)
    assert (fk.fe_inv.launches, fk.fe_pow.launches) == (before + 1, pows)


@pytest.mark.parametrize("jway", [2, 4])
def test_k2_kernel_on_carry_runs(dev, c, jway):
    """Coordinates drawn from carry runs (off the curve: the kernel and its
    plain version run the same formulas on any values below p) and scalars
    of all-ones and all-zero words: the kernel equals its plain version word
    for word."""
    G, C, L = 37, c.COORDS, c.fp.L
    coords = carry_runs(c.fp.p, L, G * jway * C, jway)
    random.Random(jway).shuffle(coords)
    P = c.fp.encode_plain(coords, dev).reshape(G * jway, C, L)
    rnd = random.Random(jway + 1)
    words = [rnd.choice((0, 0xFFFFFFFF, rnd.getrandbits(32))) for _ in range(G * jway * 8)]
    s = torch.tensor([w - (1 << 32) if w >> 31 else w for w in words],
                     dtype=torch.int32, device=dev).reshape(G * jway, 8)
    nbits = c.fn.order_bits
    got = cc.joint_ladder_msm_grouped(c, s, P, nbits, jway)
    want = cc.joint_ladder_plain(c, s.reshape(G, jway, 8), P.reshape(G, jway, C, L), nbits)
    assert torch.equal(got, want)


@pytest.mark.parametrize("jway", [1, 2, 4, 8])
def test_k2_kernel_matches_plain(dev, c, jway):
    G = 37
    rnd = random.Random(jway)
    P = points(c, G * jway, jway, dev)
    P[1] = c.identity(dev)
    s = c.fn.encode_plain([0] + [rnd.randrange(c.fn.p) for _ in range(G * jway - 1)], dev)
    nbits = c.fn.order_bits
    got = cc.joint_ladder_msm_grouped(c, s, P, nbits, jway)
    want = cc.joint_ladder_plain(c, s.reshape(G, jway, c.fn.L),
                                 P.reshape(G, jway, c.COORDS, c.fp.L), nbits)
    assert torch.equal(got, want)


@pytest.mark.parametrize("W", [1, 300, 1000])
def test_k3_kernel_matches_plain(dev, c, W):
    P = points(c, 3 * W, W, dev).reshape(3, W, c.COORDS, c.fp.L)
    assert c.decode_points(cc.sum_points_grouped(c, P)) == c.decode_points(
        cc.sum_points_plain(c, P))


@pytest.mark.parametrize("signed", [False, True])
def test_k4_kernel_matches_plain(dev, c, signed):
    rnd = random.Random(4)
    P = points(c, 24, 5, dev)
    table = (precompute_tables_signed if signed else precompute_tables)(c, P)
    s = c.fn.encode_plain([rnd.randrange(c.fn.p) for _ in range(24)], dev)
    dig = cc.fixed_digits(c, s, c.fn.order_bits, signed)
    parts = cc.fixed_lookup_partials(c, table, dig, signed)
    got = cc.sum_points_plain(c, parts[None])
    assert c.decode_points(got) == c.decode_points(
        cc.fixed_lookup_plain(c, table, dig, signed))


@pytest.mark.parametrize("W", [1, 2, 255, 257, 9185])
def test_k3_kernel_one_group(dev, c, W):
    """The verifier's one-group shape, spread over one segment (W ≤ 256) or
    over several blocks whose last block sums their partials."""
    P = points(c, W, W + 1, dev)[None]
    before = cc.sum_points_grouped.launches
    got = cc.sum_points_grouped(c, P)
    assert cc.sum_points_grouped.launches == before + 1
    assert c.decode_points(got) == c.decode_points(cc.sum_points_plain(c, P))


def test_k3_kernel_many_groups(dev, c):
    """The prover's 512 × 257 shape (round 0's L and R sums at
    edwards25519), from 1,024 distinct points with identities among them."""
    base = points(c, 1024, 9, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    P = base[torch.randint(0, 1024, (512 * 257,), generator=gen, device=dev)]
    P[::97] = c.identity(dev)
    P = P.reshape(512, 257, c.COORDS, c.fp.L)
    assert c.decode_points(cc.sum_points_grouped(c, P)) == c.decode_points(
        cc.sum_points_plain(c, P))


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("npts,nbits,zero", [(24, 16, False), (37, None, False),
                                             (1000, None, False), (37, None, True)])
def test_k4_kernel_lane_counts(dev, c, signed, npts, nbits, zero):
    """K4 with fewer lanes than one block (24 points × 4 windows), lane
    counts that are no multiple of the grid's threads, more lanes than the
    card's resident threads (1,000 points × 64 windows), and every digit
    zero (the identity of either flavor)."""
    rnd = random.Random(npts)
    nbits = nbits or c.fn.order_bits
    P = points(c, npts, 6, dev)
    table = (precompute_tables_signed if signed else precompute_tables)(c, P, nbits)
    s = c.fn.encode_plain([0 if zero else rnd.randrange(c.fn.p) % (1 << nbits)
                           for _ in range(npts)], dev)
    dig = cc.fixed_digits(c, s, nbits, signed)
    assert (dig.numel() < cc.BLOCK) == (npts == 24)
    parts = cc.fixed_lookup_partials(c, table, dig, signed)
    want = cc.fixed_lookup_plain(c, table, dig, signed)
    assert c.decode_points(cc.sum_points_plain(c, parts[None])) == c.decode_points(want)
    if zero:
        assert c.decode_points(want) == [None]


def test_verify_tail_one_k3(dev, c):
    """One K3 over K2's group outputs and K4's partials equals msm +
    fixed_msm, as the batch verifier's tail computes it."""
    rnd = random.Random(8)
    P, Q = points(c, 300, 12, dev), points(c, 200, 13, dev)
    s = c.fn.encode_plain([rnd.randrange(c.fn.p) for _ in range(300)], dev)
    t = c.fn.encode_plain([rnd.randrange(c.fn.p) for _ in range(200)], dev)
    table = precompute_tables(c, Q)
    parts = torch.cat([msm_partials(c, s, P), fixed_msm_partials(c, t, table)])
    before = cc.sum_points_grouped.launches
    got = tree_sum(c, parts)
    assert cc.sum_points_grouped.launches == before + 1
    assert c.decode_point(got) == c.decode_point(c.add(msm(c, s, P), fixed_msm(c, t, table)))


def read_fixture(c):
    with open(FIXTURES[c.name], "rb") as f:
        name, n, m, rows = serialize.read_fixture(f.read())
    assert name == c.name
    return n, m, rows


def test_batch_verify_on_card(dev, c):
    n, m, rows = read_fixture(c)
    rows = rows[:4]
    batch = bt.ProofBatch.from_proofs(
        [serialize.proof_from_bytes(c, wire, dev) for _, wire in rows])
    V = torch.stack([c.encode_points(serialize.points_from_bytes(c, cm), dev)
                     for cm, _ in rows])
    pk = bt.PublicKey.new(c, n * m, dev)
    trs = [bt.DeterministicTranscript(m)] * len(rows)
    bt.batch_verify(c, pk, n, batch, V, trs)
    batch.s_prime = batch.s_prime.clone()
    batch.s_prime[2] = c.fn.add(batch.s_prime[2], c.fn.one(dev))
    with pytest.raises(bt.VerificationError):
        bt.batch_verify(c, pk, n, batch, V, trs)


def check_k5(c, s, P, nbits):
    """One K5 launch equals the plain ladder word for word."""
    before = cc.ladder_scalar_mul.launches
    got = cc.ladder_scalar_mul(c, s, P, nbits)
    assert cc.ladder_scalar_mul.launches == before + 1
    assert torch.equal(got, cc.ladder_plain(c, s, P, nbits))


@pytest.mark.parametrize("N", [1, 7, 9, 37, 256])
def test_k5_kernel_matches_plain(dev, c, N):
    """Four threads a lane: lane counts on and off a multiple of a warp's 8
    quads (the last warp's surplus quads copy lane N − 1 and store nothing),
    with a zero scalar and the identity where N allows."""
    rnd = random.Random(5)
    P = points(c, N, 5, dev)
    vals = [rnd.randrange(c.fn.p) for _ in range(N)]
    if N > 3:
        vals[0] = 0
        P[3] = c.identity(dev)
    check_k5(c, c.fn.encode_plain(vals, dev), P, c.fn.order_bits)


@pytest.mark.parametrize("case", ["zero", "n-1", "identity", "carry runs", "nbits=16"])
def test_k5_kernel_edge_cases(dev, c, case):
    """37 lanes, every third of them the case: zero scalars, the scalar
    n − 1, the identity as P; all scalars carry runs (words of all ones and
    zeros); or 16-bit scalars (4 windows)."""
    from chip_smoke import carry_run_scalars

    rnd = random.Random(6)
    N, nbits = 37, c.fn.order_bits
    P = points(c, N, 6, dev)
    vals = [rnd.randrange(c.fn.p) for _ in range(N)]
    if case in ("zero", "n-1"):
        vals[::3] = [0 if case == "zero" else c.fn.p - 1] * len(vals[::3])
    if case == "identity":
        P[::3] = c.identity(dev)
    if case == "nbits=16":
        nbits = 16
        vals = [v % (1 << 16) for v in vals]
    s = c.fn.encode_plain(vals, dev)
    if case == "carry runs":
        gen = torch.Generator(device=dev)
        gen.manual_seed(6)
        s = carry_run_scalars(N, gen, dev)
    check_k5(c, s, P, nbits)


def fixture_provers(c, pk, n, m, count):
    """The first `count` fixture witnesses (scripts/make_torch_fixtures.py:
    statement k's from random.Random(1000 + k))."""
    provers = []
    for k in range(count):
        wit = random.Random(1000 + k)
        p = bt.RangeProver()
        for _ in range(m):
            p.commit(pk, wit.randrange(1 << n), wit.randrange(1, c.fn.p))
        provers.append(p)
    return provers


def test_batch_prove_on_card_equals_fixture(dev):
    """Two edwards25519 fixture witnesses, proven on the card, give the
    committed golden-made bytes."""
    c = bt.curve_ops("edwards25519")
    n, m, rows = read_fixture(c)
    pk = bt.PublicKey.new(c, n * m, dev)
    provers = fixture_provers(c, pk, n, m, 2)
    batch = bt.batch_prove(c, pk, n, provers, [bt.DeterministicTranscript(m)] * 2,
                           [bt.DeterministicRng(m)] * 2)
    assert batch.A.device.type == "cuda"
    assert [serialize.proof_to_bytes(c, batch[k]) for k in range(2)] == [
        wire for _, wire in rows[:2]]


def test_prove_on_card_equals_fixture(dev, c):
    """`prove`, the K = 1 batch, on the card: the first fixture statement's
    bytes, and its own verify accepts."""
    n, m, rows = read_fixture(c)
    pk = bt.PublicKey.new(c, n * m, dev)
    (prover,) = fixture_provers(c, pk, n, m, 1)
    proof = bt.prove(c, pk, n, prover, bt.DeterministicTranscript(m), bt.DeterministicRng(m))
    assert serialize.proof_to_bytes(c, proof) == rows[0][1]
    bt.verify(c, proof, pk, n, torch.stack(prover.commitment_vec),
              bt.DeterministicTranscript(m))


@pytest.mark.parametrize("msg_bytes", [0, 4, 36, 44, 60, 64, 100, 164, 1124])
def test_sha256_kernel_matches_plain(dev, msg_bytes):
    """The SHA-256 kernel bit for bit against its plain version and hashlib,
    on 1, 33 and 512 messages (partial warps and blocks), padding into a
    block of its own (60, 100 bytes) included, through two leading axes."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(msg_bytes)
    for B in (1, 33, 512):
        msgs = torch.randint(-2**31, 2**31, (B, msg_bytes // 4), dtype=torch.int32,
                             generator=gen, device=dev)
        before = hd.sha256_words.launches
        out = hd.sha256_words(msgs.reshape(1, B, -1), msg_bytes)
        assert hd.sha256_words.launches == before + 1 and out.shape == (1, B, 8)
        assert torch.equal(out[0].cpu(), hd.sha256_words_plain(msgs.cpu(), msg_bytes))
        for row in (0, B - 1):
            data = msgs[row].cpu().numpy().view("uint32").astype(">u4").tobytes()
            assert out[0, row].cpu().numpy().view("uint32").astype(">u4").tobytes() == \
                hashlib.sha256(data).digest()


@pytest.mark.parametrize("K", [1, 3, 256])
def test_fs256_chain_kernel_matches_plain(dev, c, K):
    """The fs256 chain kernel bit for bit against its plain version (run on
    CPU copies): the verifier's schedule from the default label's state
    and from a custom label's, and the prover's one-step schedules on
    counters that start past 0; K = 256 fills many blocks of pairs."""
    from bulletproofsplus_tpu_torch.protocol import fs256

    m, logn = 4, 3
    rows = m + 3 + 2 * logn
    gen = torch.Generator(device=dev)
    gen.manual_seed(K)
    pool = points(c, 4 * rows, K, dev)
    pool[3] = c.identity(dev)
    idx = torch.randint(0, 4 * rows, (K, rows), generator=gen, device=dev)
    cw = fs256.affine_words(c, pool[idx]).reshape(K, rows, -1)
    default = fs256.initial_state(m, (K,), dev).contiguous()
    custom = hd.words_tensor(bt.Fs256Transcript(m, b"a custom fs256 label, 32 bytes. "
                                                ).state_words(), dev).expand(K, 8).contiguous()
    rand = torch.randint(-2**31, 2**31, (K, 8), dtype=torch.int32, generator=gen, device=dev)
    base = torch.randint(1, 9, (K,), dtype=torch.int32, generator=gen, device=dev)
    cases = [(default, None, fs256.replay_schedule(m, logn)),
             (custom, None, fs256.replay_schedule(m, logn)),
             (rand, base, (fs256.statement_step(m),)),
             (rand, base, (fs256.round_step(1, m + 3),)),
             (custom, base, (fs256.final_step(logn, rows - 2),))]
    for state, b, schedule in cases:
        want = hd.fs256_chain_plain(c.fn, state.cpu(), None if b is None else b.cpu(),
                                    cw.cpu(), schedule)
        before = hd.fs256_chain.launches
        got = hd.fs256_chain(c.fn, state, b, cw, schedule)
        assert hd.fs256_chain.launches == before + 1
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


def test_fs256_prove_and_verify_on_card(dev, c):
    """fs256 (the default transcripts) on the card at n = 8, m = 2, K = 3:
    the chain kernel draws every challenge (no SHA-256 launch on either
    path), the card's replay equals the host twin's, each prover transcript
    ends in the twin's state, the batch verifies and a tampered one
    rejects."""
    from bulletproofsplus_tpu_torch.protocol.fs256 import fs256_replay
    from bulletproofsplus_tpu_torch.protocol.range import replay_batch

    n, m, K = 8, 2, 3
    pk = bt.PublicKey.new(c, n * m, dev)
    provers = []
    for k in range(K):
        p = bt.RangeProver()
        for i in range(m):
            p.commit(pk, (37 * k + 11 * i) % (1 << n), 1000 + 7 * k + i)
        provers.append(p)
    trs = [bt.Fs256Transcript(m) for _ in range(K)]
    before, sha = hd.fs256_chain.launches, hd.sha256_words.launches
    batch = bt.batch_prove(c, pk, n, provers, trs)
    assert hd.fs256_chain.launches == before + 1 + (n * m).bit_length()   # y/z, rounds, final
    V = bt.stack_commitments(c, [p.commitment_vec for p in provers])
    twins = [bt.Fs256Transcript(m) for _ in range(K)]
    ys, zs, ess, efs = replay_batch(c, n, m, twins, batch, V)
    y, z, es, ef = fs256_replay(c, m, V, batch.A, batch.L_vec, batch.R_vec, batch.A_wip,
                                batch.B)
    assert (c.fn.decode(y), c.fn.decode(z), c.fn.decode(es), c.fn.decode(ef)) == (
        ys, zs, [e for row in ess for e in row], efs)
    for t, twin in zip(trs, twins):
        assert t.state_words().tolist() == twin.state_words().tolist()
        assert t._counter == twin._counter
    before = hd.fs256_chain.launches
    bt.batch_verify(c, pk, n, batch, V)
    assert hd.fs256_chain.launches == before + 1 and hd.sha256_words.launches == sha
    bad = batch.take(slice(None))
    bad.d_prime = bad.d_prime.clone()
    bad.d_prime[2] = c.fn.add(bad.d_prime[2], c.fn.one(dev))
    with pytest.raises(bt.VerificationError):
        bt.batch_verify(c, pk, n, bad, V)


@pytest.mark.parametrize("R,N,prow,window,slices", [
    (3, 37, 3, 6, 1), (4, 50, 2, 6, 4), (2, 9, 1, 4, 3), (1, 200, 1, 8, 14)])
def test_bucket_kernels_match_plain(dev, c, R, N, prow, window, slices):
    """Accumulate, merge and reduce against their plain versions word for
    word (the same add order; the reduce at a thread a window and at 1,
    2, 4 and 8 segments a window, none of which divides 2^c − 1), with
    zero scalars, P + P and
    the identity in a bucket, rows sharing their points and a short last
    slice; the whole bucket MSM against the joint ladder as affine
    points."""
    rnd = random.Random(R * 1000 + N)
    fn = c.fn
    P = points(c, prow * N, N, dev).reshape(prow, N, c.COORDS, c.fp.L)
    P[0, 1] = c.identity(dev)
    P[0, 3] = P[0, 2]
    vals = [rnd.randrange(fn.p) for _ in range(R * N)]
    vals[0] = 0
    vals[2] = vals[3]
    S = fn.encode_plain(vals, dev).reshape(R, N, fn.L)
    nbits = fn.order_bits
    nwin = -(-nbits // window)
    before = [f.launches for f in (cc.bucket_accumulate, cc.bucket_merge, cc.bucket_reduce)]
    bk = cc.bucket_accumulate(c, S, P, nwin, window, slices)
    assert torch.equal(bk, cc.bucket_accumulate_plain(c, S, P, nwin, window, slices))
    merged = cc.bucket_merge(c, bk) if slices > 1 else bk[:, 0]
    if slices > 1:
        assert torch.equal(merged, cc.bucket_merge_plain(c, bk))
    for seg in (0, 1, 2, 4, 8):
        out = cc.bucket_reduce(c, merged, window, seg)
        assert torch.equal(out, cc.bucket_reduce_plain(c, merged, window, seg))
    assert [f.launches for f in (cc.bucket_accumulate, cc.bucket_merge, cc.bucket_reduce)] == [
        before[0] + 1, before[1] + (slices > 1), before[2] + 5]
    want = msm(c, S, P.repeat(R // prow, 1, 1, 1), nbits)
    assert c.decode_points(out) == c.decode_points(want)
    assert c.decode_points(cc.bucket_msm(c, S, P, nbits, window)) == c.decode_points(want)


def test_coeff_prove_on_card_equals_fixture(dev, c, monkeypatch):
    """BPP_PROVER=coeff on both row-MSM backends: `prove` of the first
    fixture statement gives the fixture's bytes (the bucket kernels launch
    on the second)."""
    n, m, rows = read_fixture(c)
    pk = bt.PublicKey.new(c, n * m, dev)
    (prover,) = fixture_provers(c, pk, n, m, 1)
    monkeypatch.setenv("BPP_PROVER", "coeff")
    for buckets in ("0", "1"):
        monkeypatch.setenv("BPP_PIPPENGER", buckets)
        before = cc.bucket_accumulate.launches
        proof = bt.prove(c, pk, n, prover, bt.DeterministicTranscript(m),
                         bt.DeterministicRng(m))
        assert serialize.proof_to_bytes(c, proof) == rows[0][1]
        assert (cc.bucket_accumulate.launches > before) == (buckets == "1")
