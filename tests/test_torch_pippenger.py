"""The port's bucket MSM (msm/pippenger.py and the plain versions of the
bucket kernels, curves/cuda_curve.py) against its joint-ladder `msm`, the
JAX package's `msm_pippenger` and the golden oracle.

The cases are tests/test_pippenger.py's: 64-bit scalars with a zero and an
all-ones scalar, batched rows, and the identity MSM (k·G + k·(−G)), on
edwards25519 and secp256k1, each held against the port's `msm`; the window
c = 6 (the JAX default, whose digits straddle 32-bit words) also against
JAX's `msm_pippenger`, and c = 4 and 8 against the port's `msm` only, since
the JAX package asserts that c divides its limb width (pippenger.py:162).
One bls12-381 case meets golden. JAX's `msm_pippenger` compiles for about
90 s a curve on a CPU whatever the shape, so it runs once, on edwards25519,
with every c = 6 case as a row of one batched call; secp256k1's cases meet
the port's `msm` and golden. Points are compared decoded (integers); inputs
come from a numpy seed.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bulletproofsplus_tpu.curves import curve_ops as jax_curve_ops
from bulletproofsplus_tpu.curves import golden_curve
from bulletproofsplus_tpu.msm.pippenger import msm_pippenger as jax_msm_pippenger
from bulletproofsplus_tpu_torch.curves import cuda_curve as cc
from bulletproofsplus_tpu_torch.curves import curve_ops
from bulletproofsplus_tpu_torch.msm import msm
from bulletproofsplus_tpu_torch.msm import pippenger

# tiny tensors: intra-op threads buy nothing here and oversubscribe the host
# beside other xdist workers
torch.set_num_threads(1)

NB = 64           # scalar bits of the 64-bit cases (tests/test_pippenger.py)
SWITCHES = ("BPP_PIPPENGER", "BPP_PIPPENGER_MIN", "BPP_PIPPENGER_C")


@pytest.fixture(autouse=True)
def jax_defaults(monkeypatch):
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)


@functools.lru_cache(maxsize=None)
def triple(name):
    """(port curve, JAX curve, golden curve)."""
    return curve_ops(name), jax_curve_ops(name), golden_curve(name)


def inputs(gc, rows, N, seed):
    """rows × N 64-bit scalars (the first row's lane 0 is 0, lane 1 all
    ones) and golden points k·B for odd 16-bit k."""
    rng = np.random.default_rng(seed)
    ss = [[int.from_bytes(rng.bytes(8), "little") for _ in range(N)] for _ in range(rows)]
    ss[0][0], ss[0][1] = 0, (1 << NB) - 1
    ks = [int(k) | 1 for k in rng.integers(0, 1 << 16, size=N)]
    return ss, [gc.mul(gc.base(), k) for k in ks]


def identity_pairs(gc, N):
    """k·B and k·(−B) for k = 1, 1, 2, 2, ...: scalars and points whose MSM
    is the identity (a verification's shape)."""
    B, nB = gc.base(), gc.neg(gc.base())
    return [i // 2 + 1 for i in range(N)], [B if i % 2 == 0 else nB for i in range(N)]


def port_pair(c, ss, pts):
    return c.fn.encode_plain([s for row in ss for s in row]).reshape(len(ss), -1, c.fn.L), \
        c.encode_points(pts)


def golden_sum(gc, ks, pts):
    acc = None
    for k, p in zip(ks, pts):
        acc = gc.add(acc, gc.mul(p, k))
    return acc


def test_digits_any_window_give_the_scalar():
    """scalar_digits at every window from 1 to 16 bits (c = 6, 10, 12 ...
    straddle 32-bit words) sum back to the scalar; c = 6 equals the JAX
    package's digits."""
    c, jc, _ = triple("secp256k1")
    rng = np.random.default_rng(3)
    xs = [int.from_bytes(rng.bytes(32), "little") % c.fn.p for _ in range(12)]
    xs += [0, c.fn.p - 1, (1 << 64) - 1, 1 << 255]
    s = c.fn.encode_plain(xs)
    for w in range(1, 17):
        d = c.fn.scalar_digits(s, 256, w)
        assert [sum(int(v) << (w * i) for i, v in enumerate(row)) for row in d] == xs, w
    got = c.fn.scalar_digits(s, 258, 6)
    want = jc.fn.scalar_digits(jnp.asarray(jc.fn.encode_plain(xs)), 258, 6)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_c6_matches_jax_msm_pippenger():
    """Every c = 6 case in one batched call on edwards25519: row 0 the 64-bit
    scalars with a zero and an all-ones scalar, row 1 the identity MSM, rows
    2-3 more 64-bit scalars (batched rows): the port's buckets equal JAX's
    `msm_pippenger` and the port's `msm`, and row 1 is the identity."""
    c, jc, gc = triple("edwards25519")
    N = 40
    ss, pts = inputs(gc, 4, N, 7)
    ks, ipts = identity_pairs(gc, N)
    ss[1] = ks
    rows = [pts, ipts, pts, pts]
    S = c.fn.encode_plain([s for row in ss for s in row]).reshape(4, N, c.fn.L)
    P = torch.stack([c.encode_points(r) for r in rows])
    jS = jnp.asarray(jc.fn.encode_plain([s for row in ss for s in row])).reshape(4, N, -1)
    jP = jnp.stack([jnp.asarray(jc.encode_points(r)) for r in rows])
    got = pippenger.msm_pippenger(c, S, P, NB)
    assert c.decode_points(got) == jc.decode_points(jax_msm_pippenger(jc, jS, jP, NB))
    assert c.decode_points(got) == c.decode_points(msm(c, S, P, NB))
    assert bool(c.is_identity(got[1]))


@pytest.mark.parametrize("name", ["edwards25519", "secp256k1"])
def test_matches_ladder_and_golden(name):
    """70 pairs (the JAX test's count) with a zero and an all-ones scalar,
    against the port's `msm` and golden."""
    c, _, gc = triple(name)
    ss, pts = inputs(gc, 1, 70, 11)
    S, P = port_pair(c, ss, pts)
    got = pippenger.msm_pippenger(c, S[0], P, NB)
    assert c.decode_point(got) == c.decode_point(msm(c, S[0], P, NB)) == golden_sum(
        gc, ss[0], pts)


@pytest.mark.parametrize("name", ["edwards25519", "secp256k1"])
def test_batched_rows_share_points(name):
    """(2, 3) MSMs over one (3, N) row set expanded over the leading axis
    (stride 0: the points go to the kernel as three rows), and the identity
    MSM as one of them."""
    c, _, gc = triple(name)
    N = 16
    ss, pts = inputs(gc, 6, N, 13)
    ks, ipts = identity_pairs(gc, N)
    ss[4] = ks
    S = c.fn.encode_plain([s for row in ss for s in row]).reshape(2, 3, N, c.fn.L)
    P = torch.stack([c.encode_points(pts), c.encode_points(ipts[::-1]),
                     c.encode_points(ipts)])
    shared = P.expand(2, *P.shape)
    assert pippenger.shared_rows(shared, (2, 3)).shape[0] == 3
    got = pippenger.msm_pippenger(c, S, shared, NB)
    assert got.shape == (2, 3, c.COORDS, c.fp.L)
    assert c.decode_points(got) == c.decode_points(msm(c, S, shared, NB))
    assert bool(c.is_identity(got[1, 1]))


@pytest.mark.parametrize("window", [4, 8])
def test_other_windows_match_ladder(monkeypatch, window):
    monkeypatch.setenv("BPP_PIPPENGER_C", str(window))
    c, _, gc = triple("edwards25519")
    ss, pts = inputs(gc, 2, 24, 17 + window)
    S, P = port_pair(c, ss, pts)
    assert pippenger.window() == window
    got = pippenger.msm_pippenger(c, S, P, NB)
    assert c.decode_points(got) == c.decode_points(msm(c, S, P.expand(2, *P.shape), NB))


@pytest.mark.parametrize("name", ["edwards25519", "secp256k1"])
def test_slices_merge_and_padded_tail(name):
    """The stages the card runs with several slices: pairs split into 3
    slices with a short last one (a padded tail), merged in slice order, at
    c = 6; rows share their points (row r reads point row r mod 2). The
    stages' plain versions against the msm; no wrapper counts a launch on
    the CPU."""
    c, _, gc = triple(name)
    R, N, nbits = 4, 8, NB
    ss, _ = inputs(gc, R, N, 19)
    P = torch.stack([c.encode_points([gc.mul(gc.base(), 3 + i + 20 * r) for i in range(N)])
                     for r in range(2)])
    P[1, 2] = P[1, 5]                                    # P + P in a bucket
    S = c.fn.encode_plain([s for row in ss for s in row]).reshape(R, N, c.fn.L)
    before = [f.launches for f in (cc.bucket_accumulate, cc.bucket_merge, cc.bucket_reduce)]
    nwin = -(-nbits // 6)
    buckets = cc.bucket_accumulate(c, S, P, nwin, 6, 3)
    assert buckets.shape == (R, 3, nwin, 64, c.COORDS, c.fp.L)
    assert bool(c.is_identity(buckets[:, :, :, 0]).all())
    got = cc.bucket_reduce(c, cc.bucket_merge(c, buckets), 6)
    want = msm(c, S, P.repeat(2, 1, 1, 1), nbits)
    assert c.decode_points(got) == c.decode_points(want)
    assert [f.launches for f in (cc.bucket_accumulate, cc.bucket_merge,
                                 cc.bucket_reduce)] == before


@pytest.mark.parametrize("window", [4, 6, 8])
@pytest.mark.parametrize("name", ["edwards25519", "secp256k1"])
def test_reduce_segments_match_msm_and_golden(name, window):
    """The reduce's plain version in the kernel's order (segments of the
    digits s + segments·j, a suffix scan, doublings, a butterfly, then
    Horner) at 1, 2, 4 and 8 segments a window (1 and 8 at c = 8), none of
    which divides the 2^c − 1 digits, against golden, and at c = 6 the port's msm: row 0's
    scalars share one digit in window 0 (a single nonzero bucket) and have
    a zero middle window (every bucket the identity); row 1's are random.
    The wrapper on the CPU takes the most segments."""
    c, _, gc = triple(name)
    nwin, N = 3, 5
    nbits = nwin * window
    rng = np.random.default_rng(window)
    d0 = int(rng.integers(1, 1 << window))
    ss = [[d0 | (int(rng.integers(0, 1 << window)) << (2 * window)) for _ in range(N)],
          [int(rng.integers(0, 1 << nbits)) for _ in range(N)]]
    pts = [gc.mul(gc.base(), 5 + 7 * i) for i in range(N)]
    S, P = port_pair(c, ss, pts)
    merged = cc.bucket_accumulate_plain(c, S, P[None], nwin, window, 1)[:, 0]
    assert bool(c.is_identity(merged[0, 1]).all())
    assert int((~c.is_identity(merged[0, 0])).sum()) == 1
    want = [golden_sum(gc, row, pts) for row in ss]
    if window == 6:
        assert c.decode_points(msm(c, S, P.expand(2, *P.shape), nbits)) == want
    for seg in ((1, 2, 4, 8) if window < 8 else (1, 8)):      # c = 8: 255 steps at 1
        assert c.decode_points(cc.bucket_reduce_plain(c, merged, window, seg)) == want
    assert cc.reduce_segments(2, nwin, window) == 8
    assert torch.equal(cc.bucket_reduce(c, merged, window),
                       cc.bucket_reduce_plain(c, merged, window, 8))


def test_reduce_segments_fill_the_card():
    """Segments a window: the most (8, at most 2^c) whose quads the card's
    resident threads hold, 0 (a thread a window) where even one quad a
    window is more."""
    # the coefficient prover's L/R rows at n·m = 1,024, c = 6: K = 1 and 256
    assert cc.reduce_segments(20, 43, 6, 65536) == 8
    assert cc.reduce_segments(5120, 43, 6, 65536) == 0
    assert cc.reduce_segments(320, 43, 6, 65536) == 1
    assert cc.reduce_segments(381, 43, 6, 65536) == 1
    assert cc.reduce_segments(382, 43, 6, 65536) == 0
    assert cc.reduce_segments(80, 43, 6, 65536) == 4
    assert cc.reduce_segments(1, 43, 2, 65536) == 4
    assert cc.reduce_segments(1, 43, 1) == 2
    with pytest.raises(ValueError):
        cc.bucket_reduce_plain(triple("edwards25519")[0], torch.zeros(1, 1, 4, 4, 8), 2, 8)


def test_bls12_381_matches_golden():
    c, _, gc = triple("bls12_381")
    ss, pts = inputs(gc, 2, 12, 23)
    S, P = port_pair(c, ss, pts)
    got = pippenger.msm_pippenger(c, S, P, NB)
    assert c.decode_points(got) == [golden_sum(gc, row, pts) for row in ss]


def test_layout_fills_the_card_within_the_memory_bound():
    """Slices: as many as fill the resident threads, at most √N and what
    BUCKET_BYTES holds; rows beyond the bound go in chunks of whole point
    row sets."""
    # the coefficient prover's L/R rows at n·m = 1,024, K = 1 and 256 (edwards25519)
    assert cc.bucket_layout(20, 1026, 43, 6, 128, 65536) == (32, 20)
    assert cc.bucket_layout(5120, 1026, 43, 6, 128, 65536) == (1, 5120)
    # the verifier's one row of 9,985 lanes
    assert cc.bucket_layout(1, 9985, 43, 6, 128, 65536) == (99, 1)
    # bls12-381's rows at K = 256, m = 256: 7,168 rows of 28 a proof
    slices, rows = cc.bucket_layout(7168, 16386, 43, 6, 144, 65536, 28)
    assert slices == 1 and rows % 28 == 0 and rows * 43 * 64 * 144 <= cc.BUCKET_BYTES


def test_switches_read_at_call_time(monkeypatch):
    """The JAX names and defaults: off, 4,096 lanes, c = 6."""
    assert not pippenger.pippenger_enabled()
    assert pippenger.pippenger_min_lanes() == 4096 and pippenger.window() == 6
    monkeypatch.setenv("BPP_PIPPENGER", "0")
    assert not pippenger.pippenger_enabled()
    monkeypatch.setenv("BPP_PIPPENGER", "1")
    monkeypatch.setenv("BPP_PIPPENGER_MIN", "0")
    assert pippenger.pippenger_enabled() and pippenger.pippenger_min_lanes() == 0
    monkeypatch.setenv("BPP_PIPPENGER_C", "17")
    with pytest.raises(ValueError):
        pippenger.window()
