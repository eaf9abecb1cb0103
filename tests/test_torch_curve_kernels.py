"""The port's point layer and the plain versions of kernels K2–K4 against the
JAX package's curve ops, its Pallas kernels in interpret mode and the golden
oracle, on both point families: edwards25519 (extended Edwards), and
secp256k1 and bls12-381 G1 (projective Weierstrass, the `_wadd`/`_wdbl`
bodies of the TPU kernels, at 8 and 12 words a coordinate).

Points are compared as decoded affine tuples (canonical integers); scalars
come from a numpy seed. nbits = 16 keeps the interpret-mode ladders short,
as tests/test_pallas.py does. A Weierstrass Pallas kernel costs 50 s (K2 at
J = 2) to over 15 minutes (K3) in interpret mode on a CPU, against 30-70 s
for Edwards, so the Weierstrass form meets the interpret-mode K2 at J = 2
and otherwise golden, which tests/test_pallas.py holds the Weierstrass
Pallas kernels to on the same kind of inputs. At bls12-381's 32 limbs the
interpret-mode kernels cost more again, so the 12-word plain versions meet
golden only."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bulletproofsplus_tpu.curves import curve_ops as jax_curve_ops
from bulletproofsplus_tpu.curves import golden_curve
from bulletproofsplus_tpu.curves.pallas_curve import (
    fixed_msm_kernel as jax_fixed_msm_kernel,
    fixed_table_kernel_layout,
    joint_ladder_msm_grouped as jax_joint_ladder,
    sum_points_grouped as jax_sum_points,
)
from bulletproofsplus_tpu.msm.fixed import (
    precompute_tables as jax_precompute_tables,
    precompute_tables_signed as jax_precompute_tables_signed,
)
from bulletproofsplus_tpu.protocol.publickey import PublicKey as JaxPublicKey
from bulletproofsplus_tpu_torch import PublicKey, convert
from bulletproofsplus_tpu_torch.curves import CURVE_NAMES
from bulletproofsplus_tpu_torch.curves import cuda_curve as cc
from bulletproofsplus_tpu_torch.curves import curve_ops
from bulletproofsplus_tpu_torch.msm import msm, msm_partials, scalar_mul, tree_sum
from bulletproofsplus_tpu_torch.msm.fixed import (
    fixed_base_mode,
    fixed_msm,
    fixed_msm_partials,
    precompute_tables,
    precompute_tables_signed,
    table_bytes,
)

# The port's CPU tests run tiny tensors: intra-op threads buy nothing at
# these sizes, and beside other xdist workers they oversubscribe the host (a
# bls12-381 batch prove took 28 s alone and 895 s beside three workers).
torch.set_num_threads(1)

NBITS = 16


@functools.lru_cache(maxsize=None)
def triple(name):
    """(port curve, JAX curve, golden curve)."""
    return curve_ops(name), jax_curve_ops(name), golden_curve(name)


@pytest.fixture(scope="module", params=CURVE_NAMES)
def curves(request):
    return triple(request.param)


def golden_points(gc, count, start):
    return [gc.mul(gc.base(), start + i) for i in range(count)]


def scalars(seed, count, nbits=NBITS):
    rng = np.random.default_rng(seed)
    ks = [int.from_bytes(rng.bytes(32), "little") % (1 << nbits)
          for _ in range(count - 2)]
    return ks + [0, 1]


def golden_msm(gc, ks, pts):
    acc = None
    for k, p in zip(ks, pts):
        acc = gc.add(acc, gc.mul(p, k))
    return acc


def test_point_ops_match_jax(curves):
    """add, dbl and neg against the JAX curve ops and golden, as affine
    integers: the identity on either side, P + P, and P + (−P)."""
    c, jc, gc = curves
    pts = golden_points(gc, 6, 3) + [None, None, gc.mul(gc.base(), 9)]
    qts = golden_points(gc, 6, 11) + [gc.base(), None, gc.mul(gc.base(), 9)]
    P, Q = c.encode_points(pts), c.encode_points(qts)
    jP, jQ = jnp.asarray(jc.encode_points(pts)), jnp.asarray(jc.encode_points(qts))
    assert P.shape == (9, c.COORDS, c.fp.L)
    assert c.decode_points(c.add(P, Q)) == jc.decode_points(jc.add(jP, jQ))
    assert c.decode_points(c.dbl(P)) == jc.decode_points(jc.dbl(jP))
    assert c.decode_points(c.neg(P)) == jc.decode_points(jc.neg(jP))
    assert c.decode_points(c.add(P, Q)) == [gc.add(a, b) for a, b in zip(pts, qts)]
    assert c.decode_points(c.add(P, P)) == c.decode_points(c.dbl(P)) == [
        gc.add(a, a) for a in pts]
    ident = c.is_identity(c.add(P, c.neg(P)))
    assert bool(ident.all()) and not bool(c.is_identity(Q[:7]).any())


@pytest.mark.parametrize("name,jway", [("edwards25519", 2), ("edwards25519", 4),
                                       ("secp256k1", 2)])
def test_k2_plain_matches_pallas_joint_ladder(name, jway):
    c, jc, gc = triple(name)
    N = 2 * jway
    ks = scalars(jway, N)
    pts = golden_points(gc, N, 3)
    before = cc.joint_ladder_msm_grouped.launches
    got = cc.joint_ladder_msm_grouped(c, c.fn.encode_plain(ks), c.encode_points(pts),
                                      NBITS, jway)
    want = jax_joint_ladder(jc, jnp.asarray(jc.fn.encode_plain(ks)),
                            jnp.asarray(jc.encode_points(pts)), NBITS, jway,
                            interpret=True)
    assert got.shape == (2, c.COORDS, 8)
    assert c.decode_points(got) == jc.decode_points(want) == [
        golden_msm(gc, ks[g * jway:(g + 1) * jway], pts[g * jway:(g + 1) * jway])
        for g in range(2)]
    assert cc.joint_ladder_msm_grouped.launches == before


def test_k3_plain_matches_pallas_sum_points():
    c, jc, gc = triple("edwards25519")
    pts = golden_points(gc, 6, 1) + [None, None]
    P = c.encode_points(pts).reshape(2, 4, c.COORDS, 8)
    jP = jnp.asarray(jc.encode_points(pts)).reshape(2, 4, c.COORDS, -1)
    got = cc.sum_points_grouped(c, P)
    assert got.shape == (2, c.COORDS, 8)
    assert c.decode_points(got) == jc.decode_points(jax_sum_points(jc, jP, interpret=True))
    assert c.decode_points(tree_sum(c, P[:, :0])) == [None] * 2


@pytest.mark.parametrize("signed", [False, True])
def test_k4_plain_matches_pallas_fixed_lookup(signed):
    c, jc, gc = triple("edwards25519")
    N = 6
    ks = scalars(20 + signed, N)
    pts = golden_points(gc, N, 2)
    build = precompute_tables_signed if signed else precompute_tables
    jbuild = jax_precompute_tables_signed if signed else jax_precompute_tables
    table = build(c, c.encode_points(pts), NBITS)
    assert table.shape[0] == (8 if signed else 16)
    got = fixed_msm(c, c.fn.encode_plain(ks), table, NBITS)
    jtable = fixed_table_kernel_layout(jc, jbuild(jc, jnp.asarray(jc.encode_points(pts)),
                                                  NBITS))
    want = jax_fixed_msm_kernel(jc, jnp.asarray(jc.fn.encode_plain(ks)), jtable, NBITS,
                                signed=signed, interpret=True)
    assert c.decode_point(got) == jc.decode_point(want) == golden_msm(gc, ks, pts)


def test_plain_kernels_match_golden(curves):
    """The plain K2 (J = 4, zero-scalar identity padding), K3 (identity
    points, one empty group), K4 (unsigned and signed tables) and K5 of
    either family against golden at nbits = 16."""
    c, _, gc = curves
    ks = scalars(40, 8)
    pts = golden_points(gc, 6, 5) + [None, None]
    P, s = c.encode_points(pts), c.fn.encode_plain(ks)
    got = cc.joint_ladder_msm_grouped(c, s, P, NBITS, 4)
    assert c.decode_points(got) == [golden_msm(gc, ks[:4], pts[:4]),
                                    golden_msm(gc, ks[4:], pts[4:])]
    sums = cc.sum_points_grouped(c, P.reshape(2, 4, c.COORDS, c.fp.L))
    assert c.decode_points(sums) == [golden_msm(gc, [1] * 4, pts[:4]),
                                     golden_msm(gc, [1] * 4, pts[4:])]
    assert c.decode_points(tree_sum(c, P.reshape(2, 4, c.COORDS, c.fp.L)[:, :0])) == [None] * 2
    for build in (precompute_tables, precompute_tables_signed):
        table = build(c, P[:6], NBITS)
        got = fixed_msm(c, s[:6], table, NBITS)
        assert c.decode_point(got) == golden_msm(gc, ks[:6], pts[:6])
    got = cc.ladder_scalar_mul(c, s, P, NBITS)
    assert c.decode_points(got) == [gc.mul(p, k) for k, p in zip(ks, pts)]


def test_msm_and_scalar_mul_match_golden(curves):
    c, _, gc = curves
    ks = scalars(30, 5, nbits=c.fn.order_bits)
    pts = golden_points(gc, 5, 7)
    want = None
    for k, p in zip(ks, pts):
        want = gc.add(want, gc.mul(p, k))
    P = c.encode_points(pts)
    s = c.fn.encode_plain(ks)
    assert c.decode_point(msm(c, s, P)) == want
    assert c.decode_points(scalar_mul(c, s[:2], P[:2])) == [
        gc.mul(p, k) for k, p in zip(ks[:2], pts[:2])]


def test_partials_reduce_to_golden_msm(curves):
    """msm_partials (K2's group outputs) and fixed_msm_partials (K4's
    partials, both table flavors), each reduced by tree_sum and both in one
    tree_sum as the verifier's tail does, equal golden's MSMs; the unsigned
    lane digits, read as nibbles, equal the scalars' 4-bit windows."""
    c, _, gc = curves
    ks, fks = scalars(50, 7), scalars(51, 6)
    pts, fpts = golden_points(gc, 7, 4), golden_points(gc, 6, 20)
    s = c.fn.encode_plain(fks)
    for nbits in (NBITS, 15, c.fn.order_bits):     # nibble digits = the window digits
        nwin = -(-nbits // 4)
        assert torch.equal(cc.fixed_digits(c, s, nbits, False),
                           c.fn.scalar_digits(s, 4 * nwin).t().reshape(-1))
    var = msm_partials(c, c.fn.encode_plain(ks), c.encode_points(pts), NBITS)
    assert var.shape == (4, c.COORDS, c.fp.L)              # J = 2: 7 pairs pad to 8
    assert c.decode_point(tree_sum(c, var)) == golden_msm(gc, ks, pts)
    for build in (precompute_tables, precompute_tables_signed):
        table = build(c, c.encode_points(fpts), NBITS)
        fixed = fixed_msm_partials(c, c.fn.encode_plain(fks), table, NBITS)
        assert c.decode_point(tree_sum(c, fixed)) == golden_msm(gc, fks, fpts)
        both = tree_sum(c, torch.cat([var, fixed]))
        assert c.decode_point(both) == gc.add(golden_msm(gc, ks, pts), golden_msm(gc, fks, fpts))


@pytest.mark.parametrize("G,W,resident", [(1, 1, 264), (1, 9185, 264), (1, 1777, 528),
                                          (512, 257, 528), (256, 1025, 528), (7, 5, 264),
                                          (40, 70, 396), (3, 600, 30)])
def test_sum_layout_and_its_work(G, W, resident):
    """K3's layout covers each group with a power-of-two segment of a
    128-thread block, or with several blocks only where the card has room;
    and roofline.launch_work reads the same work from the launch whatever
    the layout: G·(W − 1) adds and G·W points read, G written."""
    from bulletproofsplus_tpu_torch import roofline

    seg, nblk, quads_first = cc.sum_layout(G, W, resident)
    assert seg & (seg - 1) == 0 and 1 <= seg <= cc.BLOCK and nblk >= 1
    assert 2 * seg >= W or seg == cc.BLOCK                  # about two points a thread
    assert nblk == 1 or (seg == cc.BLOCK and G * nblk <= resident and quads_first
                         and 2 * cc.BLOCK * (nblk - 1) < W)
    assert (nblk > 1) <= (4 * G < resident)               # only few groups spread
    for family, (add, _, _, pt) in roofline.FAMILIES.items():
        args = (0, 0, 0, G, W, seg, nblk, int(quads_first), None)
        assert roofline.launch_work(f"bpp_sum_points_{family}", args) == \
            (G * W * pt + G * pt, G * (W - 1) * add)


def test_fixed_base_mode_budget(curves):
    """268 MB at edwards25519's 2mn = 2048; 805 MB at secp256k1's 2mn =
    8192 (96-byte points); 4.83 GB at bls12-381's 2mn = 32768 (144-byte
    points); all unsigned under the 7 GiB budget."""
    c = curves[0]
    N, point = {"edwards25519": (2048, 128), "secp256k1": (8192, 96),
                "bls12_381": (32768, 144)}[c.name]
    assert table_bytes(c, N) == 16 * 64 * N * point
    nwin = c.fn.signed_window_count(c.fn.order_bits)     # 64 for 253 and 255 bits, 65 for 256
    assert table_bytes(c, N, signed=True) == 8 * nwin * N * point
    assert fixed_base_mode(c, N) == "unsigned"
    assert fixed_base_mode(c, N, max_bytes=table_bytes(c, N) - 1) == "signed"
    assert fixed_base_mode(c, N, max_bytes=1) is None


def test_publickey_from_jax_equals_port(curves):
    c, jc, _ = curves
    jpk = JaxPublicKey.new(jc, 16)
    got = convert.publickey_from_jax(jpk, c, "cpu")
    pk = PublicKey.new(c, 16, "cpu")
    for name in ("g", "h", "G_vec", "H_vec"):
        assert torch.equal(getattr(got, name), getattr(pk, name)), name


def test_kernel_entry_points_per_family():
    """Each point kernel has one entry point per family; launching any other
    name raises before the library is touched, and the roofline reads the
    family's products and point size off the name."""
    from bulletproofsplus_tpu_torch import kernels, roofline

    for kernel in ("joint_ladder", "sum_points", "fixed_lookup", "ladder"):
        for name in CURVE_NAMES:
            assert f"bpp_{kernel}_{curve_ops(name).FAMILY}" in kernels.SIGNATURES
    with pytest.raises(ValueError, match="no kernel entry point"):
        kernels.launch("bpp_joint_ladder_montgomery", device="cpu")
    args = (0, 0, 0, 10, 8, 64, None)        # 10 groups, J = 8, 64 windows
    ed = roofline.launch_work("bpp_joint_ladder_edwards", args)
    wei = roofline.launch_work("bpp_joint_ladder_weierstrass", args)
    assert ed == (10 * 8 * 160 + 10 * 128, 10 * (8 * 14 * 9 + 64 * (4 * 8 + 8 * 9)))
    assert wei == (10 * 8 * 128 + 10 * 96, 10 * (8 * 14 * 14 + 64 * (4 * 9 + 8 * 14)))
    wei12 = roofline.launch_work("bpp_joint_ladder_weierstrass12", args)
    assert wei12 == (10 * 8 * 176 + 10 * 144, wei[1])
    assert curve_ops("bls12_381").FAMILY == "weierstrass12"
    assert roofline.launch_words("bpp_joint_ladder_weierstrass12", args) == 12
    contiguous = (0, 100, 12, 0)             # 100 elements of 12 words, read in place
    assert roofline.launch_work("bpp_mont_mul", (*contiguous, *contiguous, 0, 100, 12, None)) \
        == (100 * 144, 100)
    assert roofline.fe_mul_mads(8) == 264 and roofline.fe_mul_mads(12) == 588
