"""The port's point layer and the plain versions of kernels K2–K4 against the
JAX package's curve ops and its Pallas kernels in interpret mode.

Points are compared as decoded affine tuples (canonical integers); scalars
come from a numpy seed. nbits = 16 keeps the interpret-mode ladders short,
as tests/test_pallas.py does."""
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
from bulletproofsplus_tpu_torch.curves import cuda_curve as cc
from bulletproofsplus_tpu_torch.curves import curve_ops
from bulletproofsplus_tpu_torch.msm import msm, scalar_mul, tree_sum
from bulletproofsplus_tpu_torch.msm.fixed import (
    fixed_base_mode,
    fixed_msm,
    precompute_tables,
    precompute_tables_signed,
    table_bytes,
)

NAME = "edwards25519"
NBITS = 16


@pytest.fixture(scope="module")
def curves():
    return curve_ops(), jax_curve_ops(NAME), golden_curve(NAME)


def golden_points(gc, count, start):
    return [gc.mul(gc.base(), start + i) for i in range(count)]


def scalars(seed, count, nbits=NBITS):
    rng = np.random.default_rng(seed)
    ks = [int.from_bytes(rng.bytes(32), "little") % (1 << nbits)
          for _ in range(count - 2)]
    return ks + [0, 1]


def test_point_ops_match_jax(curves):
    c, jc, gc = curves
    pts = golden_points(gc, 6, 3) + [None]
    qts = golden_points(gc, 6, 11) + [gc.base()]
    P, Q = c.encode_points(pts), c.encode_points(qts)
    jP, jQ = jnp.asarray(jc.encode_points(pts)), jnp.asarray(jc.encode_points(qts))
    assert c.decode_points(c.add(P, Q)) == jc.decode_points(jc.add(jP, jQ))
    assert c.decode_points(c.dbl(P)) == jc.decode_points(jc.dbl(jP))
    assert c.decode_points(c.neg(P)) == jc.decode_points(jc.neg(jP))
    assert c.decode_points(c.add(P, Q)) == [gc.add(a, b) for a, b in zip(pts, qts)]
    ident = c.is_identity(c.add(P, c.neg(P)))
    assert bool(ident.all()) and not bool(c.is_identity(Q).any())


@pytest.mark.parametrize("jway", [2, 4])
def test_k2_plain_matches_pallas_joint_ladder(curves, jway):
    c, jc, gc = curves
    N = 2 * jway
    ks = scalars(jway, N)
    pts = golden_points(gc, N, 3)
    before = cc.joint_ladder_msm_grouped.launches
    got = cc.joint_ladder_msm_grouped(c, c.fn.encode_plain(ks), c.encode_points(pts),
                                      NBITS, jway)
    want = jax_joint_ladder(jc, jnp.asarray(jc.fn.encode_plain(ks)),
                            jnp.asarray(jc.encode_points(pts)), NBITS, jway,
                            interpret=True)
    assert got.shape == (2, 4, 8)
    assert c.decode_points(got) == jc.decode_points(want)
    assert cc.joint_ladder_msm_grouped.launches == before


def test_k3_plain_matches_pallas_sum_points(curves):
    c, jc, gc = curves
    pts = golden_points(gc, 6, 1) + [None, None]
    P = c.encode_points(pts).reshape(2, 4, 4, 8)
    jP = jnp.asarray(jc.encode_points(pts)).reshape(2, 4, 4, -1)
    got = cc.sum_points_grouped(c, P)
    assert got.shape == (2, 4, 8)
    assert c.decode_points(got) == jc.decode_points(jax_sum_points(jc, jP, interpret=True))
    assert c.decode_points(tree_sum(c, P[:, :0])) == [None] * 2


@pytest.mark.parametrize("signed", [False, True])
def test_k4_plain_matches_pallas_fixed_lookup(curves, signed):
    c, jc, gc = curves
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
    expect = None
    for k, p in zip(ks, pts):
        expect = gc.add(expect, gc.mul(p, k))
    assert c.decode_point(got) == jc.decode_point(want) == expect


def test_msm_and_scalar_mul_match_golden(curves):
    c, _, gc = curves
    ks = scalars(30, 5, nbits=253)
    pts = golden_points(gc, 5, 7)
    want = None
    for k, p in zip(ks, pts):
        want = gc.add(want, gc.mul(p, k))
    P = c.encode_points(pts)
    s = c.fn.encode_plain(ks)
    assert c.decode_point(msm(c, s, P)) == want
    assert c.decode_points(scalar_mul(c, s[:2], P[:2])) == [
        gc.mul(p, k) for k, p in zip(ks[:2], pts[:2])]


def test_fixed_base_mode_budget(curves):
    c = curves[0]
    assert table_bytes(c, 2048) == 16 * 64 * 2048 * 128  # 268 MB at 2mn = 2048
    assert fixed_base_mode(c, 2048) == "unsigned"
    assert fixed_base_mode(c, 2048, max_bytes=table_bytes(c, 2048) - 1) == "signed"
    assert fixed_base_mode(c, 2048, max_bytes=1) is None


def test_publickey_from_jax_equals_port(curves):
    c, jc, _ = curves
    jpk = JaxPublicKey.new(jc, 16)
    got = convert.publickey_from_jax(jpk, c, "cpu")
    pk = PublicKey.new(c, 16, "cpu")
    for name in ("g", "h", "G_vec", "H_vec"):
        assert torch.equal(getattr(got, name), getattr(pk, name)), name
