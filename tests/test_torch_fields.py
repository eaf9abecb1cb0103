"""The port's field layer (bulletproofsplus_tpu_torch.fields) against the JAX
package's FieldOps and its Pallas Montgomery kernel (interpret mode).

Inputs come from a numpy seed; both sides get the same integers and the
comparison is exact, on canonical integers (the two packages use different
limb layouts, so raw limbs are never compared)."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bulletproofsplus_tpu.curves import curve_ops as jax_curve_ops
from bulletproofsplus_tpu.fields import ALL_SPECS, field_ops
from bulletproofsplus_tpu.fields.pallas_ops import mont_mul as pallas_mont_mul
from bulletproofsplus_tpu_torch import convert
from bulletproofsplus_tpu_torch.curves import curve_ops
from bulletproofsplus_tpu_torch.fields.mont_mul import mont_mul, mont_mul_plain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ["fp", "fn"]


def rand_ints(seed, count, p):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % p for _ in range(count)]


def pair(which):
    """(port FieldOps, JAX FieldOps) of edwards25519's base or scalar field."""
    return getattr(curve_ops(), which), getattr(jax_curve_ops("edwards25519"), which)


@pytest.mark.parametrize("which", FIELDS)
def test_ring_ops_match_jax(which):
    f, jf = pair(which)
    p = f.p
    xs = rand_ints(1, 12, p) + [0, 1, p - 1, p - 1]
    ys = rand_ints(2, 12, p) + [p - 1, 0, p - 1, 1]
    a, b = f.encode(xs), f.encode(ys)
    ja, jb = jnp.asarray(jf.encode(xs)), jnp.asarray(jf.encode(ys))
    for op in ("mul", "add", "sub"):
        got = f.decode(getattr(f, op)(a, b))
        assert got == jf.decode(getattr(jf, op)(ja, jb)), op
    assert f.decode(f.neg(a)) == jf.decode(jf.neg(ja))
    assert f.decode_plain(f.from_mont(a)) == jf.decode_plain(jf.from_mont(ja))
    assert f.decode(f.to_mont(f.from_mont(a))) == xs


@pytest.mark.parametrize("which", FIELDS)
def test_batch_invert_and_powers_match_jax(which):
    f, jf = pair(which)
    p = f.p
    xs = rand_ints(3, 10, p)
    a = f.encode(xs).reshape(2, 5, 8)
    ja = jnp.asarray(jf.encode(xs)).reshape(2, 5, -1)
    allinv, invs = f.batch_invert(a, axis=1)
    jall, jinvs = jf.batch_invert(ja, axis=1)
    assert f.decode(invs) == jf.decode(jinvs.reshape(10, -1))
    assert f.decode(allinv) == jf.decode(jall)
    assert f.decode(invs) == [pow(x, -1, p) for x in xs]
    pw = f.powers_type2(f.encode(xs[0]), 9)
    assert f.decode(pw) == jf.decode(jf.powers_type2(jnp.asarray(jf.encode(xs[0])), 9))
    assert f.decode(f.sum(f.encode(xs))) == jf.decode(jf.sum(jnp.asarray(jf.encode(xs))))
    assert f.decode(f.pow_const(f.encode(xs[1]), 12345)) == pow(xs[1], 12345, p)


@pytest.mark.parametrize("nbits", [16, 253])
def test_scalar_digits_match_jax(nbits):
    f, jf = pair("fn")
    ks = rand_ints(4, 8, 1 << nbits) + [0, (1 << nbits) - 1]
    s, js = f.encode_plain(ks), jnp.asarray(jf.encode_plain(ks))
    got = f.scalar_digits(s, nbits)
    assert np.array_equal(got.numpy(), np.asarray(jf.scalar_digits(js, nbits)))
    mag, neg = f.scalar_digits_signed(s, nbits)
    jmag, jneg = jf.scalar_digits_signed(js, nbits)
    assert np.array_equal(mag.numpy(), np.asarray(jmag))
    assert np.array_equal(neg.numpy(), np.asarray(jneg))
    assert f.signed_window_count(nbits) == jf.signed_window_count(nbits)


@pytest.mark.parametrize("name", ["ed25519_fp", "ed25519_fl"])
def test_k1_plain_matches_pallas_interpret(name):
    """K1's plain version against the TPU kernel it replaces, run in Pallas
    interpret mode on the 12-bit layout (as tests/test_pallas.py does)."""
    ops = field_ops(ALL_SPECS[name])
    f = curve_ops().fp if name == "ed25519_fp" else curve_ops().fn
    p = ops.p
    xs = rand_ints(5, 20, p) + [0, 1, p - 1, p - 2]
    ys = rand_ints(6, 20, p) + [p - 1, 1, p - 1, 2]
    want = ops.decode(pallas_mont_mul(ops, jnp.asarray(ops.encode(xs)),
                                      jnp.asarray(ops.encode(ys)), interpret=True))
    before = mont_mul.launches
    got = mont_mul(f.encode(xs), f.encode(ys), f.spec)
    assert f.decode(got) == want == [x * y % p for x, y in zip(xs, ys)]
    assert torch.equal(got, mont_mul_plain(f.encode(xs), f.encode(ys), f.spec))
    assert mont_mul.launches == before  # CPU tensors never launch the kernel


def test_k1_broadcasts_like_pallas_wrapper():
    f = curve_ops().fp
    xs = rand_ints(7, 6, f.p)
    y = rand_ints(8, 1, f.p)[0]
    got = mont_mul(f.encode(xs).reshape(2, 3, 8), f.encode(y), f.spec)
    assert got.shape == (2, 3, 8)
    assert f.decode(got) == [x * y % f.p for x in xs]


def test_wrappers_raise_off_cpu_without_cuda():
    """On a device that is neither CPU nor CUDA a wrapper raises; it never
    falls back to the plain version."""
    f = curve_ops().fp
    a = f.encode([3, 4]).to("meta")
    with pytest.raises(ValueError):
        mont_mul(a, a, f.spec)


@pytest.mark.parametrize("montgomery", [True, False])
def test_convert_field_from_jax(montgomery):
    f, jf = pair("fn")
    xs = rand_ints(9, 6, f.p)
    arr = np.asarray(jf.encode(xs) if montgomery else jf.encode_plain(xs))
    got = convert.field_from_jax(arr.reshape(2, 3, -1), f, montgomery)
    assert got.shape == (2, 3, 8)
    assert (f.decode(got) if montgomery else f.decode_plain(got)) == xs
    twelve = field_ops(ALL_SPECS["ed25519_fl"])
    assert f.decode(convert.field_from_jax(twelve.encode(xs), f)) == xs


def test_port_imports_without_jax():
    """The port must never import jax: import it with jax blocked."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['bulletproofsplus_tpu'] = None; "
            "import bulletproofsplus_tpu_torch as bt; "
            "import bulletproofsplus_tpu_torch.convert, bulletproofsplus_tpu_torch.kernels; "
            "print(bt.curve_ops().name)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "edwards25519"
