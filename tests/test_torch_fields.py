"""The port's field layer (bulletproofsplus_tpu_torch.fields) against the JAX
package's FieldOps and its Pallas Montgomery kernel (interpret mode), on the
fields of every ported curve: 8 words a value, and 12 for bls12-381's Fq.

Inputs come from a numpy seed; both sides get the same integers and the
comparison is exact, on canonical integers (the two packages use different
limb layouts, so raw limbs are never compared)."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bulletproofsplus_tpu.curves import curve_ops as jax_curve_ops
from bulletproofsplus_tpu.fields import ALL_SPECS, field_ops
from bulletproofsplus_tpu.fields.pallas_ops import mont_mul as pallas_mont_mul
from bulletproofsplus_tpu_torch import convert, kernels, roofline
from bulletproofsplus_tpu_torch.curves import CURVE_NAMES, curve_ops
from bulletproofsplus_tpu_torch.fields import field_kernels as fk
from bulletproofsplus_tpu_torch.fields.mont_mul import (
    _norm16,
    _resolve,
    carry32,
    mont_mul,
    mont_mul_plain,
)
from bulletproofsplus_tpu_torch.fields.spec import int_to_words

# The port's CPU tests run tiny tensors: intra-op threads buy nothing at
# these sizes, and beside other xdist workers they oversubscribe the host (a
# bls12-381 batch prove took 28 s alone and 895 s beside three workers).
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ["fp", "fn"]


@pytest.fixture(autouse=True)
def release_jax_executables():
    """Drop the JAX package's compiled programs after each test, as
    test_torch_prove.py does: every XLA:CPU executable a jit cache keeps
    holds about a dozen memory maps, and a worker that also runs the JAX
    package's own tests nears the kernel's limit of 65,530 and crashes
    inside jax's compile cache. The persistent compilation cache reloads
    what a later test needs."""
    yield
    jax.clear_caches()


def rand_ints(seed, count, p):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % p for _ in range(count)]


def upper_half(seed, count, p):
    """Random values in [p/2, p): their sums pass p, and for a modulus above
    2^255 (secp256k1) also 2^256; bls12-381's Fq has 3 bits of headroom in
    2^384, so its sums never pass it."""
    return [p // 2 + x for x in rand_ints(seed, count, p - p // 2)]


def pair(which, curve="edwards25519"):
    """(port FieldOps, JAX FieldOps) of a curve's base or scalar field."""
    return getattr(curve_ops(curve), which), getattr(jax_curve_ops(curve), which)


@pytest.mark.parametrize("curve", CURVE_NAMES)
@pytest.mark.parametrize("which", FIELDS)
def test_ring_ops_match_jax(which, curve):
    """Against the JAX FieldOps and Python ints, on p − 1, p − 2,
    2^(32L) − 1 − p (2^384 − 1 − p for bls12-381's Fq) and random pairs from
    [p/2, p)."""
    f, jf = pair(which, curve)
    p = f.p
    edge = [p - 1, p - 2, ((1 << (32 * f.L)) - 1 - p) % p]
    xs = rand_ints(1, 12, p) + [0, 1, p - 1, p - 1] + edge * 3 + upper_half(3, 24, p)
    ys = rand_ints(2, 12, p) + [p - 1, 0, p - 1, 1] + edge + edge[::-1] + [1, 2, 3] \
        + upper_half(4, 24, p)
    a, b = f.encode(xs), f.encode(ys)
    ja, jb = jnp.asarray(jf.encode(xs)), jnp.asarray(jf.encode(ys))
    want = {"mul": [x * y % p for x, y in zip(xs, ys)],
            "add": [(x + y) % p for x, y in zip(xs, ys)],
            "sub": [(x - y) % p for x, y in zip(xs, ys)]}
    for op in ("mul", "add", "sub"):
        got = f.decode(getattr(f, op)(a, b))
        assert got == jf.decode(getattr(jf, op)(ja, jb)) == want[op], op
    assert f.decode(f.neg(a)) == jf.decode(jf.neg(ja))
    assert f.decode_plain(f.from_mont(a)) == jf.decode_plain(jf.from_mont(ja))
    assert f.decode(f.to_mont(f.from_mont(a))) == xs


@pytest.mark.parametrize("curve", CURVE_NAMES)
@pytest.mark.parametrize("which", FIELDS)
def test_batch_invert_and_powers_match_jax(which, curve):
    f, jf = pair(which, curve)
    p = f.p
    xs = rand_ints(3, 10, p)
    a = f.encode(xs).reshape(2, 5, f.L)
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


@pytest.mark.parametrize("curve,nbits", [("edwards25519", 16), ("edwards25519", 253),
                                         ("secp256k1", 256), ("bls12_381", 255)])
def test_scalar_digits_match_jax(curve, nbits):
    """253, 256 and 255 bits are the curves' order widths: 64 windows, and
    64 or 65 signed windows."""
    f, jf = pair("fn", curve)
    ks = rand_ints(4, 8, 1 << nbits) + [0, (1 << nbits) - 1]
    s, js = f.encode_plain(ks), jnp.asarray(jf.encode_plain(ks))
    got = f.scalar_digits(s, nbits)
    assert np.array_equal(got.numpy(), np.asarray(jf.scalar_digits(js, nbits)))
    mag, neg = f.scalar_digits_signed(s, nbits)
    jmag, jneg = jf.scalar_digits_signed(js, nbits)
    assert np.array_equal(mag.numpy(), np.asarray(jmag))
    assert np.array_equal(neg.numpy(), np.asarray(jneg))
    assert f.signed_window_count(nbits) == jf.signed_window_count(nbits)


@pytest.mark.parametrize("curve,which,name", [
    ("edwards25519", "fp", "ed25519_fp"), ("edwards25519", "fn", "ed25519_fl"),
    ("secp256k1", "fp", "secp256k1_fp"), ("secp256k1", "fn", "secp256k1_fn"),
    ("bls12_381", "fp", "bls12_381_fq"), ("bls12_381", "fn", "bls12_381_fr")])
def test_k1_plain_matches_pallas_interpret(curve, which, name):
    """K1's plain version against the TPU kernel it replaces, run in Pallas
    interpret mode on the 12-bit layout (as tests/test_pallas.py does); at
    bls12-381's Fq the port multiplies 12 words, the TPU 32 limbs."""
    ops = field_ops(ALL_SPECS[name])
    f = getattr(curve_ops(curve), which)
    p = ops.p
    assert f.p == p
    xs = rand_ints(5, 20, p) + [0, 1, p - 1, p - 2] + upper_half(7, 8, p)
    ys = rand_ints(6, 20, p) + [p - 1, 1, p - 1, 2] + upper_half(8, 8, p)
    want = ops.decode(pallas_mont_mul(ops, jnp.asarray(ops.encode(xs)),
                                      jnp.asarray(ops.encode(ys)), interpret=True))
    before = mont_mul.launches
    got = mont_mul(f.encode(xs), f.encode(ys), f.spec)
    assert f.decode(got) == want == [x * y % p for x, y in zip(xs, ys)]
    assert torch.equal(got, mont_mul_plain(f.encode(xs), f.encode(ys), f.spec))
    assert mont_mul.launches == before  # CPU tensors never launch the kernel


def carry_patterns(p, words=8):
    """Values of `words` 32-bit words whose word-wise sums and differences
    carry or borrow through long runs: all-ones and all-zero words,
    single-word holes, p − 1, p and 2^(32·words) − 1, alternating words, and
    a few random values."""
    bits = 32 * words
    top = (1 << bits) - 1
    out = [0, 1, 2, top, top - 1, p - 1, p, p + 1, 1 << (bits - 1), (1 << (bits - 1)) - 1,
           int("FFFFFFFF00000000" * (words // 2), 16), int("00000000FFFFFFFF" * (words // 2), 16)]
    out += [top ^ (0xFFFFFFFF << (32 * i)) for i in range(words)]    # one zero word
    out += [1 << (32 * i) for i in range(words)]                      # one set word
    return out + rand_ints(11, 4, 1 << bits)


@pytest.mark.parametrize("curve", CURVE_NAMES)
@pytest.mark.parametrize("which", FIELDS)
def test_carry32_on_carry_runs(which, curve):
    """Every pair of patterns, summed and subtracted limb by limb, against
    Python ints mod 2^(32L) with the carry (1) or borrow (−1) out, at the
    field's width L."""
    f = pair(which, curve)[0]
    bits = 32 * f.L
    vals = carry_patterns(f.p, f.L)
    xs = [x for x in vals for _ in vals]
    ys = [y for _ in vals for y in vals]
    a = torch.tensor([int_to_words(x, f.L) for x in xs], dtype=torch.int64)
    b = torch.tensor([int_to_words(y, f.L) for y in ys], dtype=torch.int64)

    def ints(limbs):
        return [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in limbs.tolist()]

    s, c = carry32(a + b)
    assert ints(s) == [(x + y) % (1 << bits) for x, y in zip(xs, ys)]
    assert c.tolist() == [(x + y) >> bits for x, y in zip(xs, ys)]
    d, bo = carry32(a - b, borrow=True)
    assert ints(d) == [(x - y) % (1 << bits) for x, y in zip(xs, ys)]
    assert bo.tolist() == [-1 if x < y else 0 for x, y in zip(xs, ys)]


@pytest.mark.parametrize("bits", [37, 56, 63])
def test_norm16_on_carry_runs(bits):
    """Columns up to 2^bits − 1 (2^63 − 1 is the most an int64 holds), and
    runs of 2^16 − 1 that a single carry ripples through, against Python
    ints."""
    L = 33
    hi, ones = (1 << bits) - 1, 0xFFFF
    rows = [[hi] * L, [ones] * L, [ones] * (L - 1) + [0], [0] * L,
            [1 << 16] + [ones] * (L - 1), [ones] * (L - 1) + [hi],
            [hi] + [ones] * (L - 1), [hi if i % 2 else 0 for i in range(L)]]
    rng = np.random.default_rng(12)
    rows += [[int(x) for x in rng.integers(0, hi, size=L, dtype=np.int64, endpoint=True)]
             for _ in range(4)]
    got = _norm16(torch.tensor(rows, dtype=torch.int64))
    for row, limbs in zip(rows, got.tolist()):
        want = sum(v << (16 * i) for i, v in enumerate(row)) % (1 << (16 * L))
        assert limbs == [(want >> (16 * i)) & 0xFFFF for i in range(L)]
    with pytest.raises(AssertionError):
        _resolve(torch.zeros(1, 63, dtype=torch.bool), torch.zeros(1, 63, dtype=torch.bool))


@pytest.mark.parametrize("curve", CURVE_NAMES)
@pytest.mark.parametrize("which", FIELDS)
def test_mont_mul_plain_on_carry_runs(which, curve):
    """K1's plain version and the plain add on the carry patterns reduced
    mod p (p − 1, p − 2, 2^(32L) − 1 − p, long one and zero runs) and values
    from [p/2, p), against a·b·2^−(32L) mod p and a + b mod p, at the field's
    width L. Above 2^255 (secp256k1) T + m·p passes 2^512 and a + b passes
    2^256."""
    f = pair(which, curve)[0]
    p, R = f.p, 1 << (32 * f.L)
    vals = sorted({v % p for v in carry_patterns(p, f.L)}
                  | {p - 1, p - 2, R % p, (R - 1 - p) % p}
                  | set(upper_half(13, 8, p)))
    xs = [x for x in vals for _ in vals]
    ys = [y for _ in vals for y in vals]
    a, b = f.encode_plain(xs), f.encode_plain(ys)
    rinv = pow(R, -1, p)
    assert f.decode_plain(mont_mul_plain(a, b, f.spec)) == [
        x * y * rinv % p for x, y in zip(xs, ys)]
    assert f.decode_plain(f.plain.add(a, b)) == [(x + y) % p for x, y in zip(xs, ys)]


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


def test_field_wrappers_raise_off_cpu_without_cuda():
    """The field kernels' wrappers, and FieldOps over them, raise on a
    device that is neither CPU nor CUDA; none falls back to its plain
    version."""
    f = curve_ops().fn
    a = f.encode([3, 4]).to("meta")
    for call in (lambda: fk.fe_add(a, a, f.spec), lambda: fk.fe_sub(a, a, f.spec),
                 lambda: fk.fe_neg(a, f.spec), lambda: fk.fe_sum(a, f.spec),
                 lambda: fk.fe_pow(a, f.p - 2, f.spec), lambda: f.add(a, a),
                 lambda: f.sub(a, a), lambda: f.neg(a), lambda: f.sum(a), lambda: f.inv(a)):
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("curve", CURVE_NAMES)
@pytest.mark.parametrize("which", FIELDS)
@pytest.mark.parametrize("layout", ["leading", "inner"])
def test_field_sum_matches_jax(which, curve, layout):
    """FieldOps.sum over the leading axis of a 3-D tensor (the verifier's sum
    over K proofs) and over an inner axis (the prover's sums over a row), at
    an odd and a power-of-two length, against the JAX FieldOps.sum and
    Python ints; values from [p/2, p) and p − 1 make every add carry."""
    f, jf = pair(which, curve)
    p = f.p
    for length in (7, 8):
        shape = (length, 3) if layout == "leading" else (2, length)
        axis = 0 if layout == "leading" else 1
        count = shape[0] * shape[1]
        xs = (upper_half(20 + length, count - 2, p) + [p - 1, p - 1])
        np.random.default_rng(length).shuffle(xs)
        a = f.encode(xs).reshape(*shape, f.L)
        ja = jnp.asarray(jf.encode(xs)).reshape(*shape, -1)
        rows = np.array(xs, dtype=object).reshape(shape)
        want = [int(v) % p for v in rows.sum(axis=axis)]
        got = f.decode(f.sum(a, axis=axis))
        assert got == jf.decode(jf.sum(ja, axis)) == want
        assert torch.equal(fk.fe_sum(a, f.spec, axis), fk.fe_sum_plain(a, f.spec, axis))


@pytest.mark.parametrize("curve", CURVE_NAMES)
@pytest.mark.parametrize("which", FIELDS)
def test_pow_const_and_inv_on_carry_edges(which, curve):
    """pow_const and inv (Fermat, a^(p−2)) on carry-edge values (p − 1,
    p − 2, long one and zero runs, 2^(32L) − 1 − p, values in [p/2, p))
    at the field's width, against Python ints; a^0 = 1."""
    f = pair(which, curve)[0]
    p, R = f.p, 1 << (32 * f.L)
    xs = sorted({v % p for v in carry_patterns(p, f.L)} - {0}
                | {p - 1, p - 2, (R - 1 - p) % p} | set(upper_half(15, 6, p)))
    a = f.encode(xs)
    assert f.decode(f.inv(a)) == [pow(x, -1, p) for x in xs]
    for e in (0, 1, 15, 16, 0xF0F0F):
        assert f.decode(f.pow_const(a, e)) == [pow(x, e, p) for x in xs]
    assert torch.equal(fk.fe_pow(a, p - 2, f.spec), f.plain.inv(a))


def test_field_ops_on_cpu_never_launch(monkeypatch):
    """On CPU tensors FieldOps runs the plain versions only: the exponent
    stage of a tiny aggregated batch launches no kernel."""
    from bulletproofsplus_tpu_torch.protocol.range import vinputs_multiple_batched

    def refuse(name, *args, device):
        raise AssertionError(f"{name} launched on CPU tensors")

    monkeypatch.setattr(kernels, "launch", refuse)
    f = curve_ops("secp256k1").fn
    K, n, m = 2, 4, 2
    logn = (n * m).bit_length() - 1
    vals = rand_ints(30, K * (6 + logn), f.p)
    one_each = [f.encode(vals[i * K:(i + 1) * K]) for i in range(6)]
    ch = f.encode(vals[6 * K:]).reshape(K, logn, f.L)
    y, z, e, r, s, d = one_each
    out = vinputs_multiple_batched(f, n, m, y, z, ch, e, r, s, d)
    assert [t.shape[0] for t in out] == [K] * 5


def test_operand_descriptors_read_broadcasts():
    """kernels.operand's (pointer, inner, s_inner, s_outer) reproduce each
    broadcast view the field kernels read, stride-0 operands and slices
    kept in place (no copy), against torch's own broadcast."""
    L = 8
    base = torch.arange(4 * 6 * L, dtype=torch.int32).reshape(4, 6, L)
    full = (4, 6, L)
    cases = [(base, full, True), (base[:, :1], full, True), (base[0, 0], full, True),
             (base[:, 3:], (4, 3, L), True), (base[:, ::2], (4, 3, L), True),
             (base.transpose(0, 1), (6, 4, L), True), (base[:1], full, True),
             (base.reshape(2, 2, 6, L)[:, :, :1], (2, 2, 6, L), True),
             (base[:, :, 1:5], (4, 6, 4), False)]
    for t, shape, in_place in cases:
        kept, ptr, inner, s_inner, s_outer = kernels.operand(t, shape)
        assert (kept.data_ptr() == t.data_ptr()) == in_place
        n = int(np.prod(shape[:-1]))
        storage = kept.untyped_storage()
        words = torch.tensor([], dtype=torch.int32).set_(storage)
        start = (ptr - storage.data_ptr()) // 4
        i = torch.arange(n)
        offs = start + (i // inner) * s_outer + (i % inner) * s_inner
        got = words[offs[:, None] + torch.arange(shape[-1])]
        assert torch.equal(got, t.expand(*shape).reshape(n, shape[-1]))


def test_every_entry_point_has_a_work_model():
    """roofline.launch_work bounds every C entry point of kernels.SIGNATURES,
    so chip_smoke.py and the profile script can bound any launch they
    record; the field kernels' models count what their arguments say."""
    import ctypes

    by_type = {kernels._P: 0, kernels._LL: 4, kernels._I: 8}
    # the chain's schedule argument holds its _I steps (8) of CHAIN_STEP_WORDS
    # words: one absorb of rows [0, 2) and one challenge each
    step = [1, 0x4C522020, 0, 2, 1, 0x65202020, 3, 0, 0]
    for name, types in kernels.SIGNATURES.items():
        args = tuple((ctypes.c_uint32 * 16)(*range(1, 17)) if t is kernels._U32P
                     else by_type[t] for t in types)
        if name == "bpp_fs256_chain":
            args = chain = (*args[:8], (ctypes.c_uint32 * 72)(*(step * 8)), *args[9:])
        nbytes, muls = roofline.launch_work(name, args)
        assert nbytes > 0 and muls >= 0, name
        assert roofline.bound([(name, args)])[0] > 0
    # K = 4 transcripts: 8 rows of 8 words and 2 states each, 8 challenges
    # of 32 bytes and 2 products each
    assert roofline.launch_work("bpp_fs256_chain", chain) == (4 * (8 * 8 * 4 + 64 + 8 * 32), 64)
    # a (K, 1, 8) operand broadcast over (K, W, 8) is read once, K = 4, W = 6
    bcast = (0, 6, 0, 8)
    assert roofline.launch_work("bpp_fe_add", (0, 24, 8, 0, *bcast, 0, 24, 8, None)) == \
        ((24 + 4 + 24) * 32, 0)
    e = 0x10F                      # windows 1, 0, F: 14 + 2·4 squarings + 1 product
    words = (ctypes.c_uint32 * 16)(e)
    assert roofline.launch_work("bpp_fe_pow", (0, 0, 10, 12, words, 3, None)) == \
        (10 * 2 * 48, 10 * (14 + 8 + 1))
    assert roofline.launch_work("bpp_fe_sum", (0, 0, 2, 256, 5, 8, None)) == (2 * 257 * 5 * 32, 0)


@pytest.mark.parametrize("montgomery", [True, False])
def test_convert_field_from_jax(montgomery):
    f, jf = pair("fn")
    xs = rand_ints(9, 6, f.p)
    arr = np.asarray(jf.encode(xs) if montgomery else jf.encode_plain(xs))
    got = convert.field_from_jax(arr.reshape(2, 3, -1), f, montgomery, device="cpu")
    assert got.shape == (2, 3, 8)
    assert (f.decode(got) if montgomery else f.decode_plain(got)) == xs
    twelve = field_ops(ALL_SPECS["ed25519_fl"])
    assert f.decode(convert.field_from_jax(twelve.encode(xs), f, device="cpu")) == xs


def test_convert_bls12_381_field_from_jax():
    """bls12-381 values of the JAX package (Fq: 32 limbs of 12 bits, R =
    2^384, or the CPU backend's layout; Fr: 22 limbs of 12 bits) carried to
    the port's 12 and 8 words, Montgomery and plain."""
    for which, name in (("fp", "bls12_381_fq"), ("fn", "bls12_381_fr")):
        f, jf = pair(which, "bls12_381")
        xs = rand_ints(14, 5, f.p) + [0, f.p - 1]
        got = convert.field_from_jax(np.asarray(jf.encode(xs)), f, device="cpu")
        assert got.shape == (7, f.L) and f.decode(got) == xs
        plain = convert.field_from_jax(np.asarray(jf.encode_plain(xs)), f, False, device="cpu")
        assert f.decode_plain(plain) == xs
        twelve = field_ops(ALL_SPECS[name])
        assert f.decode(convert.field_from_jax(twelve.encode(xs), f, device="cpu")) == xs
    assert curve_ops("bls12_381").fp.L == 12 and curve_ops("bls12_381").fn.L == 8


def test_port_imports_without_jax():
    """The port must never import jax: import it, the facade (config), the
    Merlin transcript, the distribution layer with its worker and the
    serving demo with jax blocked."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['bulletproofsplus_tpu'] = None; "
            "import bulletproofsplus_tpu_torch as bt; "
            "import bulletproofsplus_tpu_torch.convert, bulletproofsplus_tpu_torch.kernels; "
            "import bulletproofsplus_tpu_torch.config, bulletproofsplus_tpu_torch.merlin; "
            "import bulletproofsplus_tpu_torch.__main__; "
            "import bulletproofsplus_tpu_torch.parallel, bulletproofsplus_tpu_torch.parallel.worker; "
            "import bulletproofsplus_tpu_torch.serve_batch; "
            "print(bt.curve_ops().name, bt.curve_ops('secp256k1').COORDS, "
            "bt.curve_ops('bls12_381').fp.L, bt.Config().mode, bt.__version__)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "edwards25519 3 12 fs256 0.1.0"
