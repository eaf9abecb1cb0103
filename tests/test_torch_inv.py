"""The divstep inversion's plain version (fields/field_kernels.py::
fe_inv_plain, the algorithm of csrc/field_ops.cu's fe_inv) against the JAX
package's FieldOps.inv (a^(p − 2)), the port's fe_pow_plain(a, p − 2) and
Python's pow(x, −1, p), on all six fields of the three curves.

Elements: 0 (which both inversions map to 0), 1, p − 1, powers of two,
values whose words run all ones or all zeros, and random values from a
numpy seed. The divstep count each element needs is counted with Python
integers and must stay within the fixed count the kernel runs
(FieldSpec.divsteps, Bernstein and Yang's bound)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bulletproofsplus_tpu.curves import curve_ops as jax_curve_ops
from bulletproofsplus_tpu_torch.curves import CURVE_NAMES, curve_ops
from bulletproofsplus_tpu_torch.fields import field_kernels as fk
from bulletproofsplus_tpu_torch.fields.spec import DIVSTEP_BLOCK, INV_LIMBS_MAX

torch.set_num_threads(1)

FIELDS = [(curve, which) for curve in CURVE_NAMES for which in ("fp", "fn")]
# the modulus's divsteps (⌊(49d + 57)/17⌋ for d bits) and 30-step blocks
BOUNDS = {("edwards25519", "fp"): (738, 25), ("edwards25519", "fn"): (732, 25),
          ("secp256k1", "fp"): (741, 25), ("secp256k1", "fn"): (741, 25),
          ("bls12_381", "fp"): (1101, 37), ("bls12_381", "fn"): (738, 25)}


@pytest.fixture(autouse=True)
def release_jax_executables():
    """Drop the JAX package's compiled programs after each test (the memory
    maps an XLA:CPU executable holds; see tests/test_torch_fields.py)."""
    yield
    jax.clear_caches()


def elements(p: int, words: int, seed: int) -> list:
    """0, 1, 2, p − 1, p − 2, powers of two, words of all ones or all zeros
    under and over each other, and random values, all below p."""
    rng = np.random.default_rng(seed)
    ones = [((1 << (32 * w)) - 1) % p for w in range(1, words)]
    high = [((1 << (32 * words)) - (1 << (32 * w))) % p for w in range(1, words)]
    runs = [sum(int(rng.choice([0, 0xFFFFFFFF])) << (32 * i) for i in range(words)) % p
            for _ in range(8)]
    rand = [int.from_bytes(rng.bytes(48), "little") % p for _ in range(12)]
    return ([0, 1, 2, p - 1, p - 2, p // 2] + [1 << k for k in range(0, p.bit_length() - 1, 37)]
            + ones + high + runs + rand)


def divsteps_needed(p: int, x: int) -> int:
    """Divsteps from (δ, f, g) = (1, p, x) until g = 0, in Python integers."""
    delta, f, g, n = 1, p, x, 0
    while g:
        if delta > 0 and g & 1:
            delta, f, g = 1 - delta, g, (g - f) // 2
        else:
            delta, g = 1 + delta, (g + (g & 1) * f) // 2
        n += 1
    return n


@pytest.mark.parametrize("curve,which", FIELDS)
def test_fe_inv_plain_matches_pow_and_python(curve, which):
    """Word for word fe_pow_plain(a, p − 2), and pow(x, −1, p) as integers
    (0 ↦ 0); FieldOps.inv on the CPU is fe_inv_plain."""
    f = getattr(curve_ops(curve), which)
    p = f.p
    xs = elements(p, f.L, 1)
    a = f.encode(xs)
    got = fk.fe_inv_plain(a, f.spec)
    assert torch.equal(got, fk.fe_pow_plain(a, p - 2, f.spec))
    assert f.decode(got) == [pow(x, -1, p) if x else 0 for x in xs]
    half = len(xs) // 2
    assert torch.equal(f.inv(a), got)
    assert torch.equal(f.plain.inv(a[:2 * half].reshape(2, half, f.L)),
                       got[:2 * half].reshape(2, half, f.L))


@pytest.mark.parametrize("curve,which", [("edwards25519", "fp"), ("secp256k1", "fn"),
                                         ("bls12_381", "fn")])
def test_fe_inv_plain_matches_jax(curve, which):
    """Against the JAX package's FieldOps.inv (a^(p − 2), fields/ops.py:339)
    on the nonzero elements, compared as integers: one field a curve, each
    JAX inversion a compile of some 6 s on a CPU. Every field, bls12-381's
    Fq too, meets JAX through batch_invert, one inversion a slice
    (tests/test_torch_fields.py::test_batch_invert_and_powers_match_jax),
    and pow and Python's integers in the test above."""
    f, jf = getattr(curve_ops(curve), which), getattr(jax_curve_ops(curve), which)
    xs = [x for x in elements(f.p, f.L, 2) if x]
    want = jf.decode(jf.inv(jnp.asarray(jf.encode(xs))))
    assert f.decode(fk.fe_inv_plain(f.encode(xs), f.spec)) == want


@pytest.mark.parametrize("curve,which", FIELDS)
def test_divstep_count_suffices(curve, which):
    """The kernel's fixed count is the bound for the modulus's bits, in whole
    blocks, and covers every element here (the worst of them needs fewer)."""
    spec = getattr(curve_ops(curve), which).spec
    assert (spec.divsteps, spec.divstep_blocks) == BOUNDS[(curve, which)]
    need = max(divsteps_needed(spec.modulus, x)
               for x in elements(spec.modulus, spec.num_limbs, 3))
    assert need <= spec.divsteps <= DIVSTEP_BLOCK * spec.divstep_blocks


@pytest.mark.parametrize("curve,which", FIELDS)
def test_inv_consts_layout(curve, which):
    """FieldSpec.inv_consts, the kernel's InvConsts: the divstep count,
    p⁻¹ mod 2^30, then p and R² mod p in 30-bit limbs."""
    spec = getattr(curve_ops(curve), which).spec
    w = list(spec.inv_consts)
    assert len(w) == 2 + 2 * INV_LIMBS_MAX and w[0] == spec.divsteps
    assert w[1] * spec.modulus % (1 << DIVSTEP_BLOCK) == 1

    def value(limbs):
        return sum(x << (DIVSTEP_BLOCK * i) for i, x in enumerate(limbs))

    assert value(w[2:2 + INV_LIMBS_MAX]) == spec.modulus
    assert value(w[2 + INV_LIMBS_MAX:]) == spec.r2_mod_p
    assert spec.s30_limbs == (9 if spec.num_limbs == 8 else 13)
