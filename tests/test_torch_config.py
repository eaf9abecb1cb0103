"""The port's facade (Config, RangeProofSystem), hash-derived generators,
public-key bytes, batch_verify_identify and the demo, against the JAX
package where it has a counterpart.

Hash-derived generators meet JAX `publickey._hash_to_point` (host code,
called directly) and the key's bytes meet JAX `publickey_to_bytes`, on all
three curves. The facade runs at edwards25519, n = 8, m = 2, K = 2 on the
CPU in each of its four modes, each system built once per module."""
import jax
import pytest
import torch

from bulletproofsplus_tpu import Config as JaxConfig
from bulletproofsplus_tpu import serialize as jax_serialize
from bulletproofsplus_tpu.curves import curve_ops as jax_curve_ops
from bulletproofsplus_tpu.protocol import publickey as jax_publickey
import bulletproofsplus_tpu_torch as bt
from bulletproofsplus_tpu_torch import __main__ as demo
from bulletproofsplus_tpu_torch import serialize
from bulletproofsplus_tpu_torch.curves import CURVE_NAMES
from bulletproofsplus_tpu_torch.errors import ProvingError
from bulletproofsplus_tpu_torch.protocol.publickey import hash_to_point

torch.set_num_threads(1)

CPU = "cpu"
N, M, K = 8, 2, 2
MODES = ("deterministic", "sha", "fs256", "merlin")


@pytest.fixture(autouse=True)
def release_jax_executables():
    """Drop the JAX package's compiled programs after each test, as the
    other port test files do."""
    yield
    jax.clear_caches()


def key_points(c, pk):
    return c.decode_points(torch.cat([pk.g[None], pk.h[None], pk.G_vec, pk.H_vec]))


# -- generators and key bytes --------------------------------------------------


@pytest.mark.parametrize("name", CURVE_NAMES)
def test_new_secure_matches_jax_hash_to_point(name):
    """Every generator of a length-4 key, [g, h, G_0..3, H_0..3], equals JAX
    _hash_to_point at its index (the Edwards and bls12-381 cofactors
    cleared, non-square candidates skipped), lies in the prime-order
    subgroup, and a custom label changes it."""
    c, jc = bt.curve_ops(name), jax_curve_ops(name)
    pk = bt.PublicKey.new_secure(c, 4, device=CPU)
    got = key_points(c, pk)
    assert got == [jax_publickey._hash_to_point(jc, b"bpp-tpu-gens", i) for i in range(10)]
    assert all(P is not None and c.host.in_subgroup(P) for P in got)
    assert len(set(got)) == 10
    other = c.host.to_affine([hash_to_point(c, b"other", 0)])[0]
    assert other == jax_publickey._hash_to_point(jc, b"other", 0) != got[0]


@pytest.mark.parametrize("name", CURVE_NAMES)
def test_publickey_bytes_match_jax_and_round_trip(name):
    """publickey_to_bytes equals JAX's on the same hash-derived key; the
    bytes decode to the same tensors; another curve's or cut bytes raise
    FormatError."""
    c, jc = bt.curve_ops(name), jax_curve_ops(name)
    pk = bt.PublicKey.new_secure(c, 4, device=CPU)
    data = serialize.publickey_to_bytes(c, pk)
    jpk = jax_publickey.PublicKey.new_secure(jc, 4)
    assert data == jax_serialize.publickey_to_bytes(jc, jpk)
    back = serialize.publickey_from_bytes(c, data, CPU)
    for f in ("g", "h", "G_vec", "H_vec"):
        assert torch.equal(getattr(back, f), getattr(pk, f))
    other = bt.curve_ops(CURVE_NAMES[(CURVE_NAMES.index(name) + 1) % 3])
    for bad in (data[:-1], data + b"\x00", data.replace(name.encode(), b"x" * len(name), 1)):
        with pytest.raises(bt.FormatError):
            serialize.publickey_from_bytes(c, bad, CPU)
    with pytest.raises(bt.FormatError):
        serialize.publickey_from_bytes(other, data, CPU)


# -- Config ------------------------------------------------------------------


@pytest.mark.parametrize("kwargs", [{"curve": "nist-p256"}, {"mode": "sha3"}],
                         ids=["curve", "mode"])
def test_config_validation_matches_jax(kwargs):
    """The JAX package's ValueErrors, with the same messages."""
    with pytest.raises(ValueError) as ours:
        bt.Config(**kwargs)
    with pytest.raises(ValueError) as theirs:
        JaxConfig(**kwargs)
    assert str(ours.value).split(";")[0] == str(theirs.value).split(";")[0]


def test_config_defaults_and_mesh():
    """The JAX package's defaults (fs256, hash-derived generators, no
    mesh); mesh_devices=2 on the CPU gives the facade a (1, 2) mesh that
    lists the CPU twice, as JAX's default_mesh(2) takes two devices."""
    assert bt.Config() == bt.Config(curve="edwards25519", n=64, m=1, mode="fs256",
                                    hash_generators=True, mesh_devices=None)
    assert dict(vars(bt.Config())) == dict(vars(JaxConfig()))
    assert bt.RangeProofSystem(bt.Config(n=N, m=M), device=CPU).mesh is None
    system = bt.RangeProofSystem(bt.Config(n=N, m=M, mesh_devices=2), device=CPU)
    assert system.mesh.shape == {"dp": 1, "tp": 2}
    assert system.mesh.devices == ((torch.device(CPU),) * 2,)


# -- the facade in each mode ----------------------------------------------------

_SYSTEMS: dict = {}


def system(mode):
    """(system, statements, batch): K = 2 statements proven in one batch,
    built once per module; deterministic mode with the reference's
    small-multiple key and explicit blinds (as the JAX test does)."""
    if mode not in _SYSTEMS:
        det = mode == "deterministic"
        sys_ = bt.RangeProofSystem(bt.Config(curve="edwards25519", n=N, m=M, mode=mode,
                                             hash_generators=not det), device=CPU)
        sts = [sys_.statement([2 + k, 5 + 3 * k], gammas=[3 + k, 7 + k] if det else None)
               for k in range(K)]
        _SYSTEMS[mode] = sys_, sts, sys_.batch_prove(sts)
    return _SYSTEMS[mode]


@pytest.mark.parametrize("mode", MODES)
def test_system_round_trip(mode):
    """batch_prove and batch_verify of K = 2 statements; a proof through its
    bytes verifies alone."""
    sys_, sts, batch = system(mode)
    assert isinstance(batch, bt.ProofBatch) and len(batch) == K
    sys_.batch_verify(batch, [s.commitments for s in sts])
    proof = sys_.proof_from_bytes(sys_.proof_to_bytes(batch[1]))
    sys_.verify(proof, sts[1].commitments)


def test_statement_validation():
    """Too many values, and deterministic mode without blinds, raise
    ProvingError (config.py:125-134)."""
    sys_, _, _ = system("deterministic")
    with pytest.raises(ProvingError):
        sys_.statement([1, 2, 3])
    with pytest.raises(ProvingError):
        sys_.statement([2, 5])


def test_deterministic_mode_matches_plain_prove():
    """The deterministic facade's proof equals `prove` with PublicKey.new,
    DeterministicTranscript and DeterministicRng (JAX test_config.py:46)."""
    sys_, _, batch = system("deterministic")
    c = bt.curve_ops("edwards25519")
    pk = bt.PublicKey.new(c, N * M, CPU)
    assert torch.equal(pk.G_vec, sys_.pk.G_vec)
    prover = bt.RangeProver()
    prover.commit(pk, 2, 3)
    prover.commit(pk, 5, 7)
    want = bt.prove(c, pk, N, prover, bt.DeterministicTranscript(M), bt.DeterministicRng(M))
    assert serialize.proof_to_bytes(c, batch[0]) == serialize.proof_to_bytes(c, want)


def test_batch_verify_identify_names_the_tampered_proof():
    """In sha mode, with fresh transcripts for every dispatch: [] for the
    clean batch, [1] with proof 1's s′ changed."""
    sys_, sts, batch = system("sha")
    comms = [s.commitments for s in sts]
    assert sys_.batch_verify_identify(batch, comms) == []
    bad = batch.take(slice(None))
    bad.s_prime = bad.s_prime.clone()
    bad.s_prime[1] = sys_.curve.fn.add(bad.s_prime[1], sys_.curve.fn.one(CPU))
    assert sys_.batch_verify_identify(bad, comms) == [1]


def test_demo_prints_ok(capsys):
    """`python -m bulletproofsplus_tpu_torch --n 8 --device cpu`."""
    demo.main(["--n", "8", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "curve=edwards25519 n=8 m=2 mode=secure (default) device=cpu"
    assert out[-1] == "ok"
