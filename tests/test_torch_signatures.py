"""The port's public signatures against the JAX package's, and the JAX
package's outcome on a batch that mixes aggregation sizes.

For every name that both packages export (top level, `protocol`,
`parallel`), and every public method of an exported class, JAX's
parameters (name, kind, default) must be a prefix of the port's, so a call
written for the JAX package binds the same way on the port; the port's own
extra parameters (`device`, `devices`, ...) come after. The exceptions are
listed below, each with its reason. Nothing here compiles: the signatures
are read with `inspect`, and the mixed batches raise before any work.
"""
import importlib
import inspect

import numpy as np
import pytest
import torch

import bulletproofsplus_tpu_torch as bt
from bulletproofsplus_tpu import serialize as jax_serialize
from bulletproofsplus_tpu.curves import curve_ops as jax_curve_ops
from bulletproofsplus_tpu.golden import CURVES, RangeProver, protocol
from bulletproofsplus_tpu.golden import PublicKey as GoldenPublicKey
from bulletproofsplus_tpu.golden.protocol import DeterministicRng
from bulletproofsplus_tpu.golden.protocol import DeterministicTranscript as GoldenDT
from bulletproofsplus_tpu.protocol.range import RangeProof as JaxRangeProof
from bulletproofsplus_tpu_torch import hashers_device, kernels, serialize
from bulletproofsplus_tpu_torch.curves import cuda_curve
from bulletproofsplus_tpu_torch.fields import field_kernels
from bulletproofsplus_tpu_torch.fields.mont_mul import mont_mul

torch.set_num_threads(1)

MODULES = ("", ".protocol", ".parallel")
# JAX parameters the port leaves out on purpose (ROADMAP A, "Left out on
# purpose"): each picks a TPU layout the port does not have.
EXCLUDED = {
    ("curve_ops", "limb_bits"): "the TPU's limb width; the port's limbs are 32-bit words",
    ("PublicKey.fixed_tables", "layout"): "the TPU's table layout; the port has one layout",
}
# JAX parameters without a default that the port gives one: every call
# written for the JAX package still binds the same way.
DEFAULTED = {
    ("curve_ops", "name"): "edwards25519, the port's first curve",
    ("DeterministicTranscript.round_challenge", "curve"): "the points are not read",
    ("DeterministicTranscript.round_challenge", "L"): "the points are not read",
    ("DeterministicTranscript.round_challenge", "R"): "the points are not read",
    ("DeterministicTranscript.final_challenge", "curve"): "the points are not read",
    ("DeterministicTranscript.final_challenge", "A"): "the points are not read",
    ("DeterministicTranscript.final_challenge", "B"): "the points are not read",
}
# names the JAX package exports and the port does not: the rest of ROADMAP
# A.3 (the next bring-up) and `synced_call` (XLA's compile/barrier split,
# not carried over)
JAX_ONLY = {".protocol": {"VerificationInputs", "verification_inputs",
                          "verification_scalars", "wip_prove"},
            ".parallel": {"synced_call"}}


def _modules(mod):
    return (importlib.import_module("bulletproofsplus_tpu" + mod),
            importlib.import_module("bulletproofsplus_tpu_torch" + mod))


def _cases():
    """(id, JAX callable, port callable) for every shared name with a
    signature and every public method both versions of a shared class have."""
    out = {}
    for mod in MODULES:
        jm, tm = _modules(mod)
        for name in sorted(set(jm.__all__) & set(tm.__all__)):
            jo, to = getattr(jm, name), getattr(tm, name)
            if not callable(jo) or inspect.ismodule(jo):
                continue
            if inspect.isclass(jo) and issubclass(jo, BaseException):
                continue
            out[f"{mod[1:] or 'top'}.{name}"] = (name, jo, to)
            if inspect.isclass(jo):
                for meth in sorted(set(dir(jo)) & set(dir(to))):
                    a, b = getattr(jo, meth), getattr(to, meth)
                    python = [inspect.isfunction(f) or inspect.ismethod(f) for f in (a, b)]
                    if meth.startswith("_") or not all(python):
                        continue
                    out[f"{mod[1:] or 'top'}.{name}.{meth}"] = (f"{name}.{meth}", a, b)
    return out


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_signature_extends_jax(case):
    """JAX's parameters, less EXCLUDED, are the port's first parameters:
    same names, kinds and defaults (a default only the port has is listed
    in DEFAULTED)."""
    qual, jo, to = CASES[case]
    jp = [p for p in inspect.signature(jo).parameters.values() if (qual, p.name) not in EXCLUDED]
    tp = list(inspect.signature(to).parameters.values())
    assert len(tp) >= len(jp), f"{case}: the port takes fewer parameters than JAX"
    empty = inspect.Parameter.empty
    for a, b in zip(jp, tp):
        assert (b.name, b.kind) == (a.name, a.kind), f"{case}: {b} where JAX has {a}"
        if (qual, a.name) in DEFAULTED:
            assert a.default is empty and b.default is not empty, case
        else:
            assert b.default == a.default, f"{case}: {b} where JAX has {a}"


def test_exceptions_name_real_parameters():
    """Every EXCLUDED and DEFAULTED entry names a JAX parameter of a shared
    name, so none outlives what it excuses; the names only the JAX package
    exports are JAX_ONLY's."""
    params = {(qual, p) for qual, jo, _ in CASES.values()
              for p in inspect.signature(jo).parameters}
    assert set(EXCLUDED) <= params and set(DEFAULTED) <= params
    for mod in MODULES:
        jm, tm = _modules(mod)
        assert set(jm.__all__) - set(tm.__all__) == JAX_ONLY.get(mod, set()), mod


@pytest.mark.parametrize("name", ["batch_verify", "batch_verify_identify"])
def test_jax_positional_call_binds_the_mesh(name):
    """C.4: `batch_verify(c, pk, n, proofs, V, trs, mesh)` written for the
    JAX package binds the mesh to `mesh`, not to `rng`."""
    mesh, rng = object(), object()
    bound = inspect.signature(getattr(bt, name)).bind(1, 2, 3, 4, 5, 6, mesh, rng)
    assert bound.arguments["mesh"] is mesh and bound.arguments["rng"] is rng


def test_parallel_signatures_take_jax_names():
    """C.5: stack_commitments(curve, lists), distributed_barrier(tag,
    timeout_ms), init_distributed(coordinator, num_processes, process_id)
    by keyword, as JAX callers write them; the barrier is a no-op in one
    process."""
    from bulletproofsplus_tpu_torch import parallel

    c = bt.curve_ops("edwards25519")
    pts = c.encode_points([None, None], "cpu")
    V = bt.stack_commitments(curve=c, commitment_lists=[[pts[0]], [pts[1]]])
    assert V.shape == (2, 1, c.COORDS, c.fp.L)
    assert bt.stack_commitments(c, V) is V
    parallel.distributed_barrier(tag="one process", timeout_ms=1000)
    assert list(inspect.signature(parallel.init_distributed).parameters) == [
        "coordinator", "num_processes", "process_id"]


N = 8


@pytest.fixture(scope="module")
def mixed():
    """ROADMAP A.3's probe: two golden deterministic proofs on edwards25519,
    n = 8, m = 2 and m = 1, as the port's proofs and commitment lists on
    the CPU, and a key long enough for both. (JAX batch_verify raised
    TypeError on these at batch.py:294 in both orders; it compiles for 78 s
    on a CPU, so the probe is cited, not rerun.)"""
    gc, jc = CURVES["edwards25519"], jax_curve_ops("edwards25519")
    c = bt.curve_ops("edwards25519")
    out = {}
    for m in (2, 1):
        gpk = GoldenPublicKey.new(gc, N * m)
        rng = np.random.default_rng(60 + m)
        prover = RangeProver()
        for _ in range(m):
            prover.commit(gc, gpk, int(rng.integers(0, 1 << N)),
                          int.from_bytes(rng.bytes(32), "little") % gc.fn.p)
        proof = protocol.prove(gc, gpk, N, prover, GoldenDT(m), DeterministicRng(m))
        wire = jax_serialize.proof_to_bytes(jc, JaxRangeProof.from_golden(jc, proof))
        out[m] = (serialize.proof_from_bytes(c, wire, "cpu"),
                  list(c.encode_points(prover.commitment_vec, "cpu").unbind(0)))
    return c, bt.PublicKey.new(c, 2 * N, "cpu"), out


def _counters():
    wrappers = (mont_mul, *field_kernels.WRAPPERS, cuda_curve.joint_ladder_msm_grouped,
                cuda_curve.sum_points_grouped, cuda_curve.fixed_lookup_partials,
                cuda_curve.ladder_scalar_mul, cuda_curve.bucket_accumulate,
                cuda_curve.bucket_merge, cuda_curve.bucket_reduce,
                hashers_device.sha256_words, hashers_device.fs256_chain)
    return [w.launches for w in wrappers]


@pytest.mark.parametrize("order", [(2, 1), (1, 2)])
@pytest.mark.parametrize("name", ["batch_verify", "batch_verify_identify"])
def test_mixed_aggregation_raises_type_error(mixed, monkeypatch, name, order):
    """A batch of proofs of m = 2 and m = 1, passed as lists, raises the
    TypeError the JAX package raises, naming both m's, in either order,
    before any launch; stack_commitments raises it on the lists alone."""
    c, pk, stmts = mixed

    def refuse(entry, *args, device):
        raise AssertionError(f"{entry} launched on a mixed batch")

    monkeypatch.setattr(kernels, "launch", refuse)
    proofs = [stmts[m][0] for m in order]
    lists = [stmts[m][1] for m in order]
    before = _counters()
    with pytest.raises(TypeError, match=r"m = \[1, 2\]"):
        getattr(bt, name)(c, pk, N, proofs, lists)
    with pytest.raises(TypeError, match=r"m = \[1, 2\]"):
        bt.stack_commitments(c, lists)
    assert _counters() == before


def test_one_aggregation_batches_still_verify(mixed):
    """The check lets a batch of one m through: each probe proof verifies
    alone, as a list of one, on the CPU."""
    c, pk, stmts = mixed
    for m, (proof, V) in stmts.items():
        bt.batch_verify(c, pk, N, [proof], [V], [bt.DeterministicTranscript(m)])
