#!/usr/bin/env python
"""Write the golden-made proof fixture that the PyTorch port verifies.

The port's card-side drive (chip_smoke.py) cannot import the JAX package or
golden. It verifies statements proved here by the pure-Python golden oracle
in deterministic mode (DeterministicTranscript + DeterministicRng, statement
k's values and blindings drawn from random.Random(1000 + k)), and it proves
the same witnesses on the card, whose proofs must equal these bytes. Every
statement is checked with golden `protocol.verify` before it is written.

File format (all integers big-endian):
    b"BPPF1" | n:u8 | m:u8 | P:u16
    P times:  m commitments (32-byte compressed edwards25519 points)
              | proof_len:u16 | serialize.proof_to_bytes(...)

Usage: JAX_PLATFORMS=cpu python scripts/make_torch_fixtures.py [P] [n] [m] [procs]
(default 16 statements at n=64, m=16 on 8 processes, written to
bulletproofsplus_tpu_torch/data/ed25519_n{n}_m{m}_det.bin).
"""
from __future__ import annotations

import multiprocessing
import os
import random
import struct
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CURVE = "edwards25519"


def statement(args):
    """Prove and check statement k; returns (commitment bytes, proof bytes)."""
    k, n, m = args
    from bulletproofsplus_tpu import serialize
    from bulletproofsplus_tpu.golden import CURVES, PublicKey, RangeProver, protocol
    from bulletproofsplus_tpu.golden.protocol import (
        DeterministicRng,
        DeterministicTranscript,
    )

    gc = CURVES[CURVE]
    pk = PublicKey.new(gc, n * m)
    rnd = random.Random(1000 + k)
    prover = RangeProver()
    for _ in range(m):
        prover.commit(gc, pk, rnd.randrange(1 << n), rnd.randrange(1, gc.fn.p))
    proof = protocol.prove(gc, pk, n, prover, DeterministicTranscript(m),
                           DeterministicRng(m))
    protocol.verify(gc, proof, pk, n, prover.commitment_vec,
                    DeterministicTranscript(m))
    jcurve = _jax_curve()
    from bulletproofsplus_tpu.protocol.range import RangeProof

    wire = serialize.proof_to_bytes(jcurve, RangeProof.from_golden(jcurve, proof))
    comms = b"".join(serialize.point_bytes(jcurve, V)
                     for V in prover.commitment_vec)
    return comms, wire


def _jax_curve():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from bulletproofsplus_tpu.curves import curve_ops

    return curve_ops(CURVE)


def main(argv):
    P = int(argv[1]) if len(argv) > 1 else 16
    n = int(argv[2]) if len(argv) > 2 else 64
    m = int(argv[3]) if len(argv) > 3 else 16
    procs = int(argv[4]) if len(argv) > 4 else 8
    out = os.path.join(ROOT, "bulletproofsplus_tpu_torch", "data",
                       f"ed25519_n{n}_m{m}_det.bin")
    t0 = time.time()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(procs) as pool:
        rows = pool.map(statement, [(k, n, m) for k in range(P)])
    blob = bytearray(b"BPPF1" + struct.pack(">BBH", n, m, P))
    for comms, wire in rows:
        blob += comms + struct.pack(">H", len(wire)) + wire
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "wb") as f:
        f.write(bytes(blob))
    print(f"wrote {out}: {P} statements, {len(blob)} bytes, "
          f"{time.time() - t0:.1f} s")


if __name__ == "__main__":
    main(sys.argv)
