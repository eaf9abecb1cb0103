#!/usr/bin/env python
"""Write the golden-made proof fixture that the PyTorch port verifies.

The port's card-side drive (chip_smoke.py) cannot import the JAX package or
golden. It verifies statements proved here by the pure-Python golden oracle
in deterministic mode (DeterministicTranscript + DeterministicRng, statement
k's values and blindings drawn from random.Random(1000 + k)), and it proves
the same witnesses on the card, whose proofs must equal these bytes. Every
statement is checked with golden `protocol.verify` before it is written.

File format (all integers big-endian), read by
bulletproofsplus_tpu_torch.serialize.read_fixture:
    b"BPPF2" | name_len:u8 | curve name | n:u16 | m:u16 | P:u16
    P times:  m commitments (compressed points of the curve: 32 bytes on
              edwards25519, 33 on secp256k1) | proof_len:u16 |
              serialize.proof_to_bytes(...)
The committed edwards25519 fixture predates this format and is BPPF1:
b"BPPF1" | n:u8 | m:u8 | P:u16, then the same rows (edwards25519 implied).

Usage: JAX_PLATFORMS=cpu python scripts/make_torch_fixtures.py [P] [n] [m] [procs]
       [--curve edwards25519|secp256k1]
(default 16 statements at n=64, m=16 on 8 processes on edwards25519, written
to bulletproofsplus_tpu_torch/data/<prefix>_n{n}_m{m}_det.bin with prefix
ed25519 or secp256k1). The secp256k1 fixture is
`... make_torch_fixtures.py 8 64 64 8 --curve secp256k1`.
"""
from __future__ import annotations

import argparse
import multiprocessing
import os
import random
import struct
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
PREFIX = {"edwards25519": "ed25519", "secp256k1": "secp256k1",
          "bls12_381": "bls12_381"}


def statement(args):
    """Prove and check statement k; returns (commitment bytes, proof bytes)."""
    curve, k, n, m = args
    from bulletproofsplus_tpu import serialize
    from bulletproofsplus_tpu.golden import CURVES, PublicKey, RangeProver, protocol
    from bulletproofsplus_tpu.golden.protocol import (
        DeterministicRng,
        DeterministicTranscript,
    )

    gc = CURVES[curve]
    pk = PublicKey.new(gc, n * m)
    rnd = random.Random(1000 + k)
    prover = RangeProver()
    for _ in range(m):
        prover.commit(gc, pk, rnd.randrange(1 << n), rnd.randrange(1, gc.fn.p))
    proof = protocol.prove(gc, pk, n, prover, DeterministicTranscript(m),
                           DeterministicRng(m))
    protocol.verify(gc, proof, pk, n, prover.commitment_vec,
                    DeterministicTranscript(m))
    jcurve = _jax_curve(curve)
    from bulletproofsplus_tpu.protocol.range import RangeProof

    wire = serialize.proof_to_bytes(jcurve, RangeProof.from_golden(jcurve, proof))
    comms = b"".join(serialize.point_bytes(jcurve, V)
                     for V in prover.commitment_vec)
    return comms, wire


def _jax_curve(curve):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from bulletproofsplus_tpu.curves import curve_ops

    return curve_ops(curve)


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("P", type=int, nargs="?", default=16)
    ap.add_argument("n", type=int, nargs="?", default=64)
    ap.add_argument("m", type=int, nargs="?", default=16)
    ap.add_argument("procs", type=int, nargs="?", default=8)
    ap.add_argument("--curve", choices=sorted(PREFIX), default="edwards25519")
    args = ap.parse_args(argv[1:])
    P, n, m = args.P, args.n, args.m
    out = os.path.join(ROOT, "bulletproofsplus_tpu_torch", "data",
                       f"{PREFIX[args.curve]}_n{n}_m{m}_det.bin")
    t0 = time.time()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(args.procs) as pool:
        rows = pool.map(statement, [(args.curve, k, n, m) for k in range(P)])
    name = args.curve.encode()
    blob = bytearray(b"BPPF2" + bytes([len(name)]) + name + struct.pack(">HHH", n, m, P))
    for comms, wire in rows:
        blob += comms + struct.pack(">H", len(wire)) + wire
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "wb") as f:
        f.write(bytes(blob))
    print(f"wrote {out}: {P} statements, {len(blob)} bytes, "
          f"{time.time() - t0:.1f} s")


if __name__ == "__main__":
    main(sys.argv)
