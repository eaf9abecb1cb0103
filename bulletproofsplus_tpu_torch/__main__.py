"""`python -m bulletproofsplus_tpu_torch`: the reference's demo on the card.

Port of bulletproofsplus_tpu/__main__.py:1-68, the reference's
src/main.rs:6-57: build a 2n-generator key, commit (v = 2, γ = 3) and
(v = 5, γ = 7), prove an aggregated range proof (m = 2), verify it and print
the times. By default the transcript is the sound fs256 one with random
blinds; --reference replays the reference's constants (bit-exact parity
mode). --device picks the device, the CUDA card by default ("cpu" runs the
plain PyTorch versions of the kernels).
"""
from __future__ import annotations

import argparse
import time


def main(argv=None) -> None:
    from . import (
        DeterministicRng,
        DeterministicTranscript,
        PublicKey,
        RangeProver,
        curve_ops,
        prove,
        verify,
    )
    from .curves import CURVE_NAMES
    from .device import entry_device

    ap = argparse.ArgumentParser(prog="bulletproofsplus_tpu_torch")
    ap.add_argument("--curve", default="edwards25519", choices=list(CURVE_NAMES))
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--reference", action="store_true",
                    help="reference-constant challenges and blinds (bit-exact "
                         "parity mode; default is the sound Fiat-Shamir "
                         "transcript with random blinds)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    args = ap.parse_args(argv)

    device = entry_device(args.device)
    curve = curve_ops(args.curve)
    n, m = args.n, 2
    mode = "deterministic (reference parity)" if args.reference else "secure (default)"
    print(f"curve={args.curve} n={n} m={m} mode={mode} device={device}")

    t0 = time.time()
    pk = PublicKey.new(curve, n * m, device)                  # main.rs:14
    print(f"setup: {time.time() - t0:.2f}s ({2 * n * m + 2} generators)")

    prover = RangeProver()
    prover.commit(pk, 2, 3)                                   # main.rs:18-21
    prover.commit(pk, 5, 7)                                   # main.rs:22-25

    kw = ({"transcript": DeterministicTranscript(m), "rng": DeterministicRng(m)}
          if args.reference else {})
    t0 = time.time()
    proof = prove(curve, pk, n, prover, **kw)                 # main.rs:29
    print(f"prove: {time.time() - t0:.2f}s")

    vkw = {"transcript": DeterministicTranscript(m)} if args.reference else {}
    t0 = time.time()
    verify(curve, proof, pk, n, prover.commitment_vec, **vkw)  # main.rs:49
    print(f"verify: {time.time() - t0:.2f}s")
    print("ok")                                               # main.rs:56


if __name__ == "__main__":
    main()
