#!/usr/bin/env python3
"""Profile the PyTorch port's batch verify or batch prove (K = 256) on a card,
on edwards25519 (n = 64, m = 16), secp256k1 (n = 64, m = 64) or bls12-381
(n = 64, m = 256).

n and m are those of the curve's committed fixture. Verify (the default) runs
the fixture batch (as chip_smoke.py does); --prove batch-proves bench.py's K
statements (v = (7k + 3i + 2) mod 2^n, γ = 2i + k + 3, committed by
chip_smoke.py's host running sums) in the deterministic mode. --fs256 takes
the fs256 transcript instead (the entry points' default): prove draws its
challenges on the card, and verify runs on bench.py's statements
batch-proven with it first and replays them on the card (stages
bpp::fs256_statement, bpp::fs256_challenge, bpp::fs256_replay). Either runs
3 times warm, then once under torch.profiler, and prints,
per stage range (protocol/batch.py: bpp::exponents, bpp::rlc_merge,
bpp::variable_msm, bpp::fixed_msm, bpp::msm_sum, bpp::identity_check;
protocol/batchprove.py
and wip.py: bpp::bit_commitment, bpp::prove_setup, bpp::fold_round summed over
the rounds, bpp::final_ab), its host wall time and the device time of the
kernels it launched; the device busy share of the whole run; the top kernels
by device time; launch counts; the least time
(bulletproofsplus_tpu_torch/roofline.py) of every hand-written kernel's
launches in the profiled run, from the sizes each launch was given; and the
wall times of the 3 unprofiled warm runs (the first includes first-use
set-up). Writes the Chrome trace to --trace, by default
bulletproofsplus_tpu_torch/build/profile_trace.json (git-ignored) in the
checkout.

Usage: python3 scripts/profile_torch_batch_verify.py [K] [--prove] [--fs256]
       [--curve edwards25519|secp256k1|bls12_381] [--trace PATH]
"""
from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FIXTURES = {"edwards25519": "ed25519_n64_m16_det.bin",
            "secp256k1": "secp256k1_n64_m64_det.bin",
            "bls12_381": "bls12_381_n64_m256_det.bin"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("K", type=int, nargs="?", default=256)
    ap.add_argument("--prove", action="store_true",
                    help="profile batch_prove instead of batch_verify")
    ap.add_argument("--fs256", action="store_true",
                    help="the fs256 transcript instead of the deterministic mode")
    ap.add_argument("--curve", choices=sorted(FIXTURES), default="edwards25519")
    ap.add_argument("--trace", default=os.path.join(ROOT, "bulletproofsplus_tpu_torch",
                                                    "build", "profile_trace.json"),
                    help="where to write the Chrome trace (default: the "
                         "git-ignored build directory of the checkout)")
    args = ap.parse_args()
    K = args.K
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import (
        FS256_PROVE_STAGES,
        FS256_VERIFY_STAGES,
        PROVE_STAGES,
        VERIFY_STAGES,
        bench_commitments,
        stage_profile,
    )

    from bulletproofsplus_tpu_torch import roofline
    from bulletproofsplus_tpu_torch import (
        DeterministicRng,
        DeterministicTranscript,
        Fs256Transcript,
        ProofBatch,
        PublicKey,
        RangeProver,
        batch_prove,
        batch_verify,
        curve_ops,
        serialize,
    )

    dev = torch.device("cuda:0")
    curve = curve_ops(args.curve)
    with open(os.path.join(ROOT, "bulletproofsplus_tpu_torch", "data",
                           FIXTURES[args.curve]), "rb") as f:
        _, n, m, rows = serialize.read_fixture(f.read())
    pk = PublicKey.new(curve, n * m, dev)

    def transcripts():
        if args.fs256:
            return [Fs256Transcript(m) for _ in range(K)]
        return [DeterministicTranscript(m)] * K

    if args.prove or args.fs256:
        V = bench_commitments(curve, pk, n, m, K)
        provers = [RangeProver(v_vec=[7 * k + 3 * i + 2 for i in range(m)],
                               gamma_vec=[2 * i + k + 3 for i in range(m)],
                               commitment_vec=list(V[k].unbind(0))) for k in range(K)]

        def prove_all():
            return batch_prove(curve, pk, n, provers, transcripts(), [DeterministicRng(m)] * K)
    if args.prove:
        stages = FS256_PROVE_STAGES if args.fs256 else PROVE_STAGES
        run = prove_all
    elif args.fs256:
        stages = FS256_VERIFY_STAGES
        pk.fixed_tables(n * m)
        batch = prove_all()
        rnd = random.Random(0)

        def run():
            batch_verify(curve, pk, n, batch, V, transcripts(),
                         rng=lambda: rnd.getrandbits(128))
    else:
        stages = VERIFY_STAGES
        pk.fixed_tables(n * m)
        decoded = [serialize.proof_from_bytes(curve, w, dev) for _, w in rows]
        comms = torch.stack([curve.encode_points(serialize.points_from_bytes(curve, c), dev)
                             for c, _ in rows])
        idx = torch.arange(K, device=dev) % len(rows)
        batch = ProofBatch.from_proofs(decoded).take(idx)
        V = comms[idx]
        rnd = random.Random(0)

        def run():
            batch_verify(curve, pk, n, batch, V, [DeterministicTranscript(m)] * K,
                         rng=lambda: rnd.getrandbits(128))

    warm_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        warm_ms.append((time.perf_counter() - t0) * 1e3)
    with roofline.recorded_launches() as calls:
        per_stage, whole, prof, kernels = stage_profile(run, stages, args.trace)
    bounds = {}
    for name in sorted({name for name, _ in calls}):
        mine = [c for c in calls if c[0] == name]
        bounds[name] = {"launches": len(mine), "bound_ms": roofline.bound(mine)[0]}
    by_name = {}
    for e in kernels:
        d = by_name.setdefault(e["name"][:80], [0, 0.0])
        d[0] += 1
        d[1] += e["dur"] / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25),
          file=sys.stderr)
    print(json.dumps({
        "card": card, "curve": args.curve, "n": n, "m": m,
        "mode": "prove" if args.prove else "verify", "K": K,
        "transcript": "fs256" if args.fs256 else "deterministic",
        "warm_ms_unprofiled": warm_ms, **whole,
        "device_busy_share": whole["device_busy_ms"] / whole["wall_ms"],
        "stages": per_stage,
        "kernel_bounds": bounds,
        "top_kernels": [{"name": k, "count": c, "ms": t} for k, (c, t) in top],
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
