#!/usr/bin/env python3
"""Time the fs256 chain kernel (csrc/fs256_chain.cu) at the cells' K = 256
schedules, beside the SHA-256 kernel's statement absorb, from CUDA graphs
on one card.

For each curve (edwards25519 at m = 16, secp256k1 at m = 64, bls12-381 at
m = 256; n = 64), on seeded random coordinate words, states and counters:
the verifier's replay schedule, the prover's statement step, a round step
and the final step, each timed twice as a CUDA graph of `--reps` launches
and held against the plain version on the round step. Each line gives ms,
µs per compression on a transcript's dependent path, the floor of
roofline.fs256_chain_ms and the ratio; then the SHA-256 kernel (one thread
a message) on the statement absorb's message, µs a block. Last, the card's
name and power limit (nvidia-smi).

Usage: python3 scripts/bench_torch_fs256_chain.py [--reps R]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CELLS = (("edwards25519", 16), ("secp256k1", 64), ("bls12_381", 256))
N, K = 64, 256


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import graph_ms

    from bulletproofsplus_tpu_torch import hashers_device as hd
    from bulletproofsplus_tpu_torch import kernels, roofline
    from bulletproofsplus_tpu_torch.curves import curve_ops
    from bulletproofsplus_tpu_torch.protocol import fs256

    dev = torch.device("cuda:0")
    kernels.library()
    log = kernels.BUILD_LOG.splitlines()
    for i, line in enumerate(log):        # ptxas's lines for each chain kernel
        if "chain_kernel" in line and "Compiling" in line:
            print("\n".join(x.strip() for x in log[i:i + 4]), file=sys.stderr)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    ok = True
    for name, m in CELLS:
        curve = curve_ops(name)
        fn, W = curve.fn, 2 * curve.fp.L
        logn = (N * m).bit_length() - 1
        rows = m + 3 + 2 * logn

        def words(*shape):
            return torch.randint(-2**31, 2**31, shape, dtype=torch.int32, generator=gen,
                                 device=dev)

        cw, state = words(K, rows, W), words(K, 8)
        base = torch.randint(0, 1 << 20, (K,), dtype=torch.int32, generator=gen, device=dev)
        cases = {"replay": (None, fs256.replay_schedule(m, logn), cw),
                 "statement": (base, (fs256.statement_step(m),), cw[:, :m + 1].contiguous()),
                 "round": (base, (fs256.round_step(logn - 1),), cw[:, :2].contiguous()),
                 "final": (base, (fs256.final_step(logn),), cw[:, :2].contiguous())}
        for what, (b, sched, x) in cases.items():
            steps = roofline.chain_steps(hd.schedule_words(sched), len(sched))
            path, total = roofline.chain_compressions(steps, W)
            floor = roofline.fs256_chain_ms(steps, K, x.shape[1], W)[1]
            if what == "round":
                out = hd.fs256_chain(fn, state, b, x, sched)
                ref = hd.fs256_chain_plain(fn, state, b, x, sched)
                if not all(torch.equal(p, q) for p, q in zip(out, ref)):
                    print(f"{name} {what}: the kernel differs from its plain version",
                          file=sys.stderr)
                    ok = False
            ms = [graph_ms(lambda: hd.fs256_chain(fn, state, b, x, sched), args.reps)
                  for _ in range(2)]
            print(json.dumps({"curve": name, "m": m, "K": K, "schedule": what,
                              "path_compressions": path, "compressions": total,
                              "challenges": sum(c for _, _, c in steps), "floor_ms": floor,
                              "graph_ms": ms, "us_per_path_block": min(ms) * 1e3 / path,
                              "x_floor": min(ms) / floor}), flush=True)
        # the SHA-256 kernel (one thread a message) on the statement absorb's message
        nw = 9 + (m + 1) * W
        msgs = words(K, nw)
        sha = graph_ms(lambda: hd.sha256_words(msgs, 4 * nw), args.reps)
        blocks = roofline.sha256_blocks(4 * nw)
        print(json.dumps({"curve": name, "sha256_words_statement": {
            "blocks": blocks, "graph_ms": sha, "us_per_block": sha * 1e3 / blocks}}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
