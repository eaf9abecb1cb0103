#!/usr/bin/env python3
"""Profile the PyTorch port's batch verify (K = 256, n = 64, m = 16) on a card.

Runs the committed fixture batch (as chip_smoke.py does) warm, then one run
under torch.profiler. Prints, per stage range of protocol/batch.py
(bpp::exponents, bpp::rlc_merge, bpp::variable_msm, bpp::fixed_msm,
bpp::identity_check), its host wall time and the device time of the kernels
it launched; the device busy share of the whole run; the top kernels by
device time; and launch counts. Writes the Chrome trace to --trace.

Usage: python3 scripts/profile_torch_batch_verify.py [K] [--trace PATH]
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
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STAGES = ("bpp::exponents", "bpp::rlc_merge", "bpp::variable_msm",
          "bpp::fixed_msm", "bpp::identity_check")


def union_us(intervals):
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("K", type=int, nargs="?", default=256)
    ap.add_argument("--trace", default="profile_batch_verify.json",
                    help="where to write the Chrome trace")
    args = ap.parse_args()
    K = args.K
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from bulletproofsplus_tpu_torch import (
        DeterministicTranscript,
        ProofBatch,
        PublicKey,
        batch_verify,
        curve_ops,
        serialize,
    )

    dev = torch.device("cuda:0")
    curve = curve_ops()
    with open(os.path.join(ROOT, "bulletproofsplus_tpu_torch", "data",
                           "ed25519_n64_m16_det.bin"), "rb") as f:
        n, m, rows = serialize.read_fixture(f.read())
    pk = PublicKey.new(curve, n * m, dev)
    pk.fixed_tables(n * m)
    decoded = [serialize.proof_from_bytes(curve, w, dev) for _, w in rows]
    comms = torch.stack([curve.encode_points(serialize.points_from_bytes(c), dev)
                         for c, _ in rows])
    idx = torch.arange(K, device=dev) % len(rows)
    batch = ProofBatch.from_proofs(decoded).take(idx)
    V = comms[idx]
    rnd = random.Random(0)

    def run():
        batch_verify(curve, pk, n, batch, V, [DeterministicTranscript(m)] * K,
                     rng=lambda: rnd.getrandbits(128))

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
    prof.export_chrome_trace(args.trace)
    with open(args.trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    busy_us = union_us([(e["ts"], e["ts"] + e["dur"]) for e in kernels])
    stages = {}
    for name in STAGES:
        host = [e for e in events if e.get("name") == name
                and e.get("cat") == "user_annotation"]
        gpu = [e for e in events if e.get("name") == name
               and e.get("cat") == "gpu_user_annotation"]
        spans = [(g["ts"], g["ts"] + g["dur"]) for g in gpu]
        mine = [e for e in kernels if any(lo <= e["ts"] <= hi for lo, hi in spans)]
        stages[name] = {
            "host_ms": sum(e["dur"] for e in host) / 1e3,
            "device_span_ms": sum(e["dur"] for e in gpu) / 1e3,
            "device_busy_ms": union_us([(e["ts"], e["ts"] + e["dur"])
                                        for e in mine]) / 1e3,
            "launches": len(mine),
        }
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
        "card": card, "K": K, "wall_ms": wall_ms,
        "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / 1e3 / wall_ms,
        "kernel_launches": len(kernels),
        "stages": stages,
        "top_kernels": [{"name": k, "count": c, "ms": t} for k, (c, t) in top],
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
