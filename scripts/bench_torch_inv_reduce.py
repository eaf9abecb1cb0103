#!/usr/bin/env python3
"""Time the field inversion and the bucket reduce of one or more checkouts of
the port side by side on one CUDA card.

A variant is `LABEL=TREE`, the root of a checkout. Each tree's kernel
library builds from its own sources into its own
bulletproofsplus_tpu_torch/build/, all trees at once; then each tree runs in
a process of its own that imports that tree's package, in turns forward and
backward (for two trees: first, second, second, first), on the same seeded
inputs, through the calls a user makes:

- `FieldOps.inv` on K = 256 values of each of the six fields (seeded, one
  of them 0): a Fermat chain (`fe_pow` by p − 2) before the divstep kernel,
  `fe_inv` since; and `fe_pow(a, p − 2)` itself in every tree. Both give
  a⁻¹·R word for word, so every run's output must equal the first's.
- `cuda_curve.bucket_reduce` at the wrapper's own segment count, on merged
  buckets that the tree's `bucket_accumulate` (one slice) makes from the
  coefficient prover's L/R rows of edwards25519's headline cell (n·m =
  1,024: 20 rows of 1,026 pairs on a key's generators, chip_smoke.py's
  `coeff_rows`), at K = 1 (20 rows) and K = 256 (5,120 rows, seeded
  random scalars below 2^252 on the same points), on every curve. The
  trees may add in other orders, so outputs must equal the first run's as
  affine points. `--segments 0,1,2` also times each named segment count
  (0: a thread a window) at each K, keyed `...|seg=S`; each must give the
  wrapper's own count's points.

Each is the mean of `--reps` calls after a warm-up, through the wrapper
(ms) and replayed from a CUDA graph of as many calls (graph_ms: the
device's time without the host's), with chip_smoke.py's `cuda_ms` and
`graph_ms`. Prints the card (nvidia-smi name and power limit), each
tree's SASS sizes of the inversion and reduce kernels (cuobjdump: each
function's instructions, its largest loop's and that loop's IMAD.WIDE
count; a warp issues at most one instruction a cycle, so a loop's size
is a floor on its cycles), then one JSON line a call and shape: each
label's ms and graph_ms (one a turn), and the bounds of this checkout's
roofline.py (the divstep chain and the
Fermat chain for an inversion; the reduce's rate bound or row chain). To
time the parent commit beside the working tree:

    mkdir -p checkout_copy/parent && git archive HEAD | tar -x -C checkout_copy/parent
    python3 scripts/bench_torch_inv_reduce.py parent=checkout_copy/parent new=.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import random
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K_VALUES = 256
ROWS_N = 1024           # the headline's n·m: 20 L/R rows of 1,026 pairs a proof
WINDOW = 6


def load_chip_smoke(tree: str):
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(tree, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(tree: str, reps: int, segments: list) -> None:
    """One tree's runs: one JSON line, {key: [ms, graph_ms, digest]}."""
    sys.path.insert(0, tree)
    import torch

    import bulletproofsplus_tpu_torch as bt
    from bulletproofsplus_tpu_torch.curves import cuda_curve as cc
    from bulletproofsplus_tpu_torch.fields import field_kernels as fk

    cs = load_chip_smoke(tree)
    dev = torch.device("cuda:0")
    out = {}

    def timed(key, call, digest_of):
        res = call()
        torch.cuda.synchronize()
        out[key] = [cs.cuda_ms(call, reps), cs.graph_ms(call, reps), digest_of(res)]

    def words(t):
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]

    for name in bt.CURVE_NAMES:
        curve = bt.curve_ops(name)
        rnd = random.Random(16)
        for f in (curve.fp, curve.fn):
            vals = f.encode([0] + [rnd.randrange(1, f.p) for _ in range(K_VALUES - 1)], dev)
            timed(f"inv|{f.spec.name}", lambda: f.inv(vals), words)
            timed(f"pow|{f.spec.name}", lambda: fk.fe_pow(vals, f.p - 2, f.spec), words)

        def affine(t, curve=curve):
            return hashlib.sha256(repr(curve.decode_points(t)).encode()).hexdigest()[:16]

        pk = bt.PublicKey.new(curve, ROWS_N, dev)
        S, P = cs.coeff_rows(curve, pk, ROWS_N, rnd)
        nwin = -(-curve.fn.order_bits // WINDOW)
        gen = torch.Generator(device=dev)
        gen.manual_seed(16)
        for K in (1, 256):
            SK = S if K == 1 else cs.random_scalars(K * S.shape[0] * S.shape[1], gen, dev).reshape(
                K * S.shape[0], S.shape[1], -1)
            merged = cc.bucket_accumulate(curve, SK, P, nwin, WINDOW, 1)[:, 0]
            key = f"reduce|{name}|{SK.shape[0]}"
            timed(key, lambda: cc.bucket_reduce(curve, merged, WINDOW), affine)
            for seg in segments:
                timed(f"{key}|seg={seg}", lambda: cc.bucket_reduce(curve, merged, WINDOW, seg),
                      affine)
                if out[f"{key}|seg={seg}"][2] != out[key][2]:
                    raise SystemExit(f"{key}: {seg} segments give other points")
            del merged
        torch.cuda.empty_cache()
    print(json.dumps(out))


SASS_KERNELS = ("inv_kernel", "pow_kernel", "bucket_reduce_windows_kernel",
                "bucket_reduce_windows_lane_kernel",
                "bucket_reduce_horner_kernel", "bucket_reduce_kernel")


def sass(tree: str) -> dict:
    """{kernel: {instructions, the largest loop's instructions (a backward
    branch to a label), its IMAD.WIDE count}} of each SASS_KERNELS function
    in the tree's library (cuobjdump -sass), by demangled-name substring."""
    import glob
    import re

    libs = sorted(glob.glob(os.path.join(tree, "bulletproofsplus_tpu_torch", "build",
                                         "libbpp_kernels_*.so")), key=os.path.getmtime)
    if not libs:
        return {}
    cuobjdump = os.path.join(os.path.dirname(shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"),
                             "cuobjdump")
    res = subprocess.run([cuobjdump, "-sass", libs[-1]], capture_output=True, text=True)
    out, fn, lines = {}, None, []

    def close():
        if fn is None:
            return
        name = subprocess.run(["c++filt", fn], capture_output=True, text=True).stdout.strip()
        kernel = next((k for k in SASS_KERNELS if f"::{k}<" in name or f" {k}<" in name), None)
        if kernel is None:
            return
        labels, addrs, insns, loop = {}, {}, [], []
        for line in lines:
            lab = re.match(r"\s*(\.L_x_\d+):", line)
            if lab:
                labels[lab.group(1)] = len(insns)
                continue
            at = re.match(r"\s*/\*([0-9a-f]{4,})\*/", line)
            if at:
                addrs[int(at.group(1), 16)] = len(insns)
                insns.append(line)
                # a backward branch, to a label or to an address
                br = re.search(r"BRA\s+(?:`?\(?(\.L_x_\d+)|0x([0-9a-f]+))", line)
                start = None if br is None else (
                    labels.get(br.group(1)) if br.group(1) else addrs.get(int(br.group(2), 16)))
                if start is not None and len(insns) - start > len(loop):
                    loop = insns[start:]
        key = f"{kernel}<{re.search(r'<(.*?)>', name[name.index(kernel):]).group(1)}>"
        out[key] = {"instructions": len(insns), "loop_instructions": len(loop),
                    "loop_imad_wide": sum("IMAD.WIDE" in x for x in loop)}

    for line in res.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            close()
            fn, lines = m.group(1), []
        elif fn is not None:
            lines.append(line)
    close()
    return out


def build(tree: str) -> None:
    sys.path.insert(0, tree)
    from bulletproofsplus_tpu_torch import kernels

    kernels.library()


def bounds(segments: list) -> dict:
    """This checkout's roofline bounds of each key."""
    sys.path.insert(0, ROOT)
    from bulletproofsplus_tpu_torch import roofline
    from bulletproofsplus_tpu_torch.curves import CURVE_NAMES, curve_ops
    from bulletproofsplus_tpu_torch.fields.field_kernels import _exponent

    out = {}
    for name in CURVE_NAMES:
        curve = curve_ops(name)
        for f in (curve.fp, curve.fn):
            inv = roofline.fe_inv_ms(K_VALUES, f.L, f.spec.inv_consts)
            pw = roofline.fe_pow_ms(K_VALUES, f.L, *_exponent(f.p - 2))
            out[f"inv|{f.spec.name}"] = {"divstep_bound_ms": max(inv), "fermat_bound_ms": max(pw)}
            out[f"pow|{f.spec.name}"] = {"fermat_bound_ms": max(pw)}
        nwin = -(-curve.fn.order_bits // WINDOW)
        for R in (20, 20 * 256):
            tb, to = roofline.reduce_ms(curve.FAMILY, R, nwin, WINDOW)
            chain = roofline.dep_ms(roofline.reduce_chain_ops(curve.FAMILY, nwin, WINDOW))
            out[f"reduce|{name}|{R}"] = {"bound_ms": max(tb, to), "chain_ms": chain,
                                         "bound_by": "bytes" if tb >= to else "operations"}
            for seg in segments:
                out[f"reduce|{name}|{R}|seg={seg}"] = out[f"reduce|{name}|{R}"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", help="LABEL=TREE")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--segments", default="",
                    help="comma-separated reduce segment counts to time besides the wrapper's")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--build", help=argparse.SUPPRESS)
    args = ap.parse_args()
    segments = [int(x) for x in args.segments.split(",") if x]
    if args.worker:
        worker(args.worker, args.reps, segments)
        return 0
    if args.build:
        build(args.build)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("bench_torch_inv_reduce: no CUDA device", file=sys.stderr)
        return 2
    variants = [(label, os.path.abspath(tree))
                for label, tree in (v.split("=", 1) for v in args.variants or ["new=."])]
    me = os.path.abspath(__file__)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    with ThreadPoolExecutor(len(variants)) as pool:
        list(pool.map(lambda v: subprocess.run([sys.executable, me, "--build", v[1]],
                                               check=True), variants))
    print(json.dumps({"sass": {label: sass(tree) for label, tree in variants}}), flush=True)
    runs = {label: [] for label, _ in variants}
    for label, tree in variants + variants[::-1]:
        res = subprocess.run([sys.executable, me, "--worker", tree, "--reps", str(args.reps),
                              "--segments", args.segments],
                             capture_output=True, text=True, cwd=tree)
        if res.returncode:
            print(res.stderr, file=sys.stderr)
            return 1
        runs[label].append(json.loads(res.stdout.strip().splitlines()[-1]))
    first = runs[variants[0][0]][0]
    bad = 0
    for key, info in bounds(segments).items():
        line = {"key": key, **info, "variants": {}}
        for label, turns in runs.items():
            if any(t[key][2] != first[key][2] for t in turns):
                line["differs"] = label
                bad += 1
            line["variants"][label] = {"ms": [t[key][0] for t in turns],
                                       "graph_ms": [t[key][1] for t in turns]}
        print(json.dumps(line), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
