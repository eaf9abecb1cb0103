#!/usr/bin/env python3
"""Time K2 (the joint ladder) and K1 (the Montgomery product) of two or more
checkouts of the port side by side on one CUDA card.

A variant is `LABEL=TREE`, the root of a checkout. Each tree's kernel
library builds from its own sources into its own
bulletproofsplus_tpu_torch/build/, all trees at once. Then each tree runs
in a process of its own that imports that tree's package, in turns forward
and backward (for two trees: first, second, second, first), on the same
seeded inputs, through the wrappers a user calls:

- K2 (`joint_ladder_msm_grouped`) at chip_smoke.k2_shapes of each curve's
  cell (n and m of its fixture, K = 256): the verify MSM (J = 8) and the
  prover's round 0 (J = 2 and J = 4). Points are drawn at random from
  4,096 distinct curve points (chip_smoke.random_points), scalars are
  chip_smoke.random_scalars. Mean of `--reps` launches after a warm-up.
- K1 (`mont_mul`) at chip_smoke.py's shape: 262,144 elements at both of the
  curve's moduli, operands from chip_smoke.field_operands (carry runs
  included). Mean of 20 launches after a warm-up, through the wrapper
  (ms) and replayed from a CUDA graph of 20 wrapper calls (graph_ms: the
  device's time without the host's).

Every run's output must equal the first's word for word (the trees compute
the same operations in the same order); a difference fails the run. Prints
the card (nvidia-smi name and power limit), then one JSON line a kernel and
shape: each label's ms (one a turn) and their mean, registers and spill
bytes (ptxas -v, from the tree's build/build.log), and the shape's bound
(bulletproofsplus_tpu_torch/roofline.py). To time the parent commit beside
the working tree, unpack it into the git-ignored checkout_copy/ first:

    mkdir -p checkout_copy/parent && git archive HEAD | tar -x -C checkout_copy/parent
    python3 scripts/bench_torch_k2.py parent=checkout_copy/parent new=.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import random
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DISTINCT_POINTS = 4096
K1_REPS = 20


def chip_smoke():
    """This checkout's chip_smoke.py, whatever tree's package is imported."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def worker(tree: str, curves: list, reps: int, device: str = "cuda:0") -> None:
    """Run K2 and K1 of `tree`'s package at every shape; one JSON line each,
    with the registers() key of the kernel instance it ran."""
    sys.path.insert(0, tree)
    from bulletproofsplus_tpu_torch import roofline, serialize
    from bulletproofsplus_tpu_torch.curves import cuda_curve as cc
    from bulletproofsplus_tpu_torch.curves import curve_ops
    from bulletproofsplus_tpu_torch.fields.mont_mul import mont_mul

    cs = chip_smoke()
    dev = torch.device(device)

    def timed(key, instance, call, nreps, graph=False):
        with roofline.recorded_launches() as calls:
            out = call()
        ms = cs.cuda_ms(call, nreps)
        g_ms = cs.graph_ms(call, nreps) if graph else None
        print(json.dumps({"key": key, "instance": instance, "ms": ms, "graph_ms": g_ms,
                          "digest": digest(out), "bound": roofline.bound(calls)}), flush=True)

    for name in curves:
        curve = curve_ops(name)
        with open(cs.FIXTURES[name], "rb") as f:
            _, n, m, _ = serialize.read_fixture(f.read())
        base = cs.random_points(curve, DISTINCT_POINTS, 7, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        for J, G in cs.k2_shapes(n, m):
            pick = torch.randint(0, DISTINCT_POINTS, (G * J,), generator=gen, device=dev)
            pts, scal = base[pick], cs.random_scalars(G * J, gen, dev)
            timed(["K2", name, f"J={J}, {G} groups"], ["K2", curve.FAMILY, J],
                  lambda: cc.joint_ladder_msm_grouped(curve, scal, pts, curve.fn.order_bits, J),
                  reps)
            del pick, pts, scal
        rnd = random.Random(1)
        for f in (curve.fp, curve.fn):
            a = cs.field_operands(f, cs.K1_ELEMENTS, rnd, dev)
            b = cs.field_operands(f, cs.K1_ELEMENTS, rnd, dev)
            timed(["K1", name, f"{cs.K1_ELEMENTS} elements mod {f.spec.name}"], ["K1", f.L],
                  lambda: mont_mul(a, b, f.spec), K1_REPS, graph=True)


def build(tree: str) -> None:
    sys.path.insert(0, tree)
    from bulletproofsplus_tpu_torch import kernels

    kernels.build()


def registers(tree: str) -> dict:
    """{("K2", point family, J) or ("K1", words): (registers, spill store
    bytes, spill load bytes)} from the tree's build.log (ptxas -v)."""
    with open(os.path.join(tree, "bulletproofsplus_tpu_torch", "build", "build.log")) as f:
        lines = f.read().splitlines()
    fams = {"3Pt4E": "edwards", "3Pt3ILi8EEE": "weierstrass", "3Pt3ILi12EEE": "weierstrass12"}
    out = {}
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\S*)'", line)
        if not m:
            continue
        fn = m.group(1)
        if "joint_ladder_kernel" in fn:
            fam = next(f for key, f in fams.items() if key in fn)
            key = ("K2", fam, int(re.search(r"Li(\d+)EEEv", fn).group(1)))
        elif "mont_mul_kernel" in fn or "elementwise_kernelILi" in fn and "ELi0E" in fn:
            key = ("K1", int(re.search(r"ILi(\d+)E", fn).group(1)))
        else:
            continue
        block = "\n".join(lines[i:i + 5])
        regs = int(re.search(r"Used (\d+) registers", block).group(1))
        st, ld = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block).groups()
        out[key] = (regs, int(st), int(ld))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", help="LABEL=TREE")
    ap.add_argument("--reps", type=int, default=2, help="K2 launches timed a turn")
    ap.add_argument("--curves", default="edwards25519,secp256k1,bls12_381")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--build", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.build:
        build(args.build)
        return 0
    if args.worker:
        worker(args.worker, args.curves.split(","), args.reps)
        return 0
    if not torch.cuda.is_available():
        print("bench_torch_k2: no CUDA device", file=sys.stderr)
        return 2
    variants = [(label, os.path.abspath(tree))
                for label, tree in (v.split("=", 1) for v in args.variants)]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    me = os.path.abspath(__file__)
    with ThreadPoolExecutor(len(variants)) as pool:
        list(pool.map(lambda v: subprocess.run([sys.executable, me, "--build", v[1]],
                                               check=True), variants))
    regs = {label: registers(tree) for label, tree in variants}
    runs = {label: [] for label, _ in variants}
    for label, tree in variants + variants[::-1]:
        res = subprocess.run([sys.executable, me, "--worker", tree, "--reps", str(args.reps),
                              "--curves", args.curves],
                             capture_output=True, text=True)
        sys.stderr.write(res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"{label}'s run failed (exit {res.returncode})")
        runs[label].append([json.loads(line) for line in res.stdout.splitlines()])
    first = variants[0][0]
    ok = True
    for i, line0 in enumerate(runs[first][0]):
        key = line0["key"]
        line = {"kernel": key[0], "curve": key[1], "shape": key[2],
                "bound_ms": line0["bound"][0], "bound_by": line0["bound"][1], "variants": {}}
        for label, _ in variants:
            got = [run[i] for run in runs[label]]
            if any(g["key"] != key or g["digest"] != line0["digest"] for g in got):
                ok = False
                print(f"bench_torch_k2: {label} differs from {first} at {key}", file=sys.stderr)
            ms = [g["ms"] for g in got]
            line["variants"][label] = {"ms": ms, "mean_ms": sum(ms) / len(ms),
                                       "graph_ms": [g["graph_ms"] for g in got],
                                       "registers_spill": regs[label].get(tuple(line0["instance"]))}
        print(json.dumps(line), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
