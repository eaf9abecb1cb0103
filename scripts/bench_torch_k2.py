#!/usr/bin/env python3
"""Time K1-K5 (the Montgomery product, the joint ladder, the grouped point
sum, the fixed-base lookup and the per-lane ladder) of two or more checkouts
of the port side by side on one CUDA card.

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
- K3 (`sum_points_grouped`) at every shape of the cell's verify and prove:
  the verify MSM's one group of K2 outputs (1 × G), the parent design's
  second launch over 1,024-lane K4 partials (1 × ⌈lanes / 1,024⌉), the
  one tail group of the K2 outputs and this tree's K4 partials (1 × (G +
  P)); round r's L and R sums (2K × (2·mn/2^(r+1) + 2)/J, as
  protocol/wip.py::joint_rows_msm pads them), A and B (2K × 1) and the bit
  commitments (K × (mn + 1)). Mean of 20 launches after a warm-up, through
  the wrapper (ms) and from a CUDA graph (graph_ms).
- K4 (`fixed_lookup_partials`) at the verify's generator lanes (2mn × the
  windows of an unsigned table, random digits, table entries drawn from the
  same points), and K4 then K3 over its partials (`fixed_msm`'s kernels).
- K5 (`ladder_scalar_mul`) at the prover's K = 256 lanes and at one lane
  (a single prove), points drawn as for K2, scalars chip_smoke.random_scalars
  at the group order's width. Mean of 20 launches after a warm-up, through
  the wrapper (ms) and from a CUDA graph (graph_ms).

K1, K2 and K5 outputs must equal the first run's word for word (the trees
compute the same operations in the same order). K3 and K4 may add in
another order, so their outputs (K4's partials summed by the plain K3)
must equal the first run's as affine points. A difference fails the run.
Prints the card (nvidia-smi name and power limit), the latency of one
dependent point operation a family and kind (pt_add, pt_dbl, pt_add_quad,
pt_dbl_quad; scripts/bench_torch_pt_add.cu built from this checkout's
csrc/: one warp, each quad one chain of `--add-reps` operations, checked
against the host curve, and each quad kind's output against its single
kind's word for word), then one JSON line a kernel and shape: each label's
ms (one a turn) and their mean, registers and spill bytes (ptxas -v, from
the tree's build/build.log), the shape's bound
(bulletproofsplus_tpu_torch/roofline.py), for a one-group K3 its latency
floor, ⌈log2 W⌉ dependent adds, and for K5 its latency floor,
nwin·(4·t_dbl_quad + t_add_quad) + 14·t_add_quad (one lane's chain of
quad operations). To time the parent commit beside the working tree,
unpack it into the git-ignored checkout_copy/ first:

    mkdir -p checkout_copy/parent && git archive HEAD | tar -x -C checkout_copy/parent
    python3 scripts/bench_torch_k2.py parent=checkout_copy/parent new=. [--kernels K3,K4,K5]
"""
from __future__ import annotations

import argparse
import ctypes
import functools
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
SUM_REPS = 20       # K3, K4 and K5 launches timed a turn
ADD_SOURCE = os.path.join(ROOT, "scripts", "bench_torch_pt_add.cu")
ADD_THREADS = 32
OP_KINDS = ("pt_add", "pt_dbl", "pt_add_quad", "pt_dbl_quad")   # bench_torch_pt_add.cu's kinds
K5_LANES = (256, 1)


def chip_smoke():
    """This checkout's chip_smoke.py, whatever tree's package is imported."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def affine_digest(curve, t: torch.Tensor) -> str:
    """Digest of a point tensor as affine points (canonical integers)."""
    return hashlib.sha256(repr(curve.decode_points(t)).encode()).hexdigest()


def prove_sum_shapes(n: int, m: int) -> list:
    """(label, G, W) of the prover's K3 launches at K = K_BATCH: each fold
    round's L and R (protocol/wip.py::joint_rows_msm: 2K rows of W pairs,
    padded to a multiple of J, J = 4 if W % 4 == 0 or W ≥ 8 else 2), A and B
    (2K rows of 4 pairs), and the bit commitments (K × (mn + 1),
    protocol/range.py::bit_commitment_batched)."""
    K = chip_smoke().K_BATCH
    mn = n * m
    out = []
    for r in range(mn.bit_length() - 1):
        W = 2 * (mn >> (r + 1)) + 2
        J = 4 if W % 4 == 0 or W >= 8 else 2
        out.append((f"round {r} L/R", 2 * K, -(-W // J)))
    out.append(("A/B", 2 * K, 1))
    out.append(("bit commitments", K, mn + 1))
    return out


def worker(tree: str, curves: list, reps: int, kinds: list, device: str = "cuda:0") -> None:
    """Run the kernels `kinds` of `tree`'s package at every shape; one JSON
    line each, with the registers() key of the kernel instance it ran."""
    sys.path.insert(0, tree)
    from bulletproofsplus_tpu_torch import roofline, serialize
    from bulletproofsplus_tpu_torch.curves import cuda_curve as cc
    from bulletproofsplus_tpu_torch.curves import curve_ops
    from bulletproofsplus_tpu_torch.fields.mont_mul import mont_mul

    cs = chip_smoke()
    dev = torch.device(device)

    def timed(key, instance, call, nreps, graph=False, digest_of=digest, **extra):
        with roofline.recorded_launches() as calls:
            out = call()
        ms = cs.cuda_ms(call, nreps)
        g_ms = cs.graph_ms(call, nreps) if graph else None
        print(json.dumps({"key": key, "instance": instance, "ms": ms, "graph_ms": g_ms,
                          "digest": digest_of(out), "bound": roofline.bound(calls), **extra}),
              flush=True)

    for name in curves:
        curve = curve_ops(name)
        C, L = curve.COORDS, curve.fp.L
        with open(cs.FIXTURES[name], "rb") as f:
            _, n, m, _ = serialize.read_fixture(f.read())
        base = cs.random_points(curve, DISTINCT_POINTS, 7, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)

        def draw(count):
            return base[torch.randint(0, DISTINCT_POINTS, (count,), generator=gen, device=dev)]

        shapes = cs.k2_shapes(n, m)
        if "K5" in kinds:
            nbits = curve.fn.order_bits
            for lanes in K5_LANES:
                pts, scal = draw(lanes), cs.random_scalars(lanes, gen, dev)
                timed(["K5", name, f"{lanes} lanes, {nbits} bits"], ["K5", curve.FAMILY],
                      lambda: cc.ladder_scalar_mul(curve, scal, pts, nbits), SUM_REPS,
                      graph=True, nwin=-(-nbits // cc.WINDOW))
                del pts, scal
        if "K2" in kinds:
            for J, G in shapes:
                pts, scal = draw(G * J), cs.random_scalars(G * J, gen, dev)
                timed(["K2", name, f"J={J}, {G} groups"], ["K2", curve.FAMILY, J],
                      lambda: cc.joint_ladder_msm_grouped(curve, scal, pts,
                                                          curve.fn.order_bits, J), reps)
                del pts, scal
        if "K1" in kinds:
            rnd = random.Random(1)
            for f in (curve.fp, curve.fn):
                a = cs.field_operands(f, cs.K1_ELEMENTS, rnd, dev)
                b = cs.field_operands(f, cs.K1_ELEMENTS, rnd, dev)
                timed(["K1", name, f"{cs.K1_ELEMENTS} elements mod {f.spec.name}"],
                      ["K1", f.L], lambda: mont_mul(a, b, f.spec), K1_REPS, graph=True)
                del a, b
        if "K3" not in kinds and "K4" not in kinds:
            continue
        affine = functools.partial(affine_digest, curve)
        G = shapes[0][1]
        outs = draw(G)                              # stand-ins for the verify's K2 outputs
        lanes = 2 * n * m * -(-curve.fn.order_bits // cc.WINDOW)
        table = draw(16 * lanes).reshape(16, lanes, C, L)
        dig = torch.randint(0, 16, (lanes,), generator=gen, device=dev, dtype=torch.int32)
        parts = cc.fixed_lookup_partials(curve, table, dig, False)
        if "K4" in kinds:
            timed(["K4", name, f"{lanes} lanes"], ["K4", curve.FAMILY],
                  lambda: cc.fixed_lookup_partials(curve, table, dig, False), SUM_REPS, graph=True,
                  digest_of=lambda p: affine(cc.sum_points_plain(curve, p[None])),
                  partials=parts.shape[0])
            timed(["K4+K3", name, f"{lanes} lanes"], ["K4", curve.FAMILY],
                  lambda: cc.sum_points_grouped(
                      curve, cc.fixed_lookup_partials(curve, table, dig, False)),
                  SUM_REPS, graph=True, digest_of=affine)
        del table
        if "K3" in kinds:
            parent_parts = max(1, min(1024, -(-lanes // 1024)))
            verify = [(f"verify MSM, 1 x {G}", outs[None]),
                      (f"parent's K4 partials, 1 x {parent_parts}", draw(parent_parts)[None]),
                      ("verify tail, 1 x (G + K4 partials)", torch.cat([outs, parts])[None])]
            for label, P in verify:
                timed(["K3", name, label], ["K3", curve.FAMILY],
                      lambda: cc.sum_points_grouped(curve, P), SUM_REPS, graph=True,
                      digest_of=affine, G=1, W=P.shape[1])
            del verify, P
            for label, Gs, W in prove_sum_shapes(n, m):
                P = draw(Gs * W).reshape(Gs, W, C, L)
                timed(["K3", name, f"{label}, {Gs} x {W}"], ["K3", curve.FAMILY],
                      lambda: cc.sum_points_grouped(curve, P), SUM_REPS, graph=True,
                      digest_of=affine, G=Gs, W=W)
                del P
        del outs, parts


def op_chains(curves: list, reps: int, device: str = "cuda:0") -> None:
    """The latency of one dependent point operation a family and kind, from
    this checkout's csrc/: one JSON line a curve and kind."""
    from bulletproofsplus_tpu_torch import kernels
    from bulletproofsplus_tpu_torch.curves import cuda_curve as cc
    from bulletproofsplus_tpu_torch.curves import curve_ops

    cs = chip_smoke()
    dev = torch.device(device)
    nvcc = kernels.nvcc_path()
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    fams = {curve_ops(name).FAMILY: name for name in curves}

    def build_one(fam):
        so = os.path.join(kernels.BUILD_DIR, f"libbpp_op_chain_{fam}.so")
        res = subprocess.run([nvcc, *kernels.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                              "-Xcompiler", "-fPIC", f"-DBPP_FAMILY={kernels.FAMILIES.index(fam)}",
                              "-I", kernels.SRC_DIR, ADD_SOURCE, "-o", so],
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc failed on {ADD_SOURCE} ({fam}):\n{res.stderr}")
        return fam, so

    with ThreadPoolExecutor(len(fams)) as pool:
        libs = dict(pool.map(build_one, fams))
    ok = True
    for fam, name in fams.items():
        curve = curve_ops(name)
        lib = ctypes.CDLL(libs[fam])
        fn = getattr(lib, f"bpp_op_chain_{fam}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.POINTER(ctypes.c_uint32), ctypes.c_void_p]
        pts = cs.random_points(curve, ADD_THREADS // 2, 5, dev)
        hc = curve.host
        A = [hc.lift(p) for p in curve.decode_points(pts)]
        quads = range(ADD_THREADS // 4)
        want = {"pt_add": hc.to_affine([hc.add(A[2 * q], hc.mul(A[2 * q + 1], reps))
                                        for q in quads]),
                "pt_dbl": hc.to_affine([hc.mul(A[2 * q], 1 << reps) for q in quads])}
        outs = {}
        for kind, op in enumerate(OP_KINDS):
            out = torch.empty((ADD_THREADS, curve.COORDS, curve.fp.L), dtype=torch.int32,
                              device=dev)

            def run(n):
                err = fn(pts.data_ptr(), out.data_ptr(), ADD_THREADS, n, kind,
                         cc._consts_words(curve), torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"bpp_op_chain_{fam} ({op}): CUDA error {err}")

            ms = {n: cs.cuda_ms(lambda: run(n), 5) for n in (0, reps)}
            run(reps)
            outs[op] = out.clone()
            single = op.removesuffix("_quad")
            check = curve.decode_points(out[::4]) == want[single]
            equal = bool(torch.equal(out, outs[single])) if op != single else None
            ok &= check and equal is not False
            print(json.dumps({"kernel": op, "curve": name, "family": fam,
                              "threads": ADD_THREADS, "reps": reps, "ms_at_0": ms[0],
                              "ms_at_reps": ms[reps],
                              "us_per_op": (ms[reps] - ms[0]) / reps * 1e3, "check": check,
                              "equals_single": equal}), flush=True)
    if not ok:
        raise AssertionError("an operation chain disagrees with the host curve or with "
                             "its single-lane kind")


def build(tree: str) -> None:
    sys.path.insert(0, tree)
    from bulletproofsplus_tpu_torch import kernels

    kernels.build()


def registers(tree: str) -> dict:
    """{("K2", point family, J), ("K1", words), ("K3", point family),
    ("K4", point family) or ("K5", point family): (registers, spill store
    bytes, spill load bytes)}
    from the tree's build.log (ptxas -v)."""
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
        elif "ladder_kernel" in fn:
            key = ("K5", next(f for k, f in fams.items() if k in fn))
        elif "sum_points_kernel" in fn or "fixed_lookup_kernel" in fn:
            fam = next(f for k, f in fams.items() if k in fn)
            key = ("K3" if "sum_points" in fn else "K4", fam)
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
    ap.add_argument("--kernels", default="K1,K2,K3,K4,K5", help="which of K1-K5 to time")
    ap.add_argument("--add-reps", type=int, default=1000,
                    help="dependent operations a chain of the latency probe (0: skip it)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--build", help=argparse.SUPPRESS)
    ap.add_argument("--add-chain", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    curves = args.curves.split(",")
    if args.build:
        build(args.build)
        return 0
    if args.worker:
        worker(args.worker, curves, args.reps, args.kernels.split(","))
        return 0
    if args.add_chain:
        sys.path.insert(0, ROOT)
        op_chains(curves, args.add_reps)
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
    add_us = {}
    if args.add_reps:
        res = subprocess.run([sys.executable, me, "--add-chain", "--curves", args.curves,
                              "--add-reps", str(args.add_reps)], capture_output=True, text=True)
        sys.stderr.write(res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"the latency probe failed (exit {res.returncode})")
        for text in res.stdout.splitlines():
            print(text, flush=True)
            probe = json.loads(text)
            add_us.setdefault(probe["curve"], {})[probe["kernel"]] = probe["us_per_op"]
    regs = {label: registers(tree) for label, tree in variants}
    runs = {label: [] for label, _ in variants}
    for label, tree in variants + variants[::-1]:
        res = subprocess.run([sys.executable, me, "--worker", tree, "--reps", str(args.reps),
                              "--curves", args.curves, "--kernels", args.kernels],
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
        us = add_us.get(key[1])
        if line0.get("G") == 1 and us:
            # ⌈log2 W⌉ dependent adds: what any tree over one group needs
            line["latency_floor_ms"] = (line0["W"] - 1).bit_length() * us["pt_add"] / 1e3
        if key[0] == "K5" and us:
            # one lane's chain: 14 table adds, then nwin windows of 4 doublings and an add
            line["latency_floor_ms"] = (line0["nwin"] * (4 * us["pt_dbl_quad"] + us["pt_add_quad"])
                                        + 14 * us["pt_add_quad"]) / 1e3
        for label, _ in variants:
            got = [run[i] for run in runs[label]]
            if any(g["key"] != key or g["digest"] != line0["digest"] for g in got):
                ok = False
                print(f"bench_torch_k2: {label} differs from {first} at {key}", file=sys.stderr)
            ms = [g["ms"] for g in got]
            line["variants"][label] = {
                "ms": ms, "mean_ms": sum(ms) / len(ms),
                "graph_ms": [g["graph_ms"] for g in got],
                "registers_spill": regs[label].get(tuple(line0["instance"])),
                **{k: got[0][k] for k in ("W", "partials", "nwin") if k in got[0]}}
        print(json.dumps(line), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
