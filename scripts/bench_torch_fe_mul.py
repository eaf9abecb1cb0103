#!/usr/bin/env python3
"""Time field.cuh's Montgomery product alone on one CUDA card.

Compiles scripts/bench_torch_fe_mul.cu with nvcc for sm_90a against each
field.cuh named on the command line (its directory goes first on the include
path), into bulletproofsplus_tpu_torch/build/, one unit a header, all at
once. For each header and width (N = 8 at secp256k1's p, N = 12 at
bls12-381's q) it prints one JSON line:

- products a second: every thread runs a chain of `--reps` dependent
  products x = x·y·R^-1, as a K2 thread does, over `--threads` threads (the
  card full many times over), timed with CUDA events, best of 3;
- the roofline's rate for the same count (roofline.py: 4·N² + N integer
  multiply-adds a product at 16.75 T/s);
- registers and spills of the chain kernel (ptxas -v);
- the SASS instruction mix of the kernel that computes one product
  (cuobjdump -sass): IMAD*, IADD3*, and the rest by opcode;
- the check: product, sum and difference of 4,096 operand pairs built from
  carry runs (words of all ones and of zeros, p − 1, values in [p/2, p)),
  and the chain's end values of its first 2,048 threads, against Python
  integers. Any difference fails the run.

The card's name and power limit (nvidia-smi) come first. To time the
parent commit's header beside the working tree's, in one call:

    git show HEAD:bulletproofsplus_tpu_torch/csrc/field.cuh > checkout_copy/parent/field.cuh
    python3 scripts/bench_torch_fe_mul.py checkout_copy/parent/field.cuh \\
        bulletproofsplus_tpu_torch/csrc/field.cuh

(checkout_copy/ is git-ignored.) With no header it times the working
tree's.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import random
import re
import subprocess
import sys
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from bulletproofsplus_tpu_torch import kernels, roofline  # noqa: E402
from bulletproofsplus_tpu_torch.curves import curve_ops  # noqa: E402
from bulletproofsplus_tpu_torch.fields.spec import ints_to_tensor, tensor_to_ints  # noqa: E402
from chip_smoke import carry_runs  # noqa: E402

SOURCE = os.path.join(ROOT, "scripts", "bench_torch_fe_mul.cu")
DEFAULT_HEADER = os.path.join(ROOT, "bulletproofsplus_tpu_torch", "csrc", "field.cuh")
# width → (curve, field) whose modulus the bench runs at
MODULI = {8: ("secp256k1", "fp"), 12: ("bls12_381", "fp")}
CHECK_PAIRS = 4096
CHAIN_CHECKED = 2048


def build(header: str) -> tuple:
    """(shared library path, ptxas log, cubin path) of the bench unit
    compiled against `header`."""
    with open(header, "rb") as f:
        tag = hashlib.sha256(f.read() + open(SOURCE, "rb").read()).hexdigest()[:12]
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    base = os.path.join(kernels.BUILD_DIR, f"bench_fe_mul_{tag}")
    nvcc = kernels.nvcc_path()
    flags = [*kernels.ARCH_FLAGS, "-std=c++17", "-O3",
             "-I", os.path.dirname(os.path.abspath(header))]
    so = subprocess.run([nvcc, *flags, "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v",
                         SOURCE, "-o", base + ".so"], capture_output=True, text=True)
    if so.returncode != 0:
        raise RuntimeError(f"nvcc failed on {header}:\n{so.stderr}")
    cubin = subprocess.run([nvcc, *flags, "-cubin", SOURCE, "-o", base + ".cubin"],
                           capture_output=True, text=True)
    if cubin.returncode != 0:
        raise RuntimeError(f"nvcc -cubin failed on {header}:\n{cubin.stderr}")
    return base + ".so", so.stderr, base + ".cubin"


def registers(log: str, kernel: str, nl: int) -> tuple:
    """(registers, spill store bytes, spill load bytes) of `kernel` at width
    nl from ptxas -v output (mangled names carry the template argument)."""
    pat = re.compile(rf"Compiling entry function '(\S*{kernel}\S*Li{nl}E\S*)'")
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if pat.search(line):
            block = "\n".join(lines[i:i + 5])
            regs = int(re.search(r"Used (\d+) registers", block).group(1))
            st, ld = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block).groups()
            return regs, int(st), int(ld)
    raise RuntimeError(f"no ptxas line for {kernel}<{nl}>")


def sass_mix(cubin: str, nl: int) -> dict:
    """Opcode counts of one_mul_kernel<nl>: IMAD*, IADD3* and the rest."""
    out = subprocess.run([os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump"),
                          "-sass", cubin], capture_output=True, text=True, check=True).stdout
    body, inside = [], False
    for line in out.splitlines():
        if "Function :" in line:
            inside = "one_mul_kernel" in line and f"Li{nl}E" in line
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if inside and m:
            body.append(m.group(1))
    ops = Counter(op.split(".")[0] for op in body)
    imad = sum(v for k, v in ops.items() if k == "IMAD")
    iadd3 = sum(v for k, v in ops.items() if k == "IADD3")
    rest = {k: v for k, v in ops.items() if k not in ("IMAD", "IADD3", "NOP")}
    return {"total": len(body) - ops.get("NOP", 0), "IMAD": imad, "IADD3": iadd3,
            "IMAD_forms": dict(Counter(op for op in body if op.startswith("IMAD"))),
            "rest": dict(sorted(rest.items(), key=lambda kv: -kv[1]))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("headers", nargs="*", default=[DEFAULT_HEADER])
    ap.add_argument("--threads", type=int, default=132 * 2048 * 4)
    ap.add_argument("--reps", type=int, default=256)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_fe_mul: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    with ThreadPoolExecutor(len(args.headers)) as pool:
        built = list(pool.map(build, args.headers))
    dev = torch.device("cuda:0")
    stream = torch.cuda.current_stream(dev).cuda_stream
    ok = True
    for header, (so, log, cubin) in zip(args.headers, built):
        lib = ctypes.CDLL(so)
        lib.bench_fe.argtypes = [ctypes.c_int, *[ctypes.c_void_p] * 3, ctypes.c_longlong,
                                 ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint32),
                                 ctypes.c_void_p]
        for nl, (cname, which) in MODULI.items():
            f = getattr(curve_ops(cname), which)
            p, spec = f.p, f.spec
            mod = (ctypes.c_uint32 * (nl + 1))(*spec.p_words, spec.n0inv)
            rinv = pow(1 << (32 * nl), -1, p)

            def call(what, a, b, out, n, reps=0):
                err = lib.bench_fe(what, a.data_ptr(), b.data_ptr(), out.data_ptr(), n, reps,
                                   nl, mod, stream)
                if err:
                    raise RuntimeError(f"bench_fe({what}) failed: CUDA error {err}")

            rnd = random.Random(nl)
            xs = carry_runs(p, nl, CHECK_PAIRS, rnd)
            ys = carry_runs(p, nl, CHECK_PAIRS, rnd)
            rnd.shuffle(ys)
            a, b = ints_to_tensor(xs, dev, nl), ints_to_tensor(ys, dev, nl)
            out = torch.empty((3 * CHECK_PAIRS, nl), dtype=torch.int32, device=dev)
            call(1, a, b, out, CHECK_PAIRS)
            got = tensor_to_ints(out.reshape(CHECK_PAIRS, 3, nl))
            want = [v for x, y in zip(xs, ys) for v in (x * y * rinv % p, (x + y) % p, (x - y) % p)]
            bad = sum(g != w for g, w in zip(got, want))

            n = args.threads
            pick = torch.randint(0, CHECK_PAIRS, (n,), generator=torch.Generator().manual_seed(nl))
            x0, y0 = a[pick.to(dev)].contiguous(), b[pick.flip(0).to(dev)].contiguous()
            xo = torch.empty_like(x0)
            call(0, x0, y0, xo, n, args.reps)
            torch.cuda.synchronize()
            ms = []
            for _ in range(3):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                call(0, x0, y0, xo, n, args.reps)
                end.record()
                torch.cuda.synchronize()
                ms.append(start.elapsed_time(end))
            head = CHAIN_CHECKED
            xi, yi = tensor_to_ints(x0[:head]), tensor_to_ints(y0[:head])
            chain_want = [x * pow(y * rinv, args.reps, p) % p for x, y in zip(xi, yi)]
            bad += sum(g != w for g, w in zip(tensor_to_ints(xo[:head]), chain_want))
            products = n * args.reps
            regs, spill_st, spill_ld = registers(log, "chain_kernel", nl)
            line = {"header": os.path.relpath(os.path.abspath(header), ROOT), "nl": nl,
                    "modulus": f"{cname} {which}", "threads": n, "reps": args.reps,
                    "ms": ms, "products_per_s": products / (min(ms) / 1e3),
                    "roofline_products_per_s": roofline.INT_MADS_PER_S / roofline.fe_mul_mads(nl),
                    "registers": regs, "spill_bytes": [spill_st, spill_ld],
                    "sass_one_mul": sass_mix(cubin, nl), "mismatches": bad,
                    "checked": 3 * CHECK_PAIRS + head}
            line["share_of_roofline"] = line["products_per_s"] / line["roofline_products_per_s"]
            print(json.dumps(line), flush=True)
            ok &= bad == 0
    if not ok:
        print("bench_torch_fe_mul: results differ from Python integers", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
