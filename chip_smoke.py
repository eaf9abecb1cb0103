#!/usr/bin/env python3
"""Drive the PyTorch port's batch range-proof verifier once on one CUDA card.

Phases (any failure exits nonzero before the final line):
  1. build the four kernels from bulletproofsplus_tpu_torch/csrc; print the
     card's name and power limit (nvidia-smi);
  2. hold K1 (Montgomery multiply), K2 (joint ladder) and K3 (grouped point
     sum) against their plain PyTorch versions on the card, at the shapes
     of the batch below, and time both;
  3. build PublicKey.new(n·m) and its fixed-base tables on the card, then
     hold K4 (fixed-base lookup) against its plain version on those tables
     (unsigned) and on a smaller signed table;
  4. batch-verify K = 256 statements at edwards25519, n = 64, m = 16
     (statement k is fixture proof k mod P, each with its own random
     weight: the MSM work of 256 proofs) with every launch counter at 0
     before the run; the batch must accept and every kernel must have run;
  5. the same batch with one scalar of one proof changed must reject;
  6. single verify (K = 1) of one fixture proof must accept; the exponent
     vectors of two proofs must equal those of the plain (CPU) path;
  7. print warm batch timings (best of 3), the kernels' JSON line, and
     the device line last.

The statements are golden-oracle proofs committed in
bulletproofsplus_tpu_torch/data (scripts/make_torch_fixtures.py), because
the prover is not ported yet. Usage: python3 chip_smoke.py [--seed S]
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

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "bulletproofsplus_tpu_torch", "data",
                       "ed25519_n64_m16_det.bin")
K_BATCH = 256
DEVICE = "cuda:0"


def log(msg: str) -> None:
    print(f"[chip_smoke +{time.time() - T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over `reps` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def once_ms(fn):
    """(result, milliseconds) of one call, synchronized."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def int_err(xs, ys) -> int:
    """Largest absolute difference between two equal-length int sequences."""
    if len(xs) != len(ys):
        raise AssertionError("result lengths differ")
    return max((abs(a - b) for a, b in zip(xs, ys)), default=0)


def affine_ints(curve, pts) -> list:
    out = []
    for A in curve.decode_points(pts):
        out += [0, 1] if A is None else list(A)
    return out


def random_points(count: int, seed: int, device):
    """count distinct points (a + i·b)·B by host running sums."""
    from bulletproofsplus_tpu_torch import curve_ops
    from bulletproofsplus_tpu_torch.curves import host

    rnd = random.Random(seed)
    B = host.to_ext(host.BASE)
    step = host.ext_mul(B, rnd.randrange(1, 1 << 64))
    cur = host.ext_mul(B, rnd.randrange(1, 1 << 64))
    pts = []
    for _ in range(count):
        pts.append(cur)
        cur = host.ext_add(cur, step)
    return curve_ops().encode_points(host.to_affine(pts), device)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 2

    from bulletproofsplus_tpu_torch import (
        DeterministicTranscript,
        ProofBatch,
        PublicKey,
        VerificationError,
        batch_verify,
        curve_ops,
        kernels,
        serialize,
        verify,
    )
    from bulletproofsplus_tpu_torch.curves import cuda_curve as cc
    from bulletproofsplus_tpu_torch.fields.mont_mul import mont_mul, mont_mul_plain
    from bulletproofsplus_tpu_torch.msm.engine import joint_width
    from bulletproofsplus_tpu_torch.msm.fixed import precompute_tables_signed
    from bulletproofsplus_tpu_torch.protocol.range import (
        replay_batch,
        vinputs_multiple_batched,
    )

    dev = torch.device(DEVICE)
    curve = curve_ops()
    fn, fp = curve.fn, curve.fp
    rnd = random.Random(args.seed)
    results = {}

    # -- 1. build + card ---------------------------------------------------
    t = time.time()
    kernels.library()
    log(f"kernels built/loaded in {time.time() - t:.1f} s")
    for line in kernels.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(line.strip(), file=sys.stderr)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")

    # shapes of the K = 256, n = 64, m = 16 batch
    with open(FIXTURE, "rb") as f:
        n, m, rows = serialize.read_fixture(f.read())
    mn = n * m
    logn = mn.bit_length() - 1
    var_lanes = K_BATCH * (3 + 2 * logn + m) + 2
    J = joint_width(var_lanes)
    G = -(-var_lanes // J)
    nbits = fn.order_bits

    # -- 2. K1, K2, K3 against their plain versions -------------------------
    N1 = K_BATCH * mn
    a = fn.encode([rnd.randrange(fn.p) for _ in range(N1)], dev)
    b = fn.encode([rnd.randrange(fn.p) for _ in range(N1)], dev)
    ker = mont_mul(a, b, fn.spec)
    ref, plain_ms = once_ms(lambda: mont_mul_plain(a, b, fn.spec))
    err = int_err(fn.decode(ker), fn.decode(ref))
    ms = cuda_ms(lambda: mont_mul(a, b, fn.spec), 20)
    results["K1"] = (err, ms, plain_ms)
    log(f"K1 mont_mul N={N1}: err {err}, kernel {ms:.4f} ms, plain {plain_ms:.1f} ms")

    pts = random_points(G * J, rnd.randrange(1 << 30), dev).reshape(G, J, 4, 8)
    scal = fn.encode_plain([rnd.randrange(fn.p) for _ in range(G * J)], dev).reshape(G, J, 8)
    flat_s, flat_p = scal.reshape(G * J, 8), pts.reshape(G * J, 4, 8)
    ker = cc.joint_ladder_msm_grouped(curve, flat_s, flat_p, nbits, J)   # (G, 4, 8)
    ref, plain_ms = once_ms(lambda: cc.joint_ladder_plain(curve, scal, pts, nbits))
    err = int_err(fp.decode_plain(ker), fp.decode_plain(ref))
    ms = cuda_ms(lambda: cc.joint_ladder_msm_grouped(curve, flat_s, flat_p, nbits, J), 3)
    results["K2"] = (err, ms, plain_ms)
    log(f"K2 joint ladder G={G} J={J}: err {err}, kernel {ms:.3f} ms, plain {plain_ms:.1f} ms")

    grp = ker[None]                                   # (1, G, 4, 8): the MSM's sum
    ker3 = cc.sum_points_grouped(curve, grp)
    ref3, plain_ms = once_ms(lambda: cc.sum_points_plain(curve, grp))
    err = int_err(affine_ints(curve, ker3), affine_ints(curve, ref3))
    multi = random_points(5 * 300, 7, dev).reshape(5, 300, 4, 8)
    err = max(err, int_err(affine_ints(curve, cc.sum_points_grouped(curve, multi)),
                           affine_ints(curve, cc.sum_points_plain(curve, multi))))
    ms = cuda_ms(lambda: cc.sum_points_grouped(curve, grp), 20)
    results["K3"] = (err, ms, plain_ms)
    log(f"K3 sum_points W={G}: err {err}, kernel {ms:.4f} ms, plain {plain_ms:.1f} ms")

    # -- 3. public key, tables, K4 -----------------------------------------
    t = time.time()
    pk = PublicKey.new(curve, mn, dev)
    tables = pk.fixed_tables(mn)
    torch.cuda.synchronize()
    log(f"PublicKey.new({mn}) + fixed tables {tuple(tables.shape)} "
        f"({tables.numel() * 4 / 1e6:.0f} MB) in {time.time() - t:.1f} s")
    gen_s = fn.encode_plain([rnd.randrange(fn.p) for _ in range(2 * mn)], dev)
    dig = cc.fixed_digits(curve, gen_s, nbits, signed=False)
    ker4 = cc.fixed_lookup_partials(curve, tables, dig, False)
    ref4, plain_ms = once_ms(lambda: cc.fixed_lookup_plain(curve, tables, dig, False))
    err = int_err(affine_ints(curve, cc.sum_points_plain(curve, ker4[None])),
                  affine_ints(curve, ref4))
    small = random_points(32, 11, dev)
    stab = precompute_tables_signed(curve, small)
    sdig = cc.fixed_digits(curve, gen_s[:32], nbits, signed=True)
    err = max(err, int_err(
        affine_ints(curve, cc.sum_points_plain(
            curve, cc.fixed_lookup_partials(curve, stab, sdig, True)[None])),
        affine_ints(curve, cc.fixed_lookup_plain(curve, stab, sdig, True))))
    ms = cuda_ms(lambda: cc.fixed_lookup_partials(curve, tables, dig, False), 20)
    results["K4"] = (err, ms, plain_ms)
    log(f"K4 fixed lookup lanes={dig.numel()}: err {err}, kernel {ms:.4f} ms, "
        f"plain {plain_ms:.1f} ms")
    for name, (err, _, _) in results.items():
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version (err {err})")

    # -- 4. batch verify K = 256 -------------------------------------------
    t = time.time()
    decoded = [serialize.proof_from_bytes(curve, wire, dev) for _, wire in rows]
    comms = torch.stack([curve.encode_points(serialize.points_from_bytes(c), dev)
                         for c, _ in rows])
    P = len(rows)
    idx = torch.arange(K_BATCH, device=dev) % P
    batch = ProofBatch.from_proofs(decoded).take(idx)
    V = comms[idx]
    log(f"decoded {P} fixture statements in {time.time() - t:.1f} s")
    wrng = random.Random(args.seed + 1)

    def run_batch(b=batch):
        batch_verify(curve, pk, n, b, V, [DeterministicTranscript(m)] * K_BATCH,
                     rng=lambda: wrng.getrandbits(128))

    wrappers = {"K1": mont_mul, "K2": cc.joint_ladder_msm_grouped,
                "K3": cc.sum_points_grouped, "K4": cc.fixed_lookup_partials}
    for w in wrappers.values():
        w.launches = 0
    _, first_ms = once_ms(run_batch)
    launches = {k: w.launches for k, w in wrappers.items()}
    log(f"batch_verify K={K_BATCH} accepted ({first_ms:.1f} ms); launches {launches}")
    missing = [k for k, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    warm = [once_ms(run_batch)[1] for _ in range(3)]
    best = min(warm)
    log(f"warm batch_verify: {[round(x, 1) for x in warm]} ms; best {best:.1f} ms "
        f"= {K_BATCH / best * 1e3:.1f} verify/s")

    # -- 5. tampered batch --------------------------------------------------
    bad = batch.take(slice(None))
    bad.r_prime = bad.r_prime.clone()
    bad.r_prime[0] = fn.add(bad.r_prime[0], fn.one(dev))
    try:
        run_batch(bad)
    except VerificationError:
        log("tampered batch rejected")
    else:
        raise AssertionError("tampered batch was accepted")

    # -- 6. single verify and exponent vectors vs the plain path ------------
    _, single_ms = once_ms(lambda: verify(curve, decoded[0], pk, n, comms[0],
                                          DeterministicTranscript(m)))
    log(f"single verify accepted ({single_ms:.1f} ms)")
    challenges = replay_batch(curve, n, m, [DeterministicTranscript(m)] * 2)
    ys, zs, ess, efs = challenges

    def exponents(f, device):
        two = batch.take(slice(0, 2))
        return vinputs_multiple_batched(
            f, n, m, f.encode(ys, device), f.encode(zs, device),
            f.encode([e for es in ess for e in es], device).reshape(2, -1, 8),
            f.encode(efs, device), two.r_prime.to(device),
            two.s_prime.to(device), two.d_prime.to(device))

    dev_out = exponents(fn, dev)
    cpu_out = exponents(fn, "cpu")
    for x, y in zip(dev_out, cpu_out):
        if not torch.equal(x.cpu(), y):
            raise AssertionError("device exponent vectors differ from the plain path")
    log("exponent vectors (K=2) equal on card and CPU")

    # -- 7. report ------------------------------------------------------------
    sources = {"K1": ("mont_mul", "mont_mul.cu", "fields/pallas_ops.py:369"),
               "K2": ("joint_ladder", "joint_ladder.cu", "curves/pallas_curve.py:718"),
               "K3": ("sum_points", "sum_points.cu", "curves/pallas_curve.py:553"),
               "K4": ("fixed_lookup", "fixed_lookup.cu", "curves/pallas_curve.py:371")}
    report = [{"name": f"{k} {name}", "route": "cuda",
               "source": f"bulletproofsplus_tpu_torch/csrc/{src}",
               "replaces": f"bulletproofsplus_tpu/{tpu}",
               "launches": launches[k], "max_abs_err": results[k][0],
               "ms": results[k][1], "plain_ms": results[k][2]}
              for k, (name, src, tpu) in sources.items()]
    print(json.dumps({"batch_verify": {"K": K_BATCH, "n": n, "m": m,
                                       "first_ms": first_ms, "warm_ms": warm,
                                       "verify_per_s": K_BATCH / best * 1e3,
                                       "single_ms": single_ms}}))
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


T0 = time.time()

if __name__ == "__main__":
    sys.exit(main())
