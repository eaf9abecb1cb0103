#!/usr/bin/env python3
"""Drive the PyTorch port's batch prover and verifier once on one CUDA card.

Phase 1 builds the kernels from bulletproofsplus_tpu_torch/csrc and prints
the card's name and power limit (nvidia-smi). Then, for each curve in
turn (edwards25519 at n = 64, m = 16 from its BPPF1 fixture, secp256k1 at
n = 64, m = 64 and bls12-381 G1 at n = 64, m = 256 from their BPPF2
fixtures; K = 256 for all three), any failure exiting nonzero before the
final line:
  2. hold K1 (Montgomery multiply) against its plain PyTorch version at both
     of the curve's moduli on 262,144 elements that include p − 1, values
     in [p/2, p) and carry runs (words of all ones and of zeros; bls12-381's
     Fq at 12 words a value), timed through its wrapper and as a CUDA graph
     of launches (no host work); then, at both moduli, the field kernels
     around it at the path's shapes, on operands drawn from the same kind of
     values: fe_add with a (K, 1) operand broadcast over (K, mn), fe_sub
     and fe_neg on (K, mn), fe_sum over K of (K, mn) (the RLC merge) and
     over the row of (K, mn/2) (round 0's c_L), fe_pow by p − 2 on K
     values (no path calls it since fe_inv) and fe_inv (the divstep
     inversion every path runs) on the same K values with one 0, also
     against fe_pow_plain(·, p − 2) word for word; and K2 (joint ladder,
     J = 8) and K3 (grouped point sum) at the shapes of the verify batch
     below (edwards25519: 1,249 groups; secp256k1: 2,913; bls12-381: 9,185,
     K2 compared on its first 4,096), and time both;
  3. build PublicKey.new(n·m) and its fixed-base tables on the card, then
     hold K4 (fixed-base lookup) against its plain version on those tables
     (unsigned; its partial count printed) and on a smaller signed table,
     K3 at the verify's tail shape (one group of K2's outputs above and
     K4's partials: the one K3 of batch_verify's two MSMs) and fixed_msm
     (K4, then K3 over its partials);
  4. batch-verify K = 256 statements (statement k is fixture proof k mod P,
     each with its own random weight: the MSM work of 256 proofs) with every
     launch counter at 0 before the run; the batch must accept and K1 (its
     product and every field kernel) and K2-K4 must have run; then one run
     under torch.profiler counts each stage's launches;
  5. the same batch with one scalar of one proof changed must reject;
  6. single verify (K = 1) of one fixture proof must accept; on
     edwards25519 the exponent vectors of two proofs must equal those of
     the plain (CPU) path;
  7. hold the prover's kernels against their plain versions at its shapes:
     K5 (per-lane ladder, four threads a lane; 256 lanes at the group
     order's width, with a zero scalar and the identity, then its first 37
     lanes and one lane, a single prove's h·α), K2 at J = 2 on K·mn
     groups (round 0's generator fold) and at J = 4 on 2K·(mn + 4)/4
     groups (round 0's L/R, zero-scalar identity padding included), K3
     over 2K × (mn + 4)/4 points
     (L/R's sums) and K × (mn + 1) points (the bit commitments), on the
     key's generators with seeded random scalars and bits; K2 is timed at
     its full shape and compared on its first 16,384 groups; and K2 at J = 2
     and 4 on 4,096 groups whose coordinates and scalars are carry runs
     (words of all ones and of zeros);
  8. rebuild the fixture's witnesses, commit them (each commitment must
     equal the fixture's bytes) and batch-prove them on the card: every
     proof must equal the committed golden-made bytes;
  9. batch-prove the K = 256 statements of bench.py (v = (7k + 3i + 2) mod
     2^n, γ = 2i + k + 3), committed outside the timed window by host running
     sums (V(k, i) = V(k, i − 1) + 3g + 2h, V(k, 0) = V(k − 1, 0) + 7g + h,
     one shared inversion; a sample must equal PublicKey.commitment), with
     every launch counter at 0 before the first run; K1 (product and field
     kernels), K2, K3 and K5 must have run; one profiled run counts each
     stage's launches; then batch-verify the proven batch (accept) and a
     tampered copy (reject);
 10. prove and verify one m = 1 statement at n = 64;
 11. the fs256 transcript, the port's default: hold the SHA-256 kernel
     (csrc/sha256.cu) against its plain version, bit for bit, at each
     message length of a K = 256 replay by SHA launches (the statement
     absorb of m + 1 points, an (L, R) or (A, B) absorb, a challenge's
     state step, its two halves over 2K messages) and against hashlib on a
     few rows; hold the fs256 chain kernel (csrc/fs256_chain.cu) against
     its plain version, bit for bit, at the K = 256 verifier's schedule and
     the prover's round step, both also from a CUDA graph; batch-prove
     the bench statements with fresh Fs256Transcripts (counters at 0 before
     the run; K1, K2, K3, K5 and the chain must have run), hold fe_inv on
     the Z column that batch's replay inverts and the identity's Z (0 on
     a Weierstrass curve), the card's
     replay of that batch must equal the host twin's on a sample of proofs,
     and the prover's transcripts must end in the host twin's final state;
     batch-verify it by default (the card's replay; K1-K4 and the chain
     must have run)
     and a tampered copy must reject; both timed beside the deterministic
     mode's verify of the deterministic bench batch, in the same call, and
     profiled once; one m = 1 prove and verify with the default transcript.
 12. the facade, on edwards25519 at n = 64, m = 16: for each of the four
     modes (deterministic, fs256, sha, merlin) a RangeProofSystem with
     hash-derived generators (PublicKey.new_secure) on the card: one
     statement proven and verified, its proof through its bytes and back,
     then K statements (bench.py's values and blinds; K = 256 in sha mode,
     16 in the others) batch-proven and batch-verified with every launch
     counter at 0 before each (every mode must launch K1's family, K2, K3
     and K5 proving and K1's family, K2-K4 verifying; fs256 also the
     chain), a copy with one proof tampered
     rejected, and batch_verify_identify naming that proof; the sha and
     merlin K proves run once more under torch.profiler for the host time
     of each round (decode, hash, upload). Then sha and merlin batches of
     K = 2 small statements (n = 8, m = 2, DeterministicRng) proven on the
     card must equal, byte for byte, the same statements proven on the CPU
     by the port's plain path (a helper process started after the build,
     `chip_smoke.py --cpu-proofs FILE`, runs it while the card works).
 13. distribution (parallel/): meshes over distinct cards where the machine
     has them, else the first card listed several times (the count of
     distinct cards is printed). BASELINE config 5 (edwards25519, n = 64,
     m = 16, K = 1,024 of bench.py's statements), in deterministic and
     fs256 mode, batch-verified over 1 x 1, 1 x 4 (the tp path, each shard
     on its own table slice) and 2 x 2 (the dp path, one group a row) with
     every launch counter at 0 before each, each shard's launches counted
     (K2, K3 and, with tables, K4 on every shard; fs256 also the chain), a
     copy with proof 3K/4 (row 1 of 2 x 2) tampered rejected over each,
     batch_verify_identify over 1 x 4 naming it, each mesh timed in turns
     beside the unsharded verify and profiled once for each K2/K3/K4
     launch's device ms; K4 on a shard's table slice, the gather's K3 and
     K2 at a 2 x 2 shard's shape held against their plain versions; then
     sharded_prove over 1 x 4 (n = 64, m = 16): its bytes equal prove's,
     deterministic (also over 1 x 1) and fs256 with one seeded rng (the
     fs256 proof verifies, its transcript ends in prove's state; K1, K2,
     K3, K5 and the chain must launch); bls12-381's phase-9 batch (n = 64, m = 256, K = 256,
     deterministic) over 1 x 4, each shard's table bytes printed, accepted,
     a tampered copy rejected, timed beside the unsharded verify; the
     serving demo (python -m bulletproofsplus_tpu_torch.serve_batch) over
     2 x 2 at K = 8; and two processes of python -m
     bulletproofsplus_tpu_torch.parallel.worker (a file rendezvous, Gloo,
     a local 1 x 2 mesh each, global dp = 2; n = 64, m = 16, K = 256), both
     of which must accept the batch and reject the tampered copy.
 14. the coefficient-form prover (protocol/wip_coeff.py) and the bucket
     MSM (csrc/pippenger.cu): bench.py's statements on edwards25519 (n =
     64, m = 16, K = 256) batch-proven three ways, the fold (BPP_PROVER
     unset), BPP_PROVER=coeff on the joint ladder and BPP_PROVER=coeff
     BPP_PIPPENGER=1 (the L/R rows on the buckets), each with every launch
     counter at 0 before it (K1's family, K2, K3 and K5 must launch, the
     bucket kernels on the third way only); the three batches' bytes must
     be equal, each must verify and a tampered copy reject; warm times in
     three turns and one profile a way (stages, each kernel's launches and
     device ms). Then secp256k1 (m = 64, K = 16) and bls12-381 (m = 256, K
     = 4) the same three ways (bytes equal, verify, reject), and `prove` at
     K = 1 with the coefficient form on the buckets on every curve (bytes
     equal the fold's). The bucket kernels (accumulate, merge, reduce) are
     held against their plain versions on one K = 1 L/R row set of the
     edwards25519 headline (20 rows x 1,026 pairs on the key's
     generators) on each curve, and on one row of 2mn + 2 pairs with every
     seventh scalar 0 and a padded last slice, the reduce word for word
     at the segment count its wrapper picks (8 at the row set), at 1 and
     at a thread a window (K = 256's); the K = 256 batch's reduce launch
     and its bound are
     recorded; last, timed only, the
     bucket MSM at the K = 256 verifier's variable-MSM shape (one row of
     9,986 lanes) beside K2 + K3 there.
Every counted run of a path fails if fe_pow launched in it (FieldOps.inv
runs fe_inv). Last, it prints each curve's batch timings on their own lines, the facade's
line, the distribution line, the coefficient prover's line, the launches
of each profiled stage, the kernels' JSON line (one row for each curve,
kernel and shape held above: time through the wrapper, and for K1's family,
K3, K4, K5, SHA, the chain and the bucket kernels also from a CUDA graph;
plain time, bound and launches),
the card, and the device line.

Usage: python3 chip_smoke.py [--seed S]
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import random
import re
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "bulletproofsplus_tpu_torch", "data")
FIXTURES = {"edwards25519": os.path.join(DATA, "ed25519_n64_m16_det.bin"),
            "secp256k1": os.path.join(DATA, "secp256k1_n64_m64_det.bin"),
            "bls12_381": os.path.join(DATA, "bls12_381_n64_m256_det.bin")}
K_BATCH = 256
K1_ELEMENTS = 262_144
PLAIN_PREFIX = 16_384   # groups on which K2 at the prover's shapes meets its plain version
# groups on which K2 at the verify shape meets its plain version, where that
# is not all of them (the plain ladder at 12 words and 9,185 groups)
VERIFY_PREFIX = {"bls12_381": 4_096}
CARRY_GROUPS = 4_096    # groups of K2's carry-run holds at J = 2 and 4
DEVICE = "cuda:0"
# K1 is its product and the field kernels around it (csrc/field_ops.cu); the
# JAX package runs those as XLA-fused jnp (FieldOps methods, fields/ops.py),
# so K1's Pallas call is what each of them stands beside
FIELD_KERNELS = {"K1": "mont_mul", "K1 add": "fe_add", "K1 sub": "fe_sub",
                 "K1 neg": "fe_neg", "K1 sum": "fe_sum", "K1 pow": "fe_pow",
                 "K1 inv": "fe_inv"}
# the field kernels every proving and verifying path launches: all but
# fe_pow, which no path calls since FieldOps.inv runs fe_inv (`counted`
# fails if one does)
PATH_FIELD_KERNELS = tuple(k for k in FIELD_KERNELS if k != "K1 pow")
JAX_COUNTERPARTS = {"K1": "fields/pallas_ops.py:331", "K1 add": "fields/ops.py:205",
                    "K1 sub": "fields/ops.py:209", "K1 neg": "fields/ops.py:213",
                    "K1 sum": "fields/ops.py:389", "K1 pow": "fields/ops.py:298",
                    "K1 inv": "fields/ops.py:339"}
SOURCES = {**{k: (fname, "field_ops.cu", "fields/pallas_ops.py:369")
              for k, fname in FIELD_KERNELS.items()},
           "K2": ("joint_ladder", "joint_ladder.cu", "curves/pallas_curve.py:718"),
           "K3": ("sum_points", "sum_points.cu", "curves/pallas_curve.py:553"),
           "K4": ("fixed_lookup", "fixed_lookup.cu", "curves/pallas_curve.py:371"),
           "K5": ("ladder", "ladder.cu", "curves/pallas_curve.py:253"),
           # no Pallas kernel: the JAX package's SHA-256 and its fs256 chain
           # are XLA-fused jnp
           "SHA": ("sha256_words", "sha256.cu", "hashers_device.py:123"),
           "chain": ("fs256_chain", "fs256_chain.cu", "protocol/fs256.py:137"),
           # no Pallas kernel: the JAX package's bucket MSM is XLA (lax.scan
           # over a gather, a point add and a scatter; the merge; the suffix
           # sums and Horner)
           "Pip acc": ("bucket_accumulate", "pippenger.cu", "msm/pippenger.py:94"),
           "Pip merge": ("bucket_merge", "pippenger.cu", "msm/pippenger.py:112"),
           "Pip reduce": ("bucket_reduce", "pippenger.cu", "msm/pippenger.py:123")}
VERIFY_STAGES = ("bpp::exponents", "bpp::rlc_merge", "bpp::variable_msm",
                 "bpp::fixed_msm", "bpp::msm_sum", "bpp::identity_check")
PROVE_STAGES = ("bpp::bit_commitment", "bpp::prove_setup", "bpp::fold_round",
                "bpp::final_ab")
FS256_VERIFY_STAGES = ("bpp::fs256_replay", *VERIFY_STAGES)
FS256_PROVE_STAGES = ("bpp::bit_commitment", "bpp::fs256_statement", "bpp::prove_setup",
                      "bpp::fold_round", "bpp::fs256_challenge", "bpp::final_ab")
FS256_SAMPLE = 4        # proofs whose card replay meets the host twin's
TRACE = os.path.join(ROOT, "bulletproofsplus_tpu_torch", "build", "chip_smoke_trace.json")
FACADE_CURVE, FACADE_N, FACADE_M = "edwards25519", 64, 16
FACADE_K = {"deterministic": 16, "fs256": 16, "sha": 256, "merlin": 16}
# an interactive round's host work: the whole round trip, then its parts
# (the fetch waits for the round's L and R on the card)
HOST_ROUND_STAGES = ("bpp::host_challenge", "bpp::host_fetch", "bpp::host_decode",
                     "bpp::host_hash", "bpp::host_upload")
INTERACTIVE_PROVE_STAGES = ("bpp::bit_commitment", "bpp::host_statement", "bpp::prove_setup",
                            "bpp::fold_round", "bpp::final_ab", *HOST_ROUND_STAGES)
# the small statements proven on both the card and the CPU: K, n, m
PARITY_K, PARITY_N, PARITY_M = 2, 8, 2
CPU_PROOFS = os.path.join(ROOT, "bulletproofsplus_tpu_torch", "build", "chip_smoke_cpu_proofs.json")
# phase 13, distribution: BASELINE config 5 (BASELINE.md:35) on edwards25519
DIST_CURVE, DIST_N, DIST_M, DIST_K = "edwards25519", 64, 16, 1024
DIST_MESHES = {"1x1": (1, 1), "1x4": (4, 1), "2x2": (4, 2)}      # name: (devices, dp)
DIST_TURNS = 3
DIST_BLS = "bls12_381"          # its phase-9 batch (n = 64, m = 256, K = 256) over 1 x 4
DIST_PREFIX = 256               # groups on which the 2 x 2 shard's K2 meets its plain version
WORKER_N, WORKER_M, WORKER_K = 64, 16, 256
WORKER_TIMEOUT = 300
SERVE_K = 8
# device kernels by name in a profiler trace
DEVICE_KERNELS = {"K2": "joint_ladder_kernel", "K3": "sum_points_kernel",
                  "K4": "fixed_lookup_kernel"}
# phase 14, the coefficient-form prover: the headline batch (bench.py's
# statements, edwards25519, n = 64, m = 16) and the other curves' batches
COEFF_CURVE, COEFF_K = "edwards25519", 256
COEFF_OTHER_K = {"secp256k1": 16, "bls12_381": 4}
COEFF_TURNS = 3
COEFF_ROWS_N = 1024     # the headline's n·m: its L/R row set, 20 rows x 1,026 pairs
# each way's switches (None: unset, the JAX package's defaults)
COEFF_WAYS = {"fold": {"BPP_PROVER": None, "BPP_PIPPENGER": None},
              "coeff": {"BPP_PROVER": "coeff", "BPP_PIPPENGER": None},
              "coeff_pippenger": {"BPP_PROVER": "coeff", "BPP_PIPPENGER": "1"}}
COEFF_STAGES = ("bpp::bit_commitment", "bpp::prove_setup", "bpp::fold_round",
                "bpp::coeff_rows", "bpp::rows_msm", "bpp::final_ab")
BUCKETS = ("Pip acc", "Pip merge", "Pip reduce")
# the reduce's segment counts held at the K = 1 L/R row set: the wrapper's
# own (None: 8 there; the 63 digits 1..63 split 7 to segment 0 and 8 to
# each other), 1, and 0 (a thread a window), the count at K = 256
REDUCE_SEGMENTS_HELD = (None, 1, 0)
# device kernels of a prove by name in a profiler trace (K1's product is
# the elementwise kernel's op 0)
PROVE_KERNELS = {"K1": r"elementwise_kernel<\d+, 0>",
                 "K1 family": r"elementwise_kernel<\d+, [123]>|sum_kernel|pow_kernel|inv_kernel",
                 "K2": r"joint_ladder_kernel", "K3": r"sum_points_kernel",
                 "K5": r"(?<![a-z_])ladder_kernel", "Pip acc": r"bucket_accumulate_kernel",
                 "Pip merge": r"bucket_merge_kernel",
                 # a reduce launch is two kernels: the window sums (on quads,
                 # or a thread a window), then Horner
                 "Pip reduce windows": r"bucket_reduce_windows_(lane_)?kernel",
                 "Pip reduce Horner": r"bucket_reduce_horner_kernel"}
RENDEZVOUS = os.path.join(ROOT, "bulletproofsplus_tpu_torch", "build", "chip_smoke_rendezvous")


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


def graph_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of `fn`'s launches replayed from a CUDA
    graph of `reps` calls: the device's time without the host's."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def union_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def stage_profile(run, stages, trace: str = TRACE):
    """Run `run` once under torch.profiler and write its Chrome trace to
    `trace`. Returns (per stage: host_ms, device_span_ms, device_busy_ms and
    the kernels launched inside its range; the run's wall_ms, device_busy_ms
    and kernel_launches; the profiler; the trace's kernel events)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    os.makedirs(os.path.dirname(os.path.abspath(trace)), exist_ok=True)
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    per_stage = {}
    for name in stages:
        host = [e for e in events if e.get("name") == name
                and e.get("cat") == "user_annotation"]
        spans = [(g["ts"], g["ts"] + g["dur"]) for g in events
                 if g.get("name") == name and g.get("cat") == "gpu_user_annotation"]
        mine = [e for e in kernels if any(lo <= e["ts"] <= hi for lo, hi in spans)]
        per_stage[name] = {
            "host_ms": sum(e["dur"] for e in host) / 1e3,
            "device_span_ms": sum(hi - lo for lo, hi in spans) / 1e3,
            "device_busy_ms": union_us([(e["ts"], e["ts"] + e["dur"]) for e in mine]) / 1e3,
            "launches": len(mine),
        }
    whole = {"wall_ms": wall_ms,
             "device_busy_ms": union_us([(e["ts"], e["ts"] + e["dur"]) for e in kernels]) / 1e3,
             "kernel_launches": len(kernels)}
    return per_stage, whole, prof, kernels


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
        out += [0, 0, 0] if A is None else [1, *A]
    return out


def affine_err(curve):
    """Error of two point tensors compared as affine points (K3 and K4 may
    sum in another order than their plain versions)."""
    return lambda ker, ref: int_err(affine_ints(curve, ker), affine_ints(curve, ref))


def coord_err(field):
    """Error of two point tensors compared coordinate by coordinate (K2 and
    K5 follow their plain versions' operation order exactly). Compares on
    the card and decodes only the coordinates that differ."""
    def err(ker, ref):
        bad = (ker != ref).any(-1).reshape(-1)
        if not bool(bad.any()):
            return 0
        return int_err(field.decode_plain(ker.reshape(-1, field.L)[bad]),
                       field.decode_plain(ref.reshape(-1, field.L)[bad]))
    return err


def hold(held: dict, key, kernel, plain, err_of, reps: int, prefix=None, graph=False,
         adds=None):
    """Hold one kernel call against its plain version on the same inputs;
    fail if they differ. Records held[key] = (max_abs_err, kernel ms, plain
    ms, (bound_ms, bound_by), graph ms or None), the bound being that of
    the launches the call made, and returns the kernel's output. The kernel
    ms is that of back-to-back wrapper calls; with `graph`, also that of the
    same launches replayed from a CUDA graph. With `prefix`, the plain
    version runs on the first `prefix` groups only (independent groups) and
    meets that prefix of the kernel's output. `adds` is the count of
    nonzero digits of a bucket accumulate call (roofline.bound)."""
    from bulletproofsplus_tpu_torch import roofline

    with roofline.recorded_launches() as calls:
        ker = kernel()
    ref, plain_ms = once_ms(plain)
    err = err_of(ker if prefix is None else ker[:prefix], ref)
    ms = cuda_ms(kernel, reps)
    g_ms = graph_ms(kernel, reps) if graph else None
    held[key] = (err, ms, plain_ms, roofline.bound(calls, adds), g_ms)
    what = " ".join(key)
    log(f"{what}: err {err}, kernel {ms:.4f} ms"
        f"{'' if g_ms is None else f' ({g_ms:.4f} ms from a graph)'}, plain {plain_ms:.1f} ms"
        f"{'' if prefix is None else f' (first {prefix} groups)'}, "
        f"bound {held[key][3][0]:.4f} ms")
    if err != 0:
        raise AssertionError(f"{what} disagrees with its plain version (err {err})")
    return ker


def random_scalars(count: int, gen, device):
    """count seeded plain-form scalars below 2^252 (< every group order)."""
    s = torch.randint(-2**31, 2**31, (count, 8), dtype=torch.int32,
                      generator=gen, device=device)
    s[:, 7] &= 0x0FFFFFFF
    return s


def random_points(curve, count: int, seed: int, device):
    """count distinct points (a + i·b)·B by host running sums."""
    hc = curve.host
    rnd = random.Random(seed)
    B = hc.lift(hc.base)
    step = hc.mul(B, rnd.randrange(1, 1 << 64))
    cur = hc.mul(B, rnd.randrange(1, 1 << 64))
    pts = []
    for _ in range(count):
        pts.append(cur)
        cur = hc.add(cur, step)
    return curve.encode_points(hc.to_affine(pts), device)


def bench_commitments(curve, pk, n: int, m: int, K: int | None = None):
    """The commitments (K, m, C, L) of bench.py's statements,
    v = 7k + 3i + 2 and γ = 2i + k + 3, by host running sums: V(k, i) =
    V(k, i − 1) + 3g + 2h and V(k, 0) = V(k − 1, 0) + 7g + h, one host add
    each and one shared inversion."""
    K = K or K_BATCH
    if 7 * (K - 1) + 3 * (m - 1) + 2 >= 1 << n:
        raise ValueError("bench values would wrap mod 2^n")
    hc = curve.host
    g, h = (hc.lift(A) for A in curve.decode_points(torch.stack([pk.g, pk.h])))
    step_i = hc.add(hc.mul(g, 3), hc.mul(h, 2))
    step_k = hc.add(hc.mul(g, 7), h)
    row = hc.add(hc.mul(g, 2), hc.mul(h, 3))
    pts = []
    for _ in range(K):
        cur = row
        for _ in range(m):
            pts.append(cur)
            cur = hc.add(cur, step_i)
        row = hc.add(row, step_k)
    V = curve.encode_points(hc.to_affine(pts), pk.device)
    return V.reshape(K, m, *V.shape[1:])


def bench_provers(V):
    """bench.py's RangeProvers over commitments V (K, m, C, L)."""
    from bulletproofsplus_tpu_torch import RangeProver

    m = V.shape[1]
    return [RangeProver(v_vec=[7 * k + 3 * i + 2 for i in range(m)],
                        gamma_vec=[2 * i + k + 3 for i in range(m)],
                        commitment_vec=list(V[k].unbind(0))) for k in range(V.shape[0])]


def carry_runs(p: int, words: int, count: int, rnd) -> list:
    """count values below p of `words` words whose sums, differences and
    products carry or borrow through long runs: p − 1, p − 2, 0, 1, then in
    turn words of all ones, all zeros or random under a top word below p's;
    values in [p/2, p); and p − 1 less a random number of up to all bits."""
    low = 32 * (words - 1)
    top = p >> low
    out = [p - 1, p - 2, 0, 1][:count]
    while len(out) < count:
        kind = len(out) % 3
        if kind == 0:
            ws = [rnd.choice((0, 0xFFFFFFFF, rnd.getrandbits(32))) for _ in range(words - 1)]
            v = sum(w << (32 * i) for i, w in enumerate(ws)) + (rnd.randrange(top) << low)
        elif kind == 1:
            v = rnd.randrange(p // 2, p)
        else:
            v = p - 1 - rnd.getrandbits(rnd.randrange(1, 32 * words))
        out.append(v % p)
    return out


def k2_shapes(n: int, m: int) -> list:
    """(J, groups) of K2's launches in a cell of K_BATCH proofs: the verify
    MSM's variable lanes, then round 0 of the prover: the folds (J = 2 over
    K·mn groups) and L and R (J = 4 over 2K rows of mn + 2 lanes padded to
    a multiple of 4)."""
    from bulletproofsplus_tpu_torch.msm.engine import joint_width

    mn = n * m
    lanes = K_BATCH * (3 + 2 * (mn.bit_length() - 1) + m) + 2
    J = joint_width(lanes)
    return [(J, -(-lanes // J)), (2, K_BATCH * mn), (4, 2 * K_BATCH * -(-(mn + 2) // 4))]


def field_operands(f, count: int, rnd, device):
    """count operands of f: p − 1, p − 2, then a third uniform, a third from
    [p/2, p) (sums past p, and past 2^256 for a modulus above 2^255) and a
    third from carry runs."""
    p = f.p
    third = (count - 2) // 3
    vals = ([p - 1, p - 2] + [rnd.randrange(p) for _ in range(third)]
            + [rnd.randrange(p // 2, p) for _ in range(third)]
            + carry_runs(p, f.L, count - 2 - 2 * third, rnd))
    return f.encode(vals, device)


def field_holds(held: dict, name: str, f, base, mn: int, gen, device) -> None:
    """Hold the field kernels around K1 against their plain versions at the
    path's shapes, at f's width, on values drawn at random from `base`
    (field_operands: carry runs, p − 1, values in [p/2, p))."""
    from bulletproofsplus_tpu_torch.fields import field_kernels as fk

    spec, K = f.spec, K_BATCH

    def draw(*shape):
        return base[torch.randint(0, base.shape[0], shape, generator=gen, device=device)]

    X, Y, z = draw(K, mn), draw(K, mn), draw(K, 1)
    row, vals = draw(K, mn // 2), draw(K)
    err, mod = coord_err(f), f"mod {spec.name}"
    hold(held, (name, "K1 add", f"({K}, {mn}) + ({K}, 1) {mod}"),
         lambda: fk.fe_add(X, z, spec), lambda: fk.fe_add_plain(X, z, spec), err, 20, graph=True)
    hold(held, (name, "K1 sub", f"({K}, {mn}) - ({K}, {mn}) {mod}"),
         lambda: fk.fe_sub(X, Y, spec), lambda: fk.fe_sub_plain(X, Y, spec), err, 20, graph=True)
    hold(held, (name, "K1 neg", f"({K}, {mn}) {mod}"),
         lambda: fk.fe_neg(X, spec), lambda: fk.fe_neg_plain(X, spec), err, 20, graph=True)
    hold(held, (name, "K1 sum", f"over K of ({K}, {mn}) {mod}"),
         lambda: fk.fe_sum(X, spec, 0), lambda: fk.fe_sum_plain(X, spec, 0), err, 20, graph=True)
    hold(held, (name, "K1 sum", f"over the row of ({K}, {mn // 2}) {mod}"),
         lambda: fk.fe_sum(row, spec, 1), lambda: fk.fe_sum_plain(row, spec, 1), err, 20,
         graph=True)
    hold(held, (name, "K1 pow", f"{K} values ^ (p - 2) {mod}"),
         lambda: fk.fe_pow(vals, f.p - 2, spec), lambda: fk.fe_pow_plain(vals, f.p - 2, spec),
         err, 20, graph=True)
    inv_holds(held, name, f, torch.cat([torch.zeros_like(vals[:1]), vals[1:]]),
              f"{K} values, one 0")


def inv_holds(held: dict, name: str, f, vals, what: str, pow_prefix: int = 4096) -> None:
    """Hold fe_inv against its plain version on `vals`, word for word, and
    that against fe_pow_plain(·, p − 2) on the first `pow_prefix` values
    (0 ↦ 0 in both)."""
    from bulletproofsplus_tpu_torch.fields import field_kernels as fk

    spec = f.spec
    ker = hold(held, (name, "K1 inv", f"{what} mod {spec.name}"),
               lambda: fk.fe_inv(vals, spec), lambda: fk.fe_inv_plain(vals, spec),
               coord_err(f), 20, graph=True)
    head = vals[:pow_prefix]
    if not torch.equal(ker[:pow_prefix], fk.fe_pow_plain(head, f.p - 2, spec)):
        raise AssertionError(f"{name} fe_inv {what} differs from fe_pow_plain(a, p - 2)")


def carry_run_scalars(count: int, gen, device):
    """count plain-form scalars whose words are all ones, all zeros or
    random (digits 15 and 0 in long runs)."""
    kind = torch.randint(0, 3, (count, 8), generator=gen, device=device)
    s = torch.randint(-2**31, 2**31, (count, 8), dtype=torch.int32, generator=gen, device=device)
    return torch.where(kind == 0, 0, torch.where(kind == 1, -1, s)).to(torch.int32)


def word_err(ker, ref) -> int:
    """Largest difference between two int32 tensors of uint32 words."""
    return int(((ker.long() & 0xFFFFFFFF) - (ref.long() & 0xFFFFFFFF)).abs().max())


def sha_holds(held: dict, name: str, curve, m: int, gen, device) -> None:
    """Hold the SHA-256 kernel against its plain version, bit for bit, at the
    message lengths of the K = 256 fs256 replay on this curve, and against
    hashlib on the first and last message of each."""
    from bulletproofsplus_tpu_torch import hashers_device as hd

    L = curve.fp.L
    for what, B, nw in (("statement absorb", K_BATCH, 9 + (m + 1) * 2 * L),
                        ("(L, R) absorb", K_BATCH, 9 + 4 * L),
                        ("challenge state", K_BATCH, 11),
                        ("challenge halves", 2 * K_BATCH, 9)):
        msgs = torch.randint(-2**31, 2**31, (B, nw), dtype=torch.int32, generator=gen,
                             device=device)
        nbytes = 4 * nw
        out = hold(held, (name, "SHA", f"{what}, {B} x {nbytes} bytes"),
                   lambda: hd.sha256_words(msgs, nbytes),
                   lambda: hd.sha256_words_plain(msgs, nbytes), word_err, 20, graph=True)
        for row in (0, B - 1):
            data = msgs[row].cpu().numpy().view("uint32").astype(">u4").tobytes()
            got = out[row].cpu().numpy().view("uint32").astype(">u4").tobytes()
            if got != hashlib.sha256(data).digest():
                raise AssertionError(f"SHA {what} row {row} differs from hashlib")


def chain_holds(held: dict, name: str, curve, n: int, m: int, gen, device) -> None:
    """Hold the fs256 chain kernel against its plain version, bit for bit,
    at the K = 256 verifier's schedule (the whole replay: the statement,
    every round, the final challenge) and at the prover's last round step
    (counters past 0), on seeded coordinate words and states; timed through
    its wrapper and from a CUDA graph."""
    from bulletproofsplus_tpu_torch import hashers_device as hd
    from bulletproofsplus_tpu_torch import roofline
    from bulletproofsplus_tpu_torch.protocol import fs256

    fn, W = curve.fn, 2 * curve.fp.L
    logn = (n * m).bit_length() - 1
    rows = m + 3 + 2 * logn

    def words(*shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32, generator=gen,
                             device=device)

    cw, state = words(K_BATCH, rows, W), words(K_BATCH, 8)
    base = torch.randint(0, 1 << 20, (K_BATCH,), dtype=torch.int32, generator=gen,
                         device=device)
    for what, b, sched, x in (("replay", None, fs256.replay_schedule(m, logn), cw),
                              ("prover round", base, (fs256.round_step(logn - 1),),
                               cw[:, :2].contiguous())):
        steps = roofline.chain_steps(hd.schedule_words(sched), len(sched))
        path, _ = roofline.chain_compressions(steps, W)
        hold(held, (name, "chain", f"{what}, {K_BATCH} transcripts, {path} compressions "
                                   f"on a transcript's path"),
             lambda: hd.fs256_chain(fn, state, b, x, sched),
             lambda: hd.fs256_chain_plain(fn, state, b, x, sched),
             lambda ker, ref: max(word_err(p, q) for p, q in zip(ker, ref)), 20, graph=True)


def fs256_phase(name: str, curve, pk, n: int, m: int, bench, V_bench, det_batch,
                counted, wrng, held):
    """Phase 11's proofs: fs256 batch prove and verify of the bench
    statements beside the deterministic verify, the card's replay against
    the host twin, an m = 1 prove and verify; returns (lines, launches,
    stages)."""
    from bulletproofsplus_tpu_torch import (
        DeterministicRng,
        DeterministicTranscript,
        Fs256Transcript,
        RangeProver,
        VerificationError,
        batch_prove,
        batch_verify,
        prove,
        verify,
    )
    from bulletproofsplus_tpu_torch.protocol.fs256 import fs256_replay
    from bulletproofsplus_tpu_torch.protocol.range import replay_batch

    fn, dev = curve.fn, pk.device
    logn = (n * m).bit_length() - 1
    provers_trs = []

    def run_prove():
        provers_trs[:] = [Fs256Transcript(m) for _ in range(K_BATCH)]
        return batch_prove(curve, pk, n, bench, provers_trs, [DeterministicRng(m)] * K_BATCH)

    proven, prove_first_ms, prove_launches = counted(
        run_prove, (*PATH_FIELD_KERNELS, "K2", "K3", "K5", "chain"))
    log(f"fs256 batch_prove K={K_BATCH} ({prove_first_ms:.1f} ms); launches {prove_launches}; "
        f"fe_inv {prove_launches['K1 inv']}, fe_pow {prove_launches['K1 pow']}")

    # the card's replay of the whole batch against the host twin on a sample
    sample = sorted({0, 1, K_BATCH // 2, K_BATCH - 1})[:FS256_SAMPLE]
    card = fs256_replay(curve, m, V_bench, proven.A, proven.L_vec, proven.R_vec,
                        proven.A_wip, proven.B)
    # fe_inv on the Z column the replay inverts (fs256.affine_words), and the
    # identity's Z (0 on a Weierstrass curve)
    LR = torch.stack([proven.L_vec, proven.R_vec], dim=2).reshape(K_BATCH, -1, *proven.A.shape[1:])
    pts = torch.cat([V_bench, proven.A[:, None], LR, proven.A_wip[:, None], proven.B[:, None]],
                    dim=1)
    zcol = torch.cat([curve.identity(dev)[None, 2], pts[..., 2, :].reshape(-1, curve.fp.L)])
    inv_holds(held, name, curve.fp, zcol.contiguous(),
              f"the K = {K_BATCH} replay's Z column and the identity's, {zcol.shape[0]} values")
    del LR, pts, zcol
    twins = [Fs256Transcript(m) for _ in sample]
    ys, zs, ess, efs = replay_batch(curve, n, m, twins, proven.take(sample), V_bench[sample])
    want = (ys, zs, [e for es in ess for e in es], efs)
    if tuple(fn.decode(t[sample]) for t in card) != want:
        raise AssertionError("the card's fs256 replay differs from the host twin's")
    for k, t in zip(sample, twins):
        mine = provers_trs[k]
        if (mine.state_words().tolist() != t.state_words().tolist()
                or not mine._counter == t._counter == logn + 3):
            raise AssertionError(f"prover transcript {k} does not end in the host twin's state")
    log(f"fs256 replay on the card equals the host twin on proofs {sample}; "
        "the prover's transcripts end in the twin's state")

    def run_verify(b=proven):
        batch_verify(curve, pk, n, b, V_bench, rng=lambda: wrng.getrandbits(128))

    det_trs = [DeterministicTranscript(m)] * K_BATCH

    def run_det_verify():
        batch_verify(curve, pk, n, det_batch, V_bench, det_trs,
                     rng=lambda: wrng.getrandbits(128))

    _, verify_first_ms, verify_launches = counted(
        run_verify, (*PATH_FIELD_KERNELS, "K2", "K3", "K4", "chain"))
    log(f"fs256 batch_verify K={K_BATCH} accepted ({verify_first_ms:.1f} ms); "
        f"launches {verify_launches}; fe_inv {verify_launches['K1 inv']}, "
        f"fe_pow {verify_launches['K1 pow']}")
    verify_warm, det_warm = [], []
    for turn in range(3):      # in turns: deterministic, fs256, fs256, deterministic, ...
        order = ((det_warm, run_det_verify), (verify_warm, run_verify))
        for out, run in (order if turn % 2 == 0 else order[::-1]):
            out.append(once_ms(run)[1])
    log(f"warm batch_verify of the bench batch: fs256 {[round(x, 2) for x in verify_warm]} ms, "
        f"deterministic {[round(x, 2) for x in det_warm]} ms")
    bad = proven.take(slice(None))
    bad.r_prime = bad.r_prime.clone()
    bad.r_prime[K_BATCH - 1] = fn.add(bad.r_prime[K_BATCH - 1], fn.one(dev))
    try:
        run_verify(bad)
    except VerificationError:
        log("tampered fs256 batch rejected")
    else:
        raise AssertionError("tampered fs256 batch was accepted")
    prove_warm = [once_ms(run_prove)[1] for _ in range(3)]
    log(f"warm fs256 batch_prove: {[round(x, 1) for x in prove_warm]} ms")
    stages = {"fs256_verify": stage_profile(run_verify, FS256_VERIFY_STAGES)[:2],
              "fs256_prove": stage_profile(run_prove, FS256_PROVE_STAGES)[:2]}
    log(f"fs256 stages: {stages}")

    one = RangeProver()
    V1 = one.commit(pk, 0xC0FFEE1234567 % (1 << n), 1234567)
    proof1, prove1_ms = once_ms(lambda: prove(curve, pk, n, one))
    _, verify1_ms = once_ms(lambda: verify(curve, proof1, pk, n, V1[None]))
    log(f"m=1 fs256 prove ({prove1_ms:.1f} ms) and verify ({verify1_ms:.1f} ms) accepted")

    lines = [{"fs256_batch_verify": {"curve": name, "K": K_BATCH, "n": n, "m": m,
                                     "first_ms": verify_first_ms, "warm_ms": verify_warm,
                                     "deterministic_warm_ms": det_warm,
                                     "verify_per_s": K_BATCH / min(verify_warm) * 1e3,
                                     "single_m1_ms": verify1_ms}},
             {"fs256_batch_prove": {"curve": name, "K": K_BATCH, "n": n, "m": m,
                                    "first_ms": prove_first_ms, "warm_ms": prove_warm,
                                    "proofs_per_s": K_BATCH / min(prove_warm) * 1e3,
                                    "launches": prove_launches, "single_m1_ms": prove1_ms}}]
    return lines, {"fs256_batch_verify": verify_launches,
                   "fs256_batch_prove": prove_launches}, stages


def parity_batch(kind: str, device):
    """PARITY_K small statements (values 7k + 3i + 2, blinds 2i + k + 3) over
    the hash-derived key on `device`, proven in one batch with fresh
    `kind` transcripts and DeterministicRng: their wire bytes."""
    from bulletproofsplus_tpu_torch import (
        DeterministicRng,
        PublicKey,
        RangeProver,
        ShaTranscript,
        batch_prove,
        curve_ops,
        serialize,
    )
    from bulletproofsplus_tpu_torch.merlin import MerlinBppTranscript

    curve = curve_ops(FACADE_CURVE)
    n, m, K = PARITY_N, PARITY_M, PARITY_K
    pk = PublicKey.new_secure(curve, n * m, device=device)
    provers = []
    for k in range(K):
        pr = RangeProver()
        for i in range(m):
            pr.commit(pk, 7 * k + 3 * i + 2, 2 * i + k + 3)
        provers.append(pr)
    make = ShaTranscript if kind == "sha" else MerlinBppTranscript
    batch = batch_prove(curve, pk, n, provers, [make(m) for _ in range(K)],
                        [DeterministicRng(m)] * K)
    return [serialize.proof_to_bytes(curve, batch[k]).hex() for k in range(K)]


def cpu_proofs(out: str) -> int:
    """The helper process: the sha and merlin parity batches on the CPU
    (the plain path the CPU tests hold against golden), written to `out`."""
    torch.set_num_threads(2)
    t = time.time()
    got = {kind: parity_batch(kind, "cpu") for kind in ("sha", "merlin")}
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out + ".tmp", "w") as f:
        json.dump({"proofs": got, "seconds": time.time() - t}, f)
    os.replace(out + ".tmp", out)
    return 0


def facade_phase(counted, helper) -> tuple:
    """Phase 12: the facade in its four modes on the card, then the sha and
    merlin parity batches against the CPU helper's; returns (line,
    launches by path)."""
    from bulletproofsplus_tpu_torch import (
        Config,
        RangeProofSystem,
        VerificationError,
        stack_commitments,
    )

    dev = torch.device(DEVICE)
    n, m = FACADE_N, FACADE_M
    logn = (n * m).bit_length() - 1
    out, launches = {"curve": FACADE_CURVE, "n": n, "m": m}, {}
    for mode in ("deterministic", "fs256", "sha", "merlin"):
        K = FACADE_K[mode]
        t = time.time()
        system = RangeProofSystem(Config(curve=FACADE_CURVE, n=n, m=m, mode=mode), device=dev)
        torch.cuda.synchronize()
        setup_s = time.time() - t
        t = time.time()
        sts = [system.statement([7 * k + 3 * i + 2 for i in range(m)],
                                gammas=[2 * i + k + 3 for i in range(m)]) for k in range(K)]
        V = stack_commitments(system.curve, [s.commitments for s in sts])
        commit_s = time.time() - t
        proof, prove_ms = once_ms(lambda: system.prove(sts[0]))
        _, verify_ms = once_ms(lambda: system.verify(proof, sts[0].commitments))
        system.verify(system.proof_from_bytes(system.proof_to_bytes(proof)), sts[0].commitments)
        chain = ("chain",) if mode == "fs256" else ()
        batch, bp_ms, bp_launches = counted(lambda: system.batch_prove(sts),
                                            (*PATH_FIELD_KERNELS, "K2", "K3", "K5", *chain))
        _, bv_ms, bv_launches = counted(lambda: system.batch_verify(batch, V),
                                        (*PATH_FIELD_KERNELS, "K2", "K3", "K4", *chain))
        warm_prove = [once_ms(lambda: system.batch_prove(sts))[1] for _ in range(2)]
        warm_verify = [once_ms(lambda: system.batch_verify(batch, V))[1] for _ in range(2)]
        bad = batch.take(slice(None))
        bad.s_prime = bad.s_prime.clone()
        hit = K // 3
        bad.s_prime[hit] = system.curve.fn.add(bad.s_prime[hit], system.curve.fn.one(dev))
        try:
            system.batch_verify(bad, V)
        except VerificationError:
            pass
        else:
            raise AssertionError(f"facade {mode}: a tampered batch was accepted")
        named, identify_ms = once_ms(lambda: system.batch_verify_identify(bad, V))
        if named != [hit]:
            raise AssertionError(f"facade {mode}: batch_verify_identify named {named}, "
                                 f"not [{hit}]")
        row = {"K": K, "setup_s": setup_s, "commit_s": commit_s, "prove_ms": prove_ms,
               "verify_ms": verify_ms, "batch_prove_first_ms": bp_ms,
               "batch_prove_warm_ms": warm_prove, "batch_verify_first_ms": bv_ms,
               "batch_verify_warm_ms": warm_verify, "identify_ms": identify_ms,
               "proofs_per_s": K / min(warm_prove) * 1e3,
               "verify_per_s": K / min(warm_verify) * 1e3}
        if mode in ("sha", "merlin"):
            stages, whole = stage_profile(lambda: system.batch_prove(sts),
                                          INTERACTIVE_PROVE_STAGES)[:2]
            # a round trip a round and one for the final challenge
            trips = logn + 1
            row["host_ms_per_round"] = {k[len("bpp::"):]: stages[k]["host_ms"] / trips
                                        for k in HOST_ROUND_STAGES}
            row["host_statement_ms"] = stages["bpp::host_statement"]["host_ms"]
            row["profiled_prove"] = whole
        launches[f"facade_{mode}_batch_prove"] = bp_launches
        launches[f"facade_{mode}_batch_verify"] = bv_launches
        out[mode] = row
        log(f"facade {mode}: K={K} batch_prove {bp_ms:.1f} ms (warm {warm_prove}), "
            f"batch_verify {bv_ms:.1f} ms (warm {warm_verify}), identify named {named} in "
            f"{identify_ms:.1f} ms; prove {prove_ms:.1f} ms, verify {verify_ms:.1f} ms"
            + (f"; host ms a round {row['host_ms_per_round']}" if "host_ms_per_round" in row
               else ""))
        del system, sts, V, batch, bad

    card = {kind: parity_batch(kind, dev) for kind in ("sha", "merlin")}
    t = time.time()
    rc = helper.wait(timeout=900)
    if rc != 0:
        raise AssertionError(f"the CPU proof helper exited with {rc}")
    with open(CPU_PROOFS) as f:
        cpu = json.load(f)
    for kind in card:
        if card[kind] != cpu["proofs"][kind]:
            raise AssertionError(f"{kind} proofs made on the card differ from the CPU's")
    log(f"sha and merlin K={PARITY_K} proofs (n={PARITY_N}, m={PARITY_M}) equal the CPU "
        f"path's byte for byte (helper took {cpu['seconds']:.1f} s, waited "
        f"{time.time() - t:.1f} s)")
    out["parity"] = {"K": PARITY_K, "n": PARITY_N, "m": PARITY_M, "equal": True,
                     "cpu_s": cpu["seconds"]}
    return {"facade": out}, launches


def mesh_devices(count: int) -> list:
    """count mesh devices: distinct cards where the machine has that many,
    else the first card listed count times."""
    if count > 1 and torch.cuda.device_count() >= count:
        return [torch.device("cuda", i) for i in range(count)]
    return [torch.device(DEVICE)] * count


def shard_launches(run, wrappers):
    """(run's result, one (device, {kernel: launches}) per shard inside it):
    each call of parallel.sharded_msm.shard_partial, the one function every
    sharded MSM runs a shard through, with the launches made inside it."""
    import importlib

    mods = [importlib.import_module(f"bulletproofsplus_tpu_torch.{name}")
            for name in ("parallel.sharded_msm", "protocol.batch")]
    inner = mods[0].shard_partial
    shards = []

    def counting(curve, device, *args, **kw):
        before = {k: w.launches for k, w in wrappers.items()}
        part = inner(curve, device, *args, **kw)
        shards.append((str(device), {k: w.launches - before[k] for k, w in wrappers.items()
                                     if w.launches != before[k]}))
        return part

    for mod in mods:
        mod.shard_partial = counting
    try:
        return run(), shards
    finally:
        for mod in mods:
            mod.shard_partial = inner


def kernel_ms(run) -> dict:
    """Device ms of each K2, K3 and K4 launch of one profiled run of `run`,
    in launch order."""
    kernels = stage_profile(run, ())[3]
    return {k: [e["dur"] / 1e3 for e in kernels if name in e["name"]]
            for k, name in DEVICE_KERNELS.items()}


def distribution_phase(counted, wrappers, held, bls) -> tuple:
    """Phase 13: batch verification of BASELINE config 5 (edwards25519,
    n = 64, m = 16, K = 1,024) over 1 x 1, 1 x 4 and 2 x 2 meshes in
    deterministic and fs256 mode beside the unsharded verify; the sharded
    prover against prove; bls12-381's phase-9 batch over 1 x 4 with sliced
    tables; the serving demo; two worker processes whose verdicts meet over
    torch.distributed. Returns (line, launches by curve and path)."""
    from bulletproofsplus_tpu_torch import (
        DeterministicRng,
        DeterministicTranscript,
        Fs256Transcript,
        PublicKey,
        SystemRng,
        VerificationError,
        batch_prove,
        batch_verify,
        batch_verify_identify,
        curve_ops,
        prove,
        serialize,
        serve_batch,
        verify,
    )
    from bulletproofsplus_tpu_torch.curves import cuda_curve as cc
    from bulletproofsplus_tpu_torch.msm.engine import joint_width
    from bulletproofsplus_tpu_torch.parallel import default_mesh, sharded_prove

    class SeededRng(SystemRng):
        """SystemRng's blinds drawn from random.Random(seed): two proves
        with one seed draw the same blinds."""

        def __init__(self, order, seed):
            super().__init__(order)
            self._rnd = random.Random(seed)

        def _r(self):
            return self._rnd.randrange(1, self.order)

    t_phase = time.time()
    dev = torch.device(DEVICE)
    curve = curve_ops(DIST_CURVE)
    fn, fp = curve.fn, curve.fp
    C, L, S = curve.COORDS, fp.L, fn.L
    nbits = fn.order_bits
    n, m, K = DIST_N, DIST_M, DIST_K
    mn = n * m
    meshes = {name: default_mesh(cnt, dp=dp, devices=mesh_devices(cnt))
              for name, (cnt, dp) in DIST_MESHES.items()}
    distinct = max(mesh.distinct_devices() for mesh in meshes.values())
    for name, mesh in meshes.items():
        log(f"mesh {name}: {mesh}")
    log(f"distribution: meshes over {distinct} distinct card(s); the machine has "
        f"{torch.cuda.device_count()}")
    out = {"curve": DIST_CURVE, "n": n, "m": m, "K": K, "cards": torch.cuda.device_count(),
           "distinct_cards": distinct, "meshes": {k: repr(v) for k, v in meshes.items()}}
    launches = {DIST_CURVE: {}, DIST_BLS: {}}

    # -- (a) BASELINE config 5 over each mesh, deterministic and fs256 ---------
    t = time.time()
    pk = PublicKey.new(curve, mn, dev)
    V = bench_commitments(curve, pk, n, m, K)
    provers = bench_provers(V)
    log(f"config 5: committed {K * m} bench witnesses in {time.time() - t:.1f} s")
    hit = 3 * K // 4                    # a proof of the 2 x 2 mesh's row 1
    wrng = random.Random(13)
    for mode in ("deterministic", "fs256"):
        det = mode == "deterministic"
        make = DeterministicTranscript if det else Fs256Transcript
        chain = () if det else ("chain",)
        batch, prove_ms = once_ms(lambda: batch_prove(
            curve, pk, n, provers, [make(m) for _ in range(K)], [DeterministicRng(m)] * K))
        bad = batch.take(slice(None))
        bad.s_prime = bad.s_prime.clone()
        bad.s_prime[hit] = fn.add(bad.s_prime[hit], fn.one(dev))

        def run(b, mesh):
            batch_verify(curve, pk, n, b, V, [make(m) for _ in range(K)],
                         rng=lambda: wrng.getrandbits(128), mesh=mesh)

        row = {"batch_prove_ms": prove_ms}
        _, row["unsharded_first_ms"], launches[DIST_CURVE][f"dist_{mode}_verify_unsharded"] = (
            counted(lambda: run(batch, None), (*PATH_FIELD_KERNELS, "K2", "K3", "K4", *chain)))
        for name, mesh in meshes.items():
            per = ("K2", "K3", "K4") if mesh.shape["dp"] == 1 else ("K2", "K3")
            (_, shards), first_ms, counts = counted(
                lambda: shard_launches(lambda: run(batch, mesh), wrappers),
                (*PATH_FIELD_KERNELS, *per, *chain))
            if (len(shards) != mesh.shape["dp"] * mesh.shape["tp"]
                    or not all(c.get(k) for _, c in shards for k in per)):
                raise AssertionError(f"{mode} {name}: not every shard launched {per}: {shards}")
            launches[DIST_CURVE][f"dist_{mode}_verify_{name}"] = counts
            try:
                run(bad, mesh)
            except VerificationError:
                pass
            else:
                raise AssertionError(f"{mode} {name}: a tampered batch was accepted")
            row[name] = {"first_ms": first_ms, "shards": shards}
            log(f"config 5 {mode} {name}: accepted ({first_ms:.1f} ms), tampered proof {hit} "
                f"rejected; shards {shards}")
        turns = {"unsharded": [], **{name: [] for name in meshes}}
        for _ in range(DIST_TURNS):
            for key in turns:
                turns[key].append(once_ms(lambda: run(batch, meshes.get(key)))[1])
        row["warm_ms"] = turns
        named, ms = once_ms(lambda: batch_verify_identify(
            curve, pk, n, bad, V, transcript_factory=lambda i: make(m),
            rng=lambda: wrng.getrandbits(128), mesh=meshes["1x4"]))
        if named != [hit]:
            raise AssertionError(f"{mode}: identify over 1x4 named {named}, not [{hit}]")
        row["identify_1x4"] = {"named": named, "ms": ms}
        if det:
            row["kernel_ms"] = {key: kernel_ms(lambda: run(batch, meshes.get(key)))
                                for key in turns}
        log(f"config 5 {mode}: warm ms {turns}; identify over 1x4 named {named} in "
            f"{ms:.1f} ms")
        out[mode] = row
        del batch, bad

    # the shards' new shapes against the plain versions: K4 on a 1 x 4
    # shard's table slice, the gather's K3, K2 on a 2 x 2 row's shard
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    rnd = random.Random(31)
    tables = pk.fixed_tables(mn, meshes["1x4"].devices[0])
    gen_s = fn.encode_plain([rnd.randrange(fn.p) for _ in range(2 * mn // 4)], dev)
    dig = cc.fixed_digits(curve, gen_s, nbits, signed=False)
    hold(held, (DIST_CURVE, "K4", f"{dig.numel()} lanes (a 1x4 shard's table slice)"),
         lambda: cc.fixed_lookup_partials(curve, tables[0], dig, False),
         lambda: cc.fixed_lookup_plain(curve, tables[0], dig, False),
         lambda ker, ref: affine_err(curve)(cc.sum_points_plain(curve, ker[None]), ref),
         20, graph=True)
    four = random_points(curve, 4, 32, dev)[None]
    hold(held, (DIST_CURVE, "K3", "1 x 4 points (the gather of 4 shards)"),
         lambda: cc.sum_points_grouped(curve, four), lambda: cc.sum_points_plain(curve, four),
         affine_err(curve), 20, graph=True)
    lanes = -(-((K // 2) * (3 + 2 * (mn.bit_length() - 1) + m) + 2 + 2 * mn) // 2)
    J = joint_width(lanes)
    G2 = -(-lanes // J)
    pts = random_points(curve, G2 * J, 33, dev)
    scal = random_scalars(G2 * J, gen, dev)
    hold(held, (DIST_CURVE, "K2", f"J={J}, {G2} groups (a 2x2 shard of K={K})"),
         lambda: cc.joint_ladder_msm_grouped(curve, scal, pts, nbits, J),
         lambda: cc.joint_ladder_plain(curve, scal[:DIST_PREFIX * J].reshape(DIST_PREFIX, J, S),
                                       pts[:DIST_PREFIX * J].reshape(DIST_PREFIX, J, C, L),
                                       nbits),
         coord_err(fp), 3, prefix=DIST_PREFIX)
    del tables, pts, scal

    # -- (b) the sharded prover over 1 x 4 -----------------------------------
    mesh = meshes["1x4"]
    pr = provers[0]
    ref = prove(curve, pk, n, pr, DeterministicTranscript(m), DeterministicRng(m))
    got, sp_ms, counts = counted(
        lambda: sharded_prove(curve, pk, n, pr, mesh, DeterministicTranscript(m),
                              DeterministicRng(m)), (*PATH_FIELD_KERNELS, "K2", "K3", "K5"))
    one = sharded_prove(curve, pk, n, pr, meshes["1x1"], DeterministicTranscript(m),
                        DeterministicRng(m))
    want = serialize.proof_to_bytes(curve, ref)
    if serialize.proof_to_bytes(curve, got) != want or serialize.proof_to_bytes(curve, one) != want:
        raise AssertionError("sharded_prove's bytes differ from prove's (deterministic)")
    launches[DIST_CURVE]["dist_sharded_prove_deterministic"] = counts
    sp_warm = [once_ms(lambda: sharded_prove(curve, pk, n, pr, mesh, DeterministicTranscript(m),
                                             DeterministicRng(m)))[1] for _ in range(2)]
    p_warm = [once_ms(lambda: prove(curve, pk, n, pr, DeterministicTranscript(m),
                                    DeterministicRng(m)))[1] for _ in range(2)]
    t_ref, t_got = Fs256Transcript(m), Fs256Transcript(m)
    ref = prove(curve, pk, n, pr, t_ref, SeededRng(fn.p, 7))
    got, fs_ms, counts = counted(
        lambda: sharded_prove(curve, pk, n, pr, mesh, t_got, SeededRng(fn.p, 7)),
        (*PATH_FIELD_KERNELS, "K2", "K3", "K5", "chain"))
    if serialize.proof_to_bytes(curve, got) != serialize.proof_to_bytes(curve, ref):
        raise AssertionError("sharded_prove's bytes differ from prove's (fs256)")
    if not (t_ref.state_words() == t_got.state_words()).all() or t_ref._counter != t_got._counter:
        raise AssertionError("sharded_prove's fs256 transcript ends in another state")
    verify(curve, got, pk, n, pr.commitment_vec)
    launches[DIST_CURVE]["dist_sharded_prove_fs256"] = counts
    out["sharded_prove_1x4"] = {"deterministic_first_ms": sp_ms, "deterministic_warm_ms": sp_warm,
                                "prove_warm_ms": p_warm, "fs256_first_ms": fs_ms,
                                "bytes_equal": True}
    log(f"sharded_prove over 1x4: bytes equal prove's in both modes; warm {sp_warm} ms "
        f"(prove {p_warm} ms); over 1x1 too; the fs256 proof verifies")
    del pk, V, provers, ref, got

    # -- (c) bls12-381, n = 64, m = 256, K = 256 over 1 x 4 ----------------------
    bpk, bn, bbatch, bV = bls
    bcurve = curve_ops(DIST_BLS)
    bK, bm = bV.shape[:2]
    mesh = default_mesh(4, devices=mesh_devices(4))
    btables, table_ms = once_ms(lambda: bpk.fixed_tables(bn * bm, mesh.devices[0]))
    shard_bytes = [tb.numel() * 4 for tb in btables]
    log(f"bls12-381 over 1x4: shard tables {[tb.shape for tb in btables]}, "
        f"{[round(b / 1e9, 3) for b in shard_bytes]} GB each, built in {table_ms:.0f} ms")
    del btables

    def brun(b, mesh_):
        batch_verify(bcurve, bpk, bn, b, bV, [DeterministicTranscript(bm)] * bK,
                     rng=lambda: wrng.getrandbits(128), mesh=mesh_)

    (_, shards), first_ms, counts = counted(
        lambda: shard_launches(lambda: brun(bbatch, mesh), wrappers),
        (*PATH_FIELD_KERNELS, "K2", "K3", "K4"))
    if len(shards) != 4 or not all(c.get(k) for _, c in shards for k in ("K2", "K3", "K4")):
        raise AssertionError(f"bls12-381 1x4: not every shard launched K2, K3, K4: {shards}")
    launches[DIST_BLS]["dist_deterministic_verify_1x4"] = counts
    bad = bbatch.take(slice(None))
    bad.r_prime = bad.r_prime.clone()
    bad.r_prime[bK // 2] = bcurve.fn.add(bad.r_prime[bK // 2], bcurve.fn.one(dev))
    try:
        brun(bad, mesh)
    except VerificationError:
        pass
    else:
        raise AssertionError("bls12-381 1x4: a tampered batch was accepted")
    bturns = {"unsharded": [], "1x4": []}
    for _ in range(DIST_TURNS):
        bturns["unsharded"].append(once_ms(lambda: brun(bbatch, None))[1])
        bturns["1x4"].append(once_ms(lambda: brun(bbatch, mesh))[1])
    out["bls12_381_1x4"] = {"K": bK, "n": bn, "m": bm, "shard_table_bytes": shard_bytes,
                            "table_build_ms": table_ms, "first_ms": first_ms,
                            "warm_ms": bturns, "shards": shards,
                            "kernel_ms": kernel_ms(lambda: brun(bbatch, mesh))}
    log(f"bls12-381 over 1x4: accepted, tampered rejected; warm ms {bturns}")
    del bad

    # -- the serving demo over a 2 x 2 mesh ------------------------------------
    t = time.time()
    devices = ",".join(str(d) for d in mesh_devices(4))
    with contextlib.redirect_stdout(sys.stderr):
        serve_batch.main(["--k", str(SERVE_K), "--n", str(n), "--m", str(m), "--mesh-dp", "2",
                          "--devices", devices])
    out["serve_batch"] = {"K": SERVE_K, "mesh_dp": 2, "devices": devices,
                          "seconds": time.time() - t}

    # -- (d) two processes, one dp row each, verdicts over torch.distributed ----
    if os.path.exists(RENDEZVOUS):
        os.remove(RENDEZVOUS)
    local = (["--local-devices", "2"] if torch.cuda.device_count() >= 4
             else ["--devices", f"{DEVICE},{DEVICE}"])
    cmd = [sys.executable, "-m", "bulletproofsplus_tpu_torch.parallel.worker",
           "--init-method", f"file://{RENDEZVOUS}", "--world-size", "2", *local,
           "--n", str(WORKER_N), "--m", str(WORKER_M),
           "--K", str(WORKER_K)]
    t = time.time()
    procs = [subprocess.Popen([*cmd, "--rank", str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, cwd=ROOT)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=WORKER_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    worker = {"seconds": time.time() - t, "n": WORKER_N, "m": WORKER_M, "K": WORKER_K}
    for r, (p, text) in enumerate(zip(procs, outs)):
        for line in text.splitlines():
            log(f"worker {r}: {line}")
        if (p.returncode != 0 or f"MULTIHOST OK proc={r}" not in text
                or "accept: ok" not in text or "reject: ok" not in text):
            raise AssertionError(f"worker {r} failed (exit {p.returncode})")
        worker[f"proc{r}"] = {
            key: float(re.search(rf"{key}: ok \(([0-9.]+) ms\)", text).group(1))
            for key in ("accept", "reject")}
        worker["backend"] = re.search(r"backend (\w+)", text).group(1)
    out["two_processes"] = worker
    log(f"two processes (backend {worker['backend']}): both accepted and rejected in "
        f"{worker['seconds']:.1f} s")
    log(f"phase 13 took {time.time() - t_phase:.1f} s")
    return {"distribution": out}, launches


@contextlib.contextmanager
def environ(values: dict):
    """The environment with `values` set (None unsets), restored after."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def device_kernels(kernels) -> dict:
    """{kernel: (launches, device ms)} of a profiled run's kernel events,
    by PROVE_KERNELS' names."""
    out = {}
    for k, pat in PROVE_KERNELS.items():
        mine = [e["dur"] for e in kernels if re.search(pat, e["name"])]
        if mine:
            out[k] = (len(mine), sum(mine) / 1e3)
    return out


def coeff_rows(curve, pk, n: int, rnd):
    """One proof's L/R row set of the coefficient prover at n pairs: its
    (2·log2 n, n + 2) points from the key's generators by the rounds' bit
    patterns, and seeded scalars of the group order's width with a zero
    among them."""
    from bulletproofsplus_tpu_torch.protocol.wip_coeff import _patterns

    G, H = pk.G_vec[:n], pk.H_vec[:n]
    gh = torch.stack([pk.g, pk.h])
    pts = []
    for _, idx_hi, idx_lo, _, _ in _patterns(n, str(G.device)):
        pts += [torch.cat([G[idx_hi], H[idx_lo], gh]), torch.cat([G[idx_lo], H[idx_hi], gh])]
    P = torch.stack(pts)
    S = curve.fn.encode_plain([rnd.randrange(curve.fn.p) for _ in range(P.shape[0] * (n + 2))],
                              G.device).reshape(P.shape[0], n + 2, curve.fn.L)
    S[0, 5] = 0
    return S, P


def bucket_holds(held: dict, name: str, curve, S, P, what: str, nbits: int,
                 segments=(None,)) -> None:
    """Hold the three bucket kernels (accumulate, merge, reduce) against their
    plain versions on scalars S (R, N, S) and points P (prow, N, C, L), at
    the layout bucket_msm takes there, word for word (the plain versions add
    in the kernels' order); the reduce at each of `segments` (None: the
    wrapper's own count for the card); then the whole bucket MSM against
    the plain stages as affine points."""
    from bulletproofsplus_tpu_torch import kernels, roofline
    from bulletproofsplus_tpu_torch.curves import cuda_curve as cc
    from bulletproofsplus_tpu_torch.msm.pippenger import window

    c = window()
    R, N = S.shape[:2]
    nwin = -(-nbits // c)
    resident = cc.BUCKET_THREADS * kernels.resident_blocks(
        "bpp_pippenger_accumulate", curve.FAMILY, S.device)
    slices, _ = cc.bucket_layout(R, N, nwin, c, curve.COORDS * curve.fp.L * 4, resident,
                                 P.shape[0])
    adds = roofline.bucket_adds(curve.fn.scalar_digits(S, nwin * c, c))
    shape = f"{what}, {slices} slices, c = {c}"
    bk = hold(held, (name, "Pip acc", f"{R} x {N} pairs ({shape})"),
              lambda: cc.bucket_accumulate(curve, S, P, nwin, c, slices),
              lambda: cc.bucket_accumulate_plain(curve, S, P, nwin, c, slices),
              coord_err(curve.fp), 5, graph=True, adds=adds)
    if slices > 1:
        merged = hold(held, (name, "Pip merge", f"{R} x {nwin} x {1 << c} buckets ({shape})"),
                      lambda: cc.bucket_merge(curve, bk),
                      lambda: cc.bucket_merge_plain(curve, bk), coord_err(curve.fp), 5,
                      graph=True)
    else:
        merged = bk[:, 0]
    own = cc.reduce_segments(R, nwin, c, cc.BUCKET_THREADS * kernels.resident_blocks(
        "bpp_pippenger_reduce", curve.FAMILY, S.device))
    for seg in segments:
        seg = own if seg is None else seg
        per = f"{seg} segments" if seg else "a thread a window"
        hold(held, (name, "Pip reduce", f"{R} x {nwin} windows, {per} ({shape})"),
             lambda: cc.bucket_reduce(curve, merged, c, seg),
             lambda: cc.bucket_reduce_plain(curve, merged, c, seg), coord_err(curve.fp), 5,
             graph=True)
    got = cc.bucket_msm(curve, S, P, nbits, c)
    err = affine_err(curve)(got, cc.bucket_reduce_plain(curve, merged, c, own))
    if err:
        raise AssertionError(f"{name} bucket MSM ({what}) disagrees with its plain stages")
    del bk, merged


def coeff_phase(counted, held, kept) -> tuple:
    """Phase 14: the coefficient-form prover. The headline batch
    (edwards25519, n = 64, m = 16, K = 256, bench.py's statements) proven by
    the fold, by BPP_PROVER=coeff on the ladder and with the bucket MSM
    (BPP_PIPPENGER=1): bytes equal, each batch verifies and a tampered copy
    rejects, warm times in turns, one profile a way; the other curves'
    batches (K = 16, 4) both ways and `prove` at K = 1 on every curve;
    the bucket kernels against their plain versions at a headline L/R row
    set on each curve and at a row with zero scalars and a padded tail;
    and, timed only, the bucket MSM at the verifier's variable-MSM shape
    beside K2 + K3. Returns (line, launches by curve and path)."""
    from bulletproofsplus_tpu_torch import (
        DeterministicRng,
        DeterministicTranscript,
        VerificationError,
        batch_prove,
        batch_verify,
        curve_ops,
        prove,
        roofline,
        serialize,
    )
    from bulletproofsplus_tpu_torch.curves import cuda_curve as cc
    from bulletproofsplus_tpu_torch.msm import msm
    from bulletproofsplus_tpu_torch.msm.engine import joint_width
    from bulletproofsplus_tpu_torch.msm.pippenger import window

    t_phase = time.time()
    dev = torch.device(DEVICE)
    out, launches = {}, {}
    wrng = random.Random(14)
    rnd = random.Random(1414)
    path_kernels = (*PATH_FIELD_KERNELS, "K2", "K3", "K5")

    def wire(curve, batch):
        return [serialize.proof_to_bytes(curve, batch[k]) for k in range(batch.A.shape[0])]

    for name in (COEFF_CURVE, *COEFF_OTHER_K):
        curve = curve_ops(name)
        fn = curve.fn
        pk, n, _, V_all = kept[name]
        K = COEFF_K if name == COEFF_CURVE else COEFF_OTHER_K[name]
        m = V_all.shape[1]
        V = V_all[:K]
        provers = bench_provers(V)
        launches[name] = {}
        row = {"K": K, "n": n, "m": m}

        def run(K=K, provers=provers):
            return batch_prove(curve, pk, n, provers, [DeterministicTranscript(m)] * K,
                               [DeterministicRng(m)] * K)

        batches = {}
        for way, env in COEFF_WAYS.items():
            with environ(env):
                needed = path_kernels + (("Pip acc", "Pip reduce") if "pippenger" in way else ())
                batch, first_ms, counts = counted(run, needed)
            if "pippenger" not in way and any(counts[k] for k in BUCKETS):
                raise AssertionError(f"{name} {way}: a bucket kernel launched: {counts}")
            launches[name][f"coeff_{way}_prove"] = counts
            batches[way] = batch
            row[way] = {"first_ms": first_ms}
            log(f"{name} {way} K={K}: proven in {first_ms:.1f} ms; launches {counts}")
        ref = wire(curve, batches["fold"])
        for way, batch in batches.items():
            if wire(curve, batch) != ref:
                raise AssertionError(f"{name} {way}: bytes differ from the fold prover's")
            trs = [DeterministicTranscript(m)] * K
            batch_verify(curve, pk, n, batch, V, trs, rng=lambda: wrng.getrandbits(128))
            bad = batch.take(slice(None))
            bad.L_vec = bad.L_vec.clone()
            bad.L_vec[K // 2, 0] = curve.dbl(bad.L_vec[K // 2, 0])
            try:
                batch_verify(curve, pk, n, bad, V, trs, rng=lambda: wrng.getrandbits(128))
            except VerificationError:
                pass
            else:
                raise AssertionError(f"{name} {way}: a tampered batch was accepted")
        log(f"{name}: the three ways' bytes are equal; each verifies, each tampered copy "
            "rejects")
        if name == COEFF_CURVE:
            turns = {way: [] for way in COEFF_WAYS}
            for _ in range(COEFF_TURNS):
                for way, env in COEFF_WAYS.items():
                    with environ(env):
                        turns[way].append(once_ms(run)[1])
            with environ(COEFF_WAYS["coeff_pippenger"]), roofline.recorded_launches() as calls:
                run()
            reduce_calls = [(k, a) for k, a in calls if k.startswith("bpp_pippenger_reduce_")]
            row["reduce"] = {"launches": [list(a[3:7]) for _, a in reduce_calls],
                             "bound_ms": roofline.bound(reduce_calls)[0]}
            log(f"{name} K={K} reduce (R, nwin, c, segments) and bound: {row['reduce']}")
            for way, env in COEFF_WAYS.items():
                with environ(env):
                    per_stage, whole, _, kern = stage_profile(run, COEFF_STAGES)
                row[way].update({"warm_ms": turns[way], "best_ms": min(turns[way]),
                                 "spread_ms": max(turns[way]) - min(turns[way]),
                                 "stages": per_stage, "whole": whole,
                                 "device_kernels": device_kernels(kern)})
                log(f"{name} {way}: warm {[round(x, 1) for x in turns[way]]} ms; stages "
                    f"{per_stage}; kernels {row[way]['device_kernels']}")
        del batches
        # prove at K = 1, coefficient form on the buckets
        with environ(COEFF_WAYS["coeff_pippenger"]):
            one, one_ms, counts = counted(
                lambda: prove(curve, pk, n, provers[0], DeterministicTranscript(m),
                              DeterministicRng(m)), path_kernels + BUCKETS)
        if serialize.proof_to_bytes(curve, one) != ref[0]:
            raise AssertionError(f"{name} prove K=1 (coeff, buckets): bytes differ from the fold's")
        launches[name]["coeff_pippenger_prove_k1"] = counts
        row["prove_k1_ms"] = one_ms
        log(f"{name} prove K=1 (coeff, buckets): bytes equal the fold's ({one_ms:.1f} ms); "
            f"launches {counts}")
        out[name] = row

        # the kernels against their plain versions: one headline L/R row set
        # (20 rows x 1,026 pairs, K = 1) on the key's generators
        S, P = coeff_rows(curve, pk, COEFF_ROWS_N, rnd)
        bucket_holds(held, name, curve, S, P, "a K = 1 L/R row set", fn.order_bits,
                     REDUCE_SEGMENTS_HELD)
        if name == COEFF_CURVE:
            # a row with zero scalars and a padded tail: the A row's 2mn + 2 pairs
            A_pts = torch.cat([pk.G_vec, pk.H_vec, pk.g[None], pk.h[None]])[None]
            A_s = fn.encode_plain([rnd.randrange(fn.p) if i % 7 else 0
                                   for i in range(A_pts.shape[1])], dev)[None]
            bucket_holds(held, name, curve, A_s, A_pts, "one row, every 7th scalar 0",
                         fn.order_bits)
        del S, P

    # -- the verifier's variable-MSM shape, timed only (not routed) ----------
    curve = curve_ops(COEFF_CURVE)
    fn = curve.fn
    _, n, _, V_all = kept[COEFF_CURVE]
    mn = n * V_all.shape[1]
    lanes = K_BATCH * (3 + 2 * (mn.bit_length() - 1) + V_all.shape[1]) + 2
    J = joint_width(lanes)
    pts = random_points(curve, lanes, rnd.randrange(1 << 30), dev)
    scal = fn.encode_plain([rnd.randrange(fn.p) for _ in range(lanes)], dev)
    c = window()
    nbits = fn.order_bits
    with roofline.recorded_launches() as b_calls:
        got = cc.bucket_msm(curve, scal[None], pts[None], nbits, c)
    with roofline.recorded_launches() as l_calls:
        want = msm(curve, scal, pts, nbits)
    if affine_ints(curve, got) != affine_ints(curve, want[None]):
        raise AssertionError("the bucket MSM at the verify shape differs from K2 + K3")
    adds = roofline.bucket_adds(fn.scalar_digits(scal, -(-nbits // c) * c, c))
    out["verify_shape"] = {
        "curve": COEFF_CURVE, "lanes": lanes, "window": c,
        "bucket_ms": cuda_ms(lambda: cc.bucket_msm(curve, scal[None], pts[None], nbits, c), 10),
        "bucket_graph_ms": graph_ms(lambda: cc.bucket_msm(curve, scal[None], pts[None],
                                                         nbits, c), 10),
        "bucket_bound_ms": roofline.bound(b_calls, adds)[0],
        "bucket_launches": [name for name, _ in b_calls],
        "k2_k3_ms": cuda_ms(lambda: msm(curve, scal, pts, nbits), 10),
        "k2_k3_graph_ms": graph_ms(lambda: msm(curve, scal, pts, nbits), 10),
        "k2_k3_bound_ms": roofline.bound(l_calls)[0], "J": J}
    log(f"verify shape ({lanes} lanes): {out['verify_shape']}")
    log(f"phase 14 took {time.time() - t_phase:.1f} s")
    return {"coeff_prover": out}, launches


def smoke_curve(name: str, seed: int, held: dict, counted):
    """Phases 2-10 on one curve; returns its timing lines."""
    from bulletproofsplus_tpu_torch import (
        DeterministicRng,
        DeterministicTranscript,
        ProofBatch,
        PublicKey,
        RangeProver,
        VerificationError,
        batch_prove,
        batch_verify,
        curve_ops,
        prove,
        serialize,
        verify,
    )
    from bulletproofsplus_tpu_torch.curves import cuda_curve as cc
    from bulletproofsplus_tpu_torch.fields.mont_mul import mont_mul, mont_mul_plain
    from bulletproofsplus_tpu_torch.msm.fixed import fixed_msm, precompute_tables_signed
    from bulletproofsplus_tpu_torch.protocol.range import (
        replay_batch,
        vinputs_multiple_batched,
    )

    dev = torch.device(DEVICE)
    curve = curve_ops(name)
    fn, fp = curve.fn, curve.fp
    C, L, S = curve.COORDS, fp.L, fn.L
    rnd = random.Random(seed)
    nbits = fn.order_bits

    with open(FIXTURES[name], "rb") as f:
        fix_curve, n, m, rows = serialize.read_fixture(f.read())
    if fix_curve != name:
        raise AssertionError(f"{FIXTURES[name]} holds {fix_curve} statements")
    mn = n * m
    (J, G), fold_shape, lr_shape = k2_shapes(n, m)
    log(f"== {name}: n = {n}, m = {m}, K = {K_BATCH}, {len(rows)} fixture statements")

    # -- 2. K1 and the field kernels, K2, K3 against their plain versions ----
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for f in (fp, fn):
        a = field_operands(f, K1_ELEMENTS, rnd, dev)
        b = field_operands(f, K1_ELEMENTS, rnd, dev)
        hold(held, (name, "K1", f"{K1_ELEMENTS} elements mod {f.spec.name}"),
             lambda: mont_mul(a, b, f.spec), lambda: mont_mul_plain(a, b, f.spec),
             lambda ker, ref: int_err(f.decode(ker), f.decode(ref)), 20, graph=True)
        field_holds(held, name, f, a, mn, gen, dev)
        del a, b

    pts = random_points(curve, G * J, rnd.randrange(1 << 30), dev)
    scal = fn.encode_plain([rnd.randrange(fn.p) for _ in range(G * J)], dev)
    pre = VERIFY_PREFIX.get(name)
    Gp = G if pre is None else pre
    ker = hold(held, (name, "K2", f"J={J}, {G} groups"),
               lambda: cc.joint_ladder_msm_grouped(curve, scal, pts, nbits, J),
               lambda: cc.joint_ladder_plain(curve, scal[:Gp * J].reshape(Gp, J, S),
                                             pts[:Gp * J].reshape(Gp, J, C, L), nbits),
               coord_err(fp), 3, prefix=pre)
    grp = ker[None]                                   # (1, G, C, L): the MSM's sum
    hold(held, (name, "K3", f"1 x {G} points"),
         lambda: cc.sum_points_grouped(curve, grp), lambda: cc.sum_points_plain(curve, grp),
         affine_err(curve), 20, graph=True)

    # -- 3. public key, tables, K4 -----------------------------------------
    t = time.time()
    pk = PublicKey.new(curve, mn, dev)
    tables = pk.fixed_tables(mn)
    torch.cuda.synchronize()
    log(f"PublicKey.new({mn}) + fixed tables {tuple(tables.shape)} "
        f"({tables.numel() * 4 / 1e6:.0f} MB) in {time.time() - t:.1f} s; "
        f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    gen_s = fn.encode_plain([rnd.randrange(fn.p) for _ in range(2 * mn)], dev)
    dig = cc.fixed_digits(curve, gen_s, nbits, signed=False)
    nparts = cc.fixed_lookup_partials(curve, tables, dig, False).shape[0]
    log(f"K4 writes {nparts} partial points for {dig.numel()} lanes")
    parts = hold(held, (name, "K4", f"{dig.numel()} lanes, {nparts} partials"),
                 lambda: cc.fixed_lookup_partials(curve, tables, dig, False),
                 lambda: cc.fixed_lookup_plain(curve, tables, dig, False),
                 lambda ker, ref: affine_err(curve)(cc.sum_points_plain(curve, ker[None]), ref),
                 20, graph=True)
    tail = torch.cat([ker, parts])[None]         # batch_verify's one K3 over both MSMs
    hold(held, (name, "K3",
                f"1 x {tail.shape[1]} points ({G} K2 outputs + {nparts} K4 partials)"),
         lambda: cc.sum_points_grouped(curve, tail), lambda: cc.sum_points_plain(curve, tail),
         affine_err(curve), 20, graph=True)
    hold(held, (name, "K4", f"fixed_msm: K4 then K3 over its {nparts} partials, "
                            f"{dig.numel()} lanes"),
         lambda: fixed_msm(curve, gen_s, tables),
         lambda: cc.fixed_lookup_plain(curve, tables, dig, False)[0], affine_err(curve), 20,
         graph=True)
    del ker, grp, parts, tail
    small = random_points(curve, 32, 11, dev)
    stab = precompute_tables_signed(curve, small)
    sdig = cc.fixed_digits(curve, gen_s[:32], nbits, signed=True)
    signed_err = int_err(
        affine_ints(curve, cc.sum_points_plain(
            curve, cc.fixed_lookup_partials(curve, stab, sdig, True)[None])),
        affine_ints(curve, cc.fixed_lookup_plain(curve, stab, sdig, True)))
    if signed_err:
        raise AssertionError(f"{name} K4 (signed table) disagrees with its plain version "
                             f"(err {signed_err})")

    # -- 4. batch verify K = 256 -------------------------------------------
    t = time.time()
    decoded = [serialize.proof_from_bytes(curve, wire, dev) for _, wire in rows]
    comms = torch.stack([curve.encode_points(serialize.points_from_bytes(curve, c), dev)
                         for c, _ in rows])
    P = len(rows)
    idx = torch.arange(K_BATCH, device=dev) % P
    batch = ProofBatch.from_proofs(decoded).take(idx)
    V = comms[idx]
    log(f"decoded {P} fixture statements in {time.time() - t:.1f} s")
    wrng = random.Random(seed + 1)

    def run_batch(b=batch):
        batch_verify(curve, pk, n, b, V, [DeterministicTranscript(m)] * K_BATCH,
                     rng=lambda: wrng.getrandbits(128))

    _, first_ms, launches = counted(run_batch, (*PATH_FIELD_KERNELS, "K2", "K3", "K4"))
    log(f"batch_verify K={K_BATCH} accepted ({first_ms:.1f} ms); launches {launches}")
    warm = [once_ms(run_batch)[1] for _ in range(3)]
    best = min(warm)
    log(f"warm batch_verify: {[round(x, 1) for x in warm]} ms; best {best:.1f} ms "
        f"= {K_BATCH / best * 1e3:.1f} verify/s")
    stages = {"verify": stage_profile(run_batch, VERIFY_STAGES)[:2]}
    log(f"batch_verify stages: {stages['verify']}")

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
    ys, zs, ess, efs = replay_batch(curve, n, m, [DeterministicTranscript(m)] * 2)

    def exponents(f, device):
        two = batch.take(slice(0, 2))
        return vinputs_multiple_batched(
            f, n, m, f.encode(ys, device), f.encode(zs, device),
            f.encode([e for es in ess for e in es], device).reshape(2, -1, f.L),
            f.encode(efs, device), two.r_prime.to(device),
            two.s_prime.to(device), two.d_prime.to(device))

    if name == "edwards25519":    # at secp256k1's mn = 4,096 the CPU side takes ~40 s
        for x, y in zip(exponents(fn, dev), exponents(fn, "cpu")):
            if not torch.equal(x.cpu(), y):
                raise AssertionError("device exponent vectors differ from the plain path")
        log("exponent vectors (K=2) equal on card and CPU")

    # -- 7. the prover's kernels at its shapes ------------------------------
    pts5 = random_points(curve, K_BATCH, rnd.randrange(1 << 30), dev)
    pts5[1] = curve.identity(dev)
    s5 = fn.encode_plain([0] + [rnd.randrange(fn.p) for _ in range(K_BATCH - 1)], dev)
    h_alpha = hold(held, (name, "K5", f"{K_BATCH} lanes, {nbits} bits"),
                   lambda: cc.ladder_scalar_mul(curve, s5, pts5, nbits),
                   lambda: cc.ladder_plain(curve, s5, pts5, nbits), coord_err(fp), 20,
                   graph=True)
    # lanes off a multiple of 8 (a warp's quads partly copies of the last
    # lane), and one lane with a random scalar: a single prove's h·α
    for lo, hi in ((0, 37), (2, 3)):
        hold(held, (name, "K5", f"{hi - lo} lanes, {nbits} bits"),
             lambda: cc.ladder_scalar_mul(curve, s5[lo:hi], pts5[lo:hi], nbits),
             lambda: cc.ladder_plain(curve, s5[lo:hi], pts5[lo:hi], nbits), coord_err(fp), 20,
             graph=True)

    half = mn // 2
    Gv, Hv = pk.G_vec, pk.H_vec
    # round 0's fold: (G1_i, G2_i) and (H1_i, H2_i) pairs of every proof
    fold_p = torch.cat([torch.stack([Gv[:half], Gv[half:]], 1),
                        torch.stack([Hv[:half], Hv[half:]], 1)])
    fold_p = fold_p.expand(K_BATCH, *fold_p.shape).reshape(-1, C, L).clone()
    fold_p[3] = curve.identity(dev)
    fold_s = random_scalars(fold_p.shape[0], gen, dev)
    fold_s[:2] = 0
    Gf = fold_p.shape[0] // 2
    if (2, Gf) != fold_shape:
        raise AssertionError(f"round 0's folds run {Gf} groups, not k2_shapes' {fold_shape}")
    pre = min(PLAIN_PREFIX, Gf)
    hold(held, (name, "K2", f"J=2, {Gf} groups"),
         lambda: cc.joint_ladder_msm_grouped(curve, fold_s, fold_p, nbits, 2),
         lambda: cc.joint_ladder_plain(curve, fold_s[:2 * pre].reshape(pre, 2, S),
                                       fold_p[:2 * pre].reshape(pre, 2, C, L), nbits),
         coord_err(fp), 3, prefix=pre)
    del fold_p, fold_s

    # round 0's L and R rows: [G2 ‖ H1 ‖ g ‖ h] and [G1 ‖ H2 ‖ g ‖ h], padded
    # to a multiple of 4 with identity points and zero scalars
    W = 2 * half + 2
    Wp = -(-W // 4) * 4
    pad = curve.identity_like((Wp - W,), dev)
    gh = torch.stack([pk.g, pk.h])
    lr_p = torch.stack([torch.cat([Gv[half:], Hv[:half], gh, pad]),
                        torch.cat([Gv[:half], Hv[half:], gh, pad])])
    lr_p = lr_p.expand(K_BATCH, *lr_p.shape).reshape(-1, C, L)
    lr_s = random_scalars(lr_p.shape[0], gen, dev)
    lr_s.view(K_BATCH, 2, Wp, S)[:, :, W:] = 0
    Gl = lr_p.shape[0] // 4
    if (4, Gl) != lr_shape:
        raise AssertionError(f"round 0's L and R run {Gl} groups, not k2_shapes' {lr_shape}")
    pre = min(PLAIN_PREFIX, Gl)
    lr = hold(held, (name, "K2", f"J=4, {Gl} groups"),
              lambda: cc.joint_ladder_msm_grouped(curve, lr_s, lr_p, nbits, 4),
              lambda: cc.joint_ladder_plain(curve, lr_s[:4 * pre].reshape(pre, 4, S),
                                            lr_p[:4 * pre].reshape(pre, 4, C, L), nbits),
              coord_err(fp), 3, prefix=pre)
    lr = lr.reshape(2 * K_BATCH, Wp // 4, C, L)

    # K2 on carry runs at the prover's widths: coordinates from carry_runs
    # (off the curve: the kernel and its plain version run the same formulas
    # on any values below p) and scalars of all-ones and all-zero words
    for J in (2, 4):
        cp = fp.encode_plain(carry_runs(fp.p, L, CARRY_GROUPS * J * C, rnd), dev)
        cp = cp.reshape(CARRY_GROUPS * J, C, L)
        cs = carry_run_scalars(CARRY_GROUPS * J, gen, dev)
        hold(held, (name, "K2", f"J={J}, {CARRY_GROUPS} groups of carry-run coordinates"),
             lambda: cc.joint_ladder_msm_grouped(curve, cs, cp, nbits, J),
             lambda: cc.joint_ladder_plain(curve, cs.reshape(CARRY_GROUPS, J, S),
                                           cp.reshape(CARRY_GROUPS, J, C, L), nbits),
             coord_err(fp), 3)
        del cp, cs
    hold(held, (name, "K3", f"{lr.shape[0]} x {lr.shape[1]} points"),
         lambda: cc.sum_points_grouped(curve, lr), lambda: cc.sum_points_plain(curve, lr),
         affine_err(curve), 20, graph=True)
    del lr_p, lr_s, lr

    # the bit commitments' points: h·α_k ‖ select(bits, G, −H)
    bits = torch.randint(0, 2, (K_BATCH, mn), generator=gen, device=dev).bool()
    bc = torch.cat([h_alpha[:, None], curve.select(bits, Gv, curve.neg(Hv))], dim=1)
    hold(held, (name, "K3", f"{bc.shape[0]} x {bc.shape[1]} points"),
         lambda: cc.sum_points_grouped(curve, bc), lambda: cc.sum_points_plain(curve, bc),
         affine_err(curve), 20, graph=True)
    del bc

    # -- 8. the fixture's statements, proven on the card ----------------------
    t = time.time()
    fix_provers = []
    for k in range(P):
        wit = random.Random(1000 + k)    # scripts/make_torch_fixtures.py::statement
        pr = RangeProver()
        for _ in range(m):
            pr.commit(pk, wit.randrange(1 << n), wit.randrange(1, fn.p))
        fix_provers.append(pr)
    for k, (pr, (comm_bytes, _)) in enumerate(zip(fix_provers, rows)):
        mine = b"".join(serialize.point_bytes(curve, A) for A in
                        curve.decode_points(torch.stack(pr.commitment_vec)))
        if mine != comm_bytes:
            raise AssertionError(f"commitments of fixture statement {k} differ")
    log(f"committed the {P} fixture witnesses ({P * m} commitments) in "
        f"{time.time() - t:.1f} s; all equal the fixture")
    fixed, fix_ms = once_ms(lambda: batch_prove(
        curve, pk, n, fix_provers, [DeterministicTranscript(m)] * P,
        [DeterministicRng(m)] * P))
    differ = [k for k in range(P)
              if serialize.proof_to_bytes(curve, fixed[k]) != rows[k][1]]
    if differ:
        raise AssertionError(f"card-proven fixture statements differ: {differ}")
    log(f"batch_prove K={P}: all {P} proofs equal the fixture bytes ({fix_ms:.1f} ms)")

    # -- 9. bench.py's batch: prove K = 256, then verify it -----------------
    t = time.time()
    V_bench = bench_commitments(curve, pk, n, m)
    bench = bench_provers(V_bench)
    for k, i in ((0, 0), (0, m - 1), (K_BATCH - 1, 0), (K_BATCH // 2, m // 2)):
        if not torch.equal(V_bench[k, i], pk.commitment(bench[k].v_vec[i], bench[k].gamma_vec[i])):
            raise AssertionError(f"bench commitment ({k}, {i}) differs from PublicKey.commitment")
    log(f"committed {K_BATCH * m} bench witnesses in {time.time() - t:.1f} s")

    def run_prove():
        return batch_prove(curve, pk, n, bench, [DeterministicTranscript(m)] * K_BATCH,
                           [DeterministicRng(m)] * K_BATCH)

    proven, prove_first_ms, prove_launches = counted(run_prove,
                                                     (*PATH_FIELD_KERNELS, "K2", "K3", "K5"))
    log(f"batch_prove K={K_BATCH} ({prove_first_ms:.1f} ms); launches {prove_launches}")
    prove_warm = [once_ms(run_prove)[1] for _ in range(3)]
    prove_best = min(prove_warm)
    log(f"warm batch_prove: {[round(x, 1) for x in prove_warm]} ms; best "
        f"{prove_best:.1f} ms = {K_BATCH / prove_best * 1e3:.1f} proofs/s")
    stages["prove"] = stage_profile(run_prove, PROVE_STAGES)[:2]
    log(f"batch_prove stages: {stages['prove']}")
    bench_trs = [DeterministicTranscript(m)] * K_BATCH
    batch_verify(curve, pk, n, proven, V_bench, bench_trs,
                 rng=lambda: wrng.getrandbits(128))
    log("card-proven bench batch verified (accept)")
    bad = proven.take(slice(None))
    bad.s_prime = bad.s_prime.clone()
    bad.s_prime[K_BATCH // 2] = fn.add(bad.s_prime[K_BATCH // 2], fn.one(dev))
    try:
        batch_verify(curve, pk, n, bad, V_bench, bench_trs,
                     rng=lambda: wrng.getrandbits(128))
    except VerificationError:
        log("tampered card-proven batch rejected")
    else:
        raise AssertionError("tampered card-proven batch was accepted")

    # -- 10. m = 1 prove and verify ------------------------------------------
    one = RangeProver()
    V1 = one.commit(pk, 0xDEADBEEF12345678 % (1 << n), 987654321)
    proof1, prove1_ms = once_ms(lambda: prove(curve, pk, n, one, DeterministicTranscript(1),
                                              DeterministicRng(1)))
    verify(curve, proof1, pk, n, V1[None], DeterministicTranscript(1))
    log(f"m=1 prove ({prove1_ms:.1f} ms) and verify accepted")

    # -- 11. the fs256 transcript -------------------------------------------
    sha_holds(held, name, curve, m, gen, dev)
    chain_holds(held, name, curve, n, m, gen, dev)
    fs_lines, fs_launches, fs_stages = fs256_phase(name, curve, pk, n, m, bench, V_bench,
                                                   proven, counted, wrng, held)
    stages.update(fs_stages)

    lines = [{"batch_verify": {"curve": name, "K": K_BATCH, "n": n, "m": m,
                               "first_ms": first_ms, "warm_ms": warm,
                               "verify_per_s": K_BATCH / best * 1e3,
                               "single_ms": single_ms}},
             {"batch_prove": {"curve": name, "K": K_BATCH, "n": n, "m": m,
                              "first_ms": prove_first_ms, "warm_ms": prove_warm,
                              "proofs_per_s": K_BATCH / prove_best * 1e3,
                              "launches": prove_launches,
                              "fixture_ms": fix_ms, "single_m1_ms": prove1_ms}},
             *fs_lines]
    return (lines, {"batch_verify": launches, "batch_prove": prove_launches, **fs_launches},
            stages, (pk, n, proven, V_bench))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu-proofs", metavar="FILE",
                    help=argparse.SUPPRESS)   # the helper process of phase 12
    args = ap.parse_args()
    if args.cpu_proofs:
        return cpu_proofs(args.cpu_proofs)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 2

    from bulletproofsplus_tpu_torch import hashers_device as hd
    from bulletproofsplus_tpu_torch import kernels
    from bulletproofsplus_tpu_torch.curves import CURVE_NAMES
    from bulletproofsplus_tpu_torch.curves import cuda_curve as cc
    from bulletproofsplus_tpu_torch.fields import field_kernels as fk
    from bulletproofsplus_tpu_torch.fields.mont_mul import mont_mul

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
    if os.path.exists(CPU_PROOFS):
        os.remove(CPU_PROOFS)
    helper = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--cpu-proofs", CPU_PROOFS], stdout=subprocess.DEVNULL)

    wrappers = {**{k: mont_mul if k == "K1" else getattr(fk, fname)
                   for k, fname in FIELD_KERNELS.items()},
                "K2": cc.joint_ladder_msm_grouped,
                "K3": cc.sum_points_grouped, "K4": cc.fixed_lookup_partials,
                "K5": cc.ladder_scalar_mul, "SHA": hd.sha256_words,
                "chain": hd.fs256_chain, "Pip acc": cc.bucket_accumulate,
                "Pip merge": cc.bucket_merge, "Pip reduce": cc.bucket_reduce}

    def counted(run, needed):
        """Run `run` once with every launch counter at 0 just before it;
        (result, ms, launches). Fails if a kernel of `needed` never ran."""
        for w in wrappers.values():
            w.launches = 0
        out, ms = once_ms(run)
        counts = {k: w.launches for k, w in wrappers.items()}
        missing = [k for k in needed if counts[k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the path: {missing}")
        if counts["K1 pow"]:
            raise AssertionError(f"fe_pow launched on a path ({counts['K1 pow']} times): "
                                 "FieldOps.inv should run fe_inv")
        return out, ms, counts

    # held[(curve, kernel, shape)] =
    #     (max_abs_err, ms, plain_ms, (bound_ms, bound_by), graph_ms or None)
    held, lines, launches, stages, kept = {}, [], {}, {}, {}
    try:
        for i, name in enumerate(CURVE_NAMES):
            curve_lines, launches[name], stages[name], kept[name] = smoke_curve(
                name, args.seed + 10 * i, held, counted)
            lines += curve_lines
        facade_line, facade_launches = facade_phase(counted, helper)
    finally:
        if helper.poll() is None:
            helper.kill()
            helper.wait()
    launches[FACADE_CURVE].update(facade_launches)
    dist_line, dist_launches = distribution_phase(counted, wrappers, held, kept[DIST_BLS])
    for name, by_path in dist_launches.items():
        launches[name].update(by_path)
    coeff_line, coeff_launches = coeff_phase(counted, held, kept)
    del kept
    for name, by_path in coeff_launches.items():
        launches[name].update(by_path)

    report = []
    for (name, k, shape), (err, ms, plain_ms, (bound_ms, bound_by), g_ms) in held.items():
        fname, src, tpu = SOURCES[k]
        by_path = {path: counts[k] for path, counts in launches[name].items()}
        row = {
            "name": f"{k.split()[0]} {fname} ({name}, {shape})", "route": "cuda",
            "source": f"bulletproofsplus_tpu_torch/csrc/{src}",
            "replaces": f"bulletproofsplus_tpu/{tpu}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            # no single PyTorch call computes Montgomery products, sums or
            # powers mod p on 8- or 12-word limbs, point ladders, sums and
            # bucket MSMs on any curve family, SHA-256 over a batch of
            # tensors, or a Fiat-Shamir chain
            "library_ms": None}
        if g_ms is not None:
            row["graph_ms"] = g_ms
        if k in JAX_COUNTERPARTS:
            row["jax_counterpart"] = f"bulletproofsplus_tpu/{JAX_COUNTERPARTS[k]}"
        report.append(row)
    for line in lines:
        print(json.dumps(line))
    print(json.dumps({"stages": stages}))
    print(json.dumps(facade_line))
    print(json.dumps(dist_line))
    print(json.dumps(coeff_line))
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    log("done")
    return 0


T0 = time.time()

if __name__ == "__main__":
    sys.exit(main())
