"""One process of a multi-process batch verification.

Port of scripts/multihost_worker.py. The process joins the
torch.distributed group, builds the global ("dp", "tp") mesh with dp = the
process count (each process drives one row of its own devices), proves K
statements with deterministic transcripts (every process the same K
statements, as in the JAX worker: the batch is replicated, and each process
verifies the proofs of its own row; edwards25519), then batch-verifies
them over the mesh, which must accept, and a copy with proof 0 tampered,
which every process must reject: the tampered proof lies in process 0's
row, so the other processes learn of it only through the verdict, the one
value that crosses processes (an all-reduce on a CPU tensor over Gloo).

Run one copy a process, e.g. two on one machine with a file rendezvous:

    python -m bulletproofsplus_tpu_torch.parallel.worker \\
        --init-method file:///tmp/bpp-rdv --world-size 2 --rank I \\
        [--device cpu --local-devices 2 | --devices cuda:0,cuda:0] \\
        [--n 8 --m 2 --K 2]

On the card each process takes --local-devices distinct cards (rank r the
cards [r·D, (r+1)·D)) unless --devices lists them. Without --init-method
the standard variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) apply.
Prints `MULTIHOST OK proc=I` when both verdicts are right; exits nonzero
otherwise.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch


def local_devices(args, rank: int) -> list:
    """This process's mesh devices from the arguments."""
    if args.devices:
        return [torch.device(d) for d in args.devices.split(",")]
    D = args.local_devices or 1
    if args.device == "cpu":
        return [torch.device("cpu")] * D
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu")
    if (rank + 1) * D > torch.cuda.device_count():
        raise ValueError(f"rank {rank} needs cards {rank * D}..{(rank + 1) * D - 1}; the "
                         f"machine has {torch.cuda.device_count()} (pass --devices)")
    return [torch.device("cuda", rank * D + i) for i in range(D)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--init-method", default=None)
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--local-devices", type=int, default=None)
    ap.add_argument("--devices", default=None,
                    help="comma-separated mesh devices of this process")
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--m", type=int, default=2)
    ap.add_argument("--K", type=int, default=2)
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from .. import (
        DeterministicRng,
        DeterministicTranscript,
        PublicKey,
        RangeProver,
        VerificationError,
        batch_prove,
        batch_verify,
        curve_ops,
        stack_commitments,
    )
    from .mesh import global_mesh, init_distributed, warmup_collectives

    init_distributed(args.init_method, args.world_size, args.rank)
    world, rank = dist.get_world_size(), dist.get_rank()
    devices = local_devices(args, rank)
    if devices[0].type == "cpu":
        torch.set_num_threads(1)    # tiny tensors: threads only contend
    mesh = global_mesh(dp=world, devices=devices)
    print(f"[proc {rank}] joined: {world} processes, backend {dist.get_backend()}, {mesh}",
          flush=True)
    warmup_collectives(mesh)
    print(f"[proc {rank}] collectives warmed", flush=True)
    n, m, K = args.n, args.m, args.K
    if K % world:
        raise ValueError("K must split evenly over the dp rows")

    curve = curve_ops("edwards25519")
    pk = PublicKey.new(curve, n * m, device=devices[0])
    provers = []
    for k in range(K):
        p = RangeProver()
        for i in range(m):
            p.commit(pk, (7 * k + 3 * i + 2) % (1 << n), 2 * i + k + 3)
        provers.append(p)
    batch = batch_prove(curve, pk, n, provers, [DeterministicTranscript(m)] * K,
                        [DeterministicRng(m)] * K)
    V = stack_commitments(curve, [p.commitment_vec for p in provers])
    trs = [DeterministicTranscript(m)] * K

    t = time.perf_counter()
    batch_verify(curve, pk, n, batch, V, trs, mesh=mesh)
    print(f"[proc {rank}] accept: ok ({(time.perf_counter() - t) * 1e3:.1f} ms)",
          flush=True)

    bad = batch.take(slice(None))
    bad.r_prime = bad.r_prime.clone()
    bad.r_prime[0] = curve.fn.encode(31337, devices[0])
    t = time.perf_counter()
    try:
        batch_verify(curve, pk, n, bad, V, trs, mesh=mesh)
    except VerificationError:
        print(f"[proc {rank}] reject: ok ({(time.perf_counter() - t) * 1e3:.1f} ms)",
              flush=True)
    else:
        print(f"[proc {rank}] TAMPERED BATCH ACCEPTED", flush=True)
        return 1
    dist.destroy_process_group()
    print(f"MULTIHOST OK proc={rank}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
