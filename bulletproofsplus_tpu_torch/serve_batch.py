"""`python -m bulletproofsplus_tpu_torch.serve_batch`: the batched serving demo.

Port of examples/serve_batch.py: K statements proven in one batch_prove,
then verified in one random-linear-combination MSM, on the card by default
(--device cpu runs the kernels' plain PyTorch versions). --mesh-dp D > 0
verifies over a ("dp", "tp") mesh of D rows (parallel/mesh.py): the
machine's cards, each once, or the devices --devices lists (a card may
appear more than once; with --device cpu the CPU once unless listed).

    python -m bulletproofsplus_tpu_torch.serve_batch [--k 16] [--n 64] [--m 16]
        [--curve edwards25519] [--mesh-dp 2] [--device cpu] [--devices LIST]
"""
from __future__ import annotations

import argparse
import time

import torch


def main(argv=None) -> None:
    from . import PublicKey, RangeProver, batch_prove, batch_verify, curve_ops, stack_commitments
    from .curves import CURVE_NAMES
    from .device import entry_device
    from .parallel import default_mesh

    ap = argparse.ArgumentParser(prog="bulletproofsplus_tpu_torch.serve_batch")
    ap.add_argument("--curve", default="edwards25519", choices=list(CURVE_NAMES))
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--mesh-dp", type=int, default=0,
                    help="dp>0: shard verification over a (dp, tp) device mesh")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    ap.add_argument("--devices", default=None,
                    help="comma-separated mesh devices (default: every CUDA card once)")
    args = ap.parse_args(argv)

    device = entry_device(args.device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    curve = curve_ops(args.curve)
    n, m, K = args.n, args.m, args.k

    t0 = time.time()
    pk = PublicKey.new(curve, n * m, device)
    print(f"setup: {time.time() - t0:.2f}s ({2 * n * m + 2} generators)")

    provers = []
    for k in range(K):
        p = RangeProver()
        for i in range(m):
            p.commit(pk, (7 * k + 3 * i + 2) % (1 << n), 2 * i + k + 3)
        provers.append(p)
    commits = stack_commitments(curve, [p.commitment_vec for p in provers])

    t0 = time.time()
    pbatch = batch_prove(curve, pk, n, provers)
    sync()
    dt = time.time() - t0
    print(f"batch_prove:  {dt:.2f}s total, {dt / K * 1e3:.0f} ms/proof "
          f"(K={K}, includes the first run's kernel loads)")

    mesh = None
    if args.mesh_dp > 0:
        devices = (args.devices.split(",") if args.devices
                   else None if device.type == "cuda" else [device])
        mesh = default_mesh(dp=args.mesh_dp, devices=devices)
        print(f"mesh: {mesh.shape} over {mesh.distinct_devices()} distinct devices")

    t0 = time.time()
    batch_verify(curve, pk, n, pbatch, commits, mesh=mesh)
    sync()
    dt = time.time() - t0
    print(f"batch_verify: {dt:.3f}s total, {dt / K * 1e3:.1f} ms/proof — ACCEPT")


if __name__ == "__main__":
    main()
