"""Multi-process batch verification over torch.distributed: two processes
on the CPU (Gloo, a file rendezvous), as tests/test_multihost.py runs the
JAX package's worker.

Each process runs the port's worker (`python -m
bulletproofsplus_tpu_torch.parallel.worker --device cpu --local-devices 2`):
a global ("dp", "tp") mesh of 2 × 2 with one dp row in each process, the
same K = 2 deterministic statements (n = 8, m = 2) proven in each, the batch
verified over the mesh (each process its own row's proof) and a copy with
proof 0 tampered, which lies in process 0's row: process 1 can reject it
only through the all-reduced verdict. Both must accept, then reject."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_process_batch_verify(tmp_path):
    rendezvous = tmp_path / "rendezvous"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "bulletproofsplus_tpu_torch.parallel.worker",
         "--init-method", f"file://{rendezvous}", "--world-size", "2", "--rank", str(rank),
         "--device", "cpu", "--local-devices", "2", "--n", "8", "--m", "2", "--K", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {rank} failed:\n{out[-4000:]}"
        assert f"MULTIHOST OK proc={rank}" in out, out[-4000:]
        assert "accept: ok" in out and "reject: ok" in out
        assert "backend gloo" in out
