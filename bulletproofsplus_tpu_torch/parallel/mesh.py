"""The device mesh: a ("dp", "tp") grid of devices that one process drives,
and the multi-process runtime over torch.distributed.

Port of bulletproofsplus_tpu/parallel/mesh.py. The JAX mesh is
single-controller, one process driving its local devices (:20-31), and so
is this one: a Mesh lists torch.devices in a (dp, tp) grid, and the sharded
functions (parallel/sharded_msm.py, parallel/sharded_prover.py) launch each
shard's kernels on the shard's own device from one host thread, with no
host sync between shards, so that several cards overlap. Axes:

  "dp": independent groups of proofs (batch verification), a group a row;
  "tp": one MSM's (scalar, point) pairs, or one proof's vectors, split over
        a row's devices; the partial points are copied to the row's first
        device and summed there by K3.

A mesh may list one device more than once (the CPU tests list "cpu" eight
times, as the JAX tests fake eight CPU devices); `default_mesh` on the card
takes distinct cards and raises if the machine has too few.

torch.distributed serves only where the JAX package uses jax.distributed:
processes on several hosts. `global_mesh` keeps every dp row inside one
process (:65-86), so only verdicts cross processes: one int a batch,
all-reduced on a CPU tensor, which the Gloo backend serves on any machine.
`synced_call` (:108-117) separates XLA's compile from its execution before
a collective; an eager program has no compile to separate, so it is not
carried over.
"""
from __future__ import annotations

import datetime
import os

import torch


class Mesh:
    """A (dp, tp) grid of devices. `devices` holds this process's rows: rows
    [row0, row0 + len(devices)) of a mesh of `dp` rows over `world`
    processes (in one process, row0 = 0 and every row)."""

    def __init__(self, devices, dp: int | None = None, row0: int = 0, world: int = 1):
        rows = tuple(tuple(torch.device(d) for d in row) for row in devices)
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("a mesh is a non-empty (dp, tp) grid of devices")
        self.devices = rows
        self.dp = dp or len(rows)
        self.row0 = row0
        self.world = world

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": len(self.devices[0])}

    def local(self) -> "Mesh":
        """This process's rows as a mesh of their own."""
        return Mesh(self.devices)

    def axis_devices(self, axis: str = "tp") -> tuple:
        """The devices along `axis` through this process's first device."""
        if axis == "tp":
            return self.devices[0]
        if axis == "dp":
            if self.world > 1:
                raise ValueError("the dp axis of a mesh over several processes "
                                 "leaves the process")
            return tuple(row[0] for row in self.devices)
        raise ValueError(f"mesh axes are 'dp' and 'tp', not {axis!r}")

    def distinct_devices(self) -> int:
        return len({d for row in self.devices for d in row})

    def __repr__(self) -> str:
        grid = [[str(d) for d in row] for row in self.devices]
        return (f"Mesh(dp={self.dp}, tp={self.shape['tp']}, rows {self.row0}.."
                f"{self.row0 + len(self.devices) - 1} here: {grid})")


def default_mesh(n_devices: int | None = None, dp: int | None = None,
                 devices=None) -> Mesh:
    """A ("dp", "tp") mesh over the first n_devices of `devices`, by default
    the machine's CUDA cards, each once: raises if fewer than n_devices
    cards exist (a mesh never shrinks or leaves the card). dp defaults to 1,
    the whole mesh on one MSM."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: a mesh runs on the cards unless the "
                               "caller passes devices, e.g. ['cpu'] * n")
        count = torch.cuda.device_count()
        n = n_devices or count
        if n > count:
            raise ValueError(f"a mesh of {n} cards needs {n} distinct CUDA devices; this "
                             f"machine has {count} (pass devices= to list one more than once)")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = [torch.device(d) for d in devices]
        n = n_devices or len(devices)
        if n > len(devices):
            raise ValueError(f"a mesh of {n} devices from a list of {len(devices)}")
        devices = devices[:n]
    dp = dp or 1
    if n % dp:
        raise ValueError("dp must divide the device count")
    tp = n // dp
    return Mesh([devices[r * tp:(r + 1) * tp] for r in range(dp)])


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Join the multi-process runtime (idempotent); the JAX package's
    parameters (parallel/mesh.py:34): `coordinator` is the rendezvous
    (torch.distributed's init_method: "tcp://host:port", or "file:///path"
    on a filesystem every process sees, which needs no network),
    `num_processes` the world size and `process_id` this rank. They default
    to the standard variables: MASTER_ADDR and MASTER_PORT (the env://
    rendezvous), WORLD_SIZE and RANK. The backend is Gloo, which all-reduces
    the CPU tensors that carry the verdicts on any machine."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator is None and "MASTER_ADDR" in os.environ:
        coordinator = "env://"
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("init_distributed needs a coordinator (or MASTER_ADDR and "
                         "MASTER_PORT), a process count and a process id")
    dist.init_process_group("gloo", init_method=coordinator, world_size=num_processes,
                            rank=process_id)


def _world() -> tuple:
    """(world size, rank), (1, 0) outside a process group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def global_mesh(dp: int | None = None, devices=None) -> Mesh:
    """A ("dp", "tp") mesh over every process's devices, process-major:
    process r drives rows [r·dp/W, (r+1)·dp/W) of W processes, its own
    devices (by default its CUDA cards; `devices` lists them, e.g. ["cpu"]
    * 4). dp defaults to the process count, so each process owns whole dp
    rows and only the verdicts cross processes; dp must be a multiple of
    the process count for that to hold."""
    world, rank = _world()
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices, e.g. ['cpu'] * n")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices) * world
    dp = dp or world
    if n % dp:
        raise ValueError("dp must divide the global device count")
    if dp % world and world > 1:
        raise ValueError(
            f"dp={dp} must be a multiple of process_count={world} so dp rows stay "
            "host-local (partial points stay in their process; only verdicts cross)")
    tp = n // dp
    here = dp // world
    return Mesh([devices[r * tp:(r + 1) * tp] for r in range(here)], dp=dp,
                row0=rank * here, world=world)


def distributed_barrier(tag: str, timeout_ms: int = 1_800_000) -> None:
    """Line the processes up (no-op in one process), the JAX package's
    parameters (parallel/mesh.py:89); raises, naming the rank and `tag`, if
    one does not arrive within timeout_ms milliseconds."""
    import torch.distributed as dist

    if _world()[0] > 1:
        try:
            dist.monitored_barrier(timeout=datetime.timedelta(milliseconds=timeout_ms))
        except RuntimeError as exc:
            raise RuntimeError(f"distributed_barrier({tag!r}): {exc}") from exc


def warmup_collectives(mesh: Mesh) -> None:
    """One small all-reduce right after the mesh is built, while the
    processes are still in step: each contributes its device count, and
    the sum must be the mesh's dp·tp."""
    if mesh.world <= 1:
        return
    import torch.distributed as dist

    t = torch.tensor([len(mesh.devices) * mesh.shape["tp"]], dtype=torch.int64)
    dist.all_reduce(t)
    if int(t.item()) != mesh.dp * mesh.shape["tp"]:
        raise RuntimeError(f"the processes hold {int(t.item())} devices, not the mesh's "
                           f"{mesh.dp * mesh.shape['tp']}")
