"""Distribution: the ("dp", "tp") device mesh, sharded MSMs, the sharded
prover and multi-process verdicts (bulletproofsplus_tpu/parallel/__init__.py,
less `synced_call`, which an eager program does not need)."""
from .mesh import (
    Mesh,
    default_mesh,
    distributed_barrier,
    global_mesh,
    init_distributed,
    warmup_collectives,
)
from .sharded_msm import (
    replicated_all_identity,
    sharded_fixed_msm,
    sharded_msm,
    sharded_msm_rows,
)
from .sharded_prover import sharded_prove

__all__ = [
    "Mesh",
    "sharded_prove",
    "default_mesh",
    "global_mesh",
    "distributed_barrier",
    "init_distributed",
    "replicated_all_identity",
    "warmup_collectives",
    "sharded_fixed_msm",
    "sharded_msm",
    "sharded_msm_rows",
]
