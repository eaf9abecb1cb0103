"""Multi-scalar multiplication: the joint-ladder engine and fixed-base tables."""
from .engine import msm, msm_partials, scalar_mul, tree_sum

__all__ = ["msm", "msm_partials", "scalar_mul", "tree_sum"]
