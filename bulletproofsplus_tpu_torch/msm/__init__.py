"""Multi-scalar multiplication: the joint-ladder engine and fixed-base tables."""
from .engine import msm, scalar_mul, tree_sum

__all__ = ["msm", "scalar_mul", "tree_sum"]
