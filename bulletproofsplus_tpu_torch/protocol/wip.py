"""The weighted-inner-product proof container.

Port of bulletproofsplus_tpu/protocol/wip.py:29-44 (the reference struct,
wip:24-33). Its verification scalars are computed inside the batched
exponent programs of protocol/range.py; the WIP prover comes with the
prover slice.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class WipProof:
    """2·log2(n) points + A, B and three Montgomery-form scalars."""

    L_vec: torch.Tensor    # (rounds, 4, 8)
    R_vec: torch.Tensor    # (rounds, 4, 8)
    A: torch.Tensor        # (4, 8)
    B: torch.Tensor        # (4, 8)
    r_prime: torch.Tensor  # (8,)
    s_prime: torch.Tensor  # (8,)
    d_prime: torch.Tensor  # (8,)

    @property
    def rounds(self) -> int:
        return self.L_vec.shape[0]
