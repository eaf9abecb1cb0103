"""Where the port's public entry points place their tensors.

Entry points (PublicKey.new, serialize.proof_from_bytes, the convert
helpers) run on the CUDA card unless the caller names another device; the
CPU is used only when asked for, as the CPU tests do with device="cpu".
There is no silent fallback: without a card, a call that names no device
raises. Internal helpers take the device they are given.
"""
from __future__ import annotations

import torch


def entry_device(device=None) -> torch.device:
    """`device` if given, else the current CUDA device; raises without one."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card unless "
                           "the caller passes device='cpu'")
    return torch.device("cuda", torch.cuda.current_device())
