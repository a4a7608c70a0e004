"""Where the port's entry points run: the GPU unless told otherwise."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device`, defaulting to the GPU; raises if that is CUDA and no GPU
    is visible (no quiet fallback to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: the port runs on the GPU by "
            "default; pass device='cpu' to run on the CPU")
    return dev
