"""Device resolution for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU.  Without a
card they raise: they never carry on quietly on the CPU."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """None or a 'cuda' device -> that CUDA device (raises without one);
    'cpu' -> the CPU, only when asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on an NVIDIA GPU by "
            "default; pass device='cpu' (--device cpu) to run on the CPU")
    return dev
