"""Device selection for the port's entry points.

Entry points default to ``"cuda"``. Without a CUDA device they raise rather
than carry on quietly on the CPU; the CPU is used only when the caller asks
for it (``device="cpu"``), as the tests do.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or --device cpu) "
            "to run on the CPU explicitly")
    return dev
