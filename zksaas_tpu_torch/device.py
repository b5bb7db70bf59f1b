"""Device choice for the port's entry points.

Entry points run on the card: `device` defaults to "cuda", and asking for
it on a machine without a CUDA device raises instead of falling back to
the CPU.  Tests and small runs pass device="cpu" explicitly.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
