"""Device resolution shared by the port's public entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, refusing a CUDA device when no card is
    present — the port never moves work to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} needs a CUDA card, and none is available; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev
