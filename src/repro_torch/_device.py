"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if CUDA is asked for but absent.

    There is no quiet fallback to the CPU: a caller that wants the CPU says
    ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


def check_on(dev: torch.device, tensors, what: str) -> None:
    """Raise if any tensor lies on another device type than ``dev``."""
    for t in tensors:
        if t.device.type != dev.type:
            raise ValueError(f"{what} lies on {t.device}, expected {dev}")
