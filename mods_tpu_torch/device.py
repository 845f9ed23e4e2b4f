"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU.
    Asking for CUDA without a card raises: nothing falls back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mods_tpu_torch: CUDA device requested but no GPU is "
            "available; pass device='cpu' to run the plain versions")
    return dev
