"""The device an entry point runs on: the card unless the caller asks for
the CPU, and an error, not a quiet CPU run, where there is no card."""
from __future__ import annotations

import torch


def resolve_device(device, who: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: device '{device}' asked for and no CUDA "
                           f"card is available; pass device='cpu' to run "
                           f"on the host")
    return dev
