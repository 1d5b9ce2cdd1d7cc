"""The device an entry point runs on."""

from __future__ import annotations

import torch


def pick_device(name: str = "cuda") -> torch.device:
    """The named device; a CUDA one must exist (no quiet move to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the CPU")
    return device
