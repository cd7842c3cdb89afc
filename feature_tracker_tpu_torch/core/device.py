"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on.

    Entry points default to ``"cuda"``. Without a GPU this raises instead
    of falling back to the CPU; pass ``device="cpu"`` to run there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev
