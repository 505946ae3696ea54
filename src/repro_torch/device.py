"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; a CUDA device without a card raises
    (entry points run on the card unless the caller asks for the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path")
    return dev
