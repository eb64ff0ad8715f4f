"""Device choice shared by every constructor and entry point of the port."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` means the card: it raises where there is none.  The CPU is
    chosen only by an explicit ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' explicitly to "
                "run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
