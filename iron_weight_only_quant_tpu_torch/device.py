"""Device selection shared by the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the current CUDA card.

    There is no silent CPU fallback: with no device named and no GPU
    present this raises, and the caller must ask for ``device="cpu"``.
    """
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
