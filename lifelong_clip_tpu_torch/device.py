"""Device choice for the port's entry points: the GPU unless asked otherwise."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. A CUDA request with no GPU present, or for
    a card index that is not there, raises: the entry points never fall
    back to the CPU or to another card on their own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; the port runs on the GPU unless "
                "the caller asks for the CPU (device='cpu', --device cpu)")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"no CUDA device {dev.index}: "
                               f"{torch.cuda.device_count()} visible")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
