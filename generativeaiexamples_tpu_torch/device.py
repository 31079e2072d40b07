"""Device resolution for the port's entry points.

CUDA is the default. The CPU is used only when a caller asks for it
(`device="cpu"`, as the tests do); with no device given and no CUDA
available, resolution raises instead of falling back.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` -> the current CUDA device (raises without CUDA); anything
    else -> that device, which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; the port runs on the GPU unless "
                "the caller asks for the CPU explicitly (device='cpu')")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
