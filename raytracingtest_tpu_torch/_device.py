"""The device an entry point uses when its caller names none."""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """``cuda:0``. Raises when no CUDA device is available: the port runs on
    the card unless the caller asks for the CPU by passing ``device="cpu"``,
    so this never answers "cpu"."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available and no device was named; "
            "pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda", 0)


def resolve(device) -> torch.device:
    """`device` as a torch.device; None means default_device()."""
    return default_device() if device is None else torch.device(device)
