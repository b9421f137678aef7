"""Device selection shared by the port's entry points."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Asking for no device on a host without a card raises — the
    port never carries on silently on the CPU. A CUDA device comes back
    with its index (``cuda`` -> ``cuda:<current>``), so devices compare
    equal to those of the tensors made on them."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            if device is None:
                raise RuntimeError(
                    "no CUDA device is available; pass device='cpu' to run "
                    "the plain PyTorch path on the CPU")
            raise RuntimeError(f"device {dev} requested but CUDA is "
                               "unavailable")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
