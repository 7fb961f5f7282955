"""Device resolution for the port's entry points.

The port runs on the card: an entry point given no device uses ``"cuda"``,
and without a card it raises instead of carrying on on the CPU.  The CPU is
used only when the caller names it (the tests do), and then every kernel
wrapper takes its plain PyTorch version.

Nothing here initialises CUDA at import time; ``torch.cuda.is_available()``
is asked only when an entry point resolves its device.
"""
from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


class NoCardError(RuntimeError):
    """Raised when the card is asked for and none is present."""


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """``"cuda"`` unless the caller names another device; raise without a card."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise NoCardError(
                "repro_torch runs on the card and no CUDA device is present;"
                " pass device='cpu' to run the plain PyTorch versions instead"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
