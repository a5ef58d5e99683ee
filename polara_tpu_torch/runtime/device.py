"""Where the port's entry points put their tensors by default."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None],
                   entry_point: str) -> torch.device:
    """``device`` as a ``torch.device``; None means the card.

    Without a card a missing device raises instead of turning into the
    CPU, so no entry point quietly runs off the card: CPU work is asked
    for by name (``device="cpu"``).  ``entry_point`` names the caller in
    the error."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{entry_point}: no CUDA device is available; pass "
            f"device=\"cpu\" to run on the CPU")
    return torch.device("cuda")
