"""Where the port's entry points put their tensors by default."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """``device`` as a ``torch.device``; None means the card when one is
    present, else the CPU."""
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)
