"""Factor checkpointing: one ``.npz`` with a JSON metadata record.

Counterpart of :mod:`polara_tpu.runtime.checkpoint`'s npz pair, in the
same format byte for byte: one array per factor, the names of factors
that are None under ``none_keys``, and the metadata, all in the
``__polara_meta__`` entry as UTF-8 JSON bytes.  A file saved by either
package loads in the other.  The JAX package's orbax pair has
name-parity functions here (:func:`save_factors_orbax`,
:func:`load_factors_orbax`) over the same npz format.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from polara_tpu_torch.runtime.device import resolve_device

_META_KEY = "__polara_meta__"


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def save_factors(path: str, factors: Dict[str, Any],
                 meta: Optional[Dict[str, Any]] = None) -> None:
    """Persist a factors dict (values: tensors, arrays or None) plus
    metadata."""
    arrays = {}
    none_keys = []
    for key, value in factors.items():
        if value is None:
            none_keys.append(key)
        else:
            arrays[key] = _host(value)
    record = {"none_keys": none_keys, "meta": meta or {}}
    arrays[_META_KEY] = np.frombuffer(
        json.dumps(record).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_factors(path: str,
                 device: Union[str, torch.device, None] = None
                 ) -> Tuple[Dict[str, Optional[torch.Tensor]],
                            Dict[str, Any]]:
    """Load a factors dict saved by :func:`save_factors` (of either
    package) as tensors on ``device`` (default: the card; without one,
    name the CPU), in the stored dtypes."""
    device = resolve_device(device, "load_factors")
    with np.load(path, allow_pickle=False) as data:
        record = json.loads(bytes(data[_META_KEY]).decode())
        factors: Dict[str, Optional[torch.Tensor]] = {
            key: torch.from_numpy(np.array(data[key])).to(device)
            for key in data.files if key != _META_KEY}
    for key in record["none_keys"]:
        factors[key] = None
    return factors, record["meta"]


_ORBAX_FILE = "factors.npz"


def save_factors_orbax(path: str, factors: Dict[str, Any],
                       meta: Optional[Dict[str, Any]] = None) -> None:
    """Name-parity counterpart of the JAX package's orbax checkpoint:
    ``path`` becomes a directory holding one ``factors.npz`` in
    :func:`save_factors`' format.  The files are not orbax's: neither
    package's orbax loader reads them, and this pair reads no orbax
    checkpoint."""
    os.makedirs(path, exist_ok=True)
    save_factors(os.path.join(path, _ORBAX_FILE), factors, meta)


def load_factors_orbax(path: str,
                       device: Union[str, torch.device, None] = None
                       ) -> Tuple[Dict[str, Optional[torch.Tensor]],
                                  Dict[str, Any]]:
    """Load a directory written by :func:`save_factors_orbax` (npz inside,
    not orbax's format) as tensors on ``device`` (default: the card)."""
    return load_factors(os.path.join(path, _ORBAX_FILE), device=device)
