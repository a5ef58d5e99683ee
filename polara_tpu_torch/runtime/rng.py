"""Randomness discipline.

Host-side splitting uses ``numpy.random.RandomState`` exactly like
:mod:`polara_tpu.runtime.rng`, so data splits are identical for a seed;
device-side draws come from an explicit ``torch.Generator`` (the
counterpart of the JAX package's ``jax.random`` keys — a different
stream, so device draws are comparable only in distribution).
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from polara_tpu_torch.runtime.device import resolve_device


def check_random_state(random_state: Union[None, int, np.random.RandomState]
                       ) -> np.random.RandomState:
    if random_state is None:
        return np.random.RandomState()
    if isinstance(random_state, int):
        return np.random.RandomState(random_state)
    if isinstance(random_state, np.random.RandomState):
        return random_state
    raise ValueError(f"Cannot use {random_state!r} to seed RandomState")


def generator_from_seed(seed: Optional[int],
                        device: Union[str, torch.device] = "cpu"
                        ) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from an optional integer
    (0 if None), like ``key_from_seed`` in the JAX package."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(0 if seed is None else int(seed) & 0x7FFFFFFF)
    return gen


def random_seeds(num: int, entropy: Optional[int] = None) -> np.ndarray:
    """Independent 32-bit seeds from one entropy source (SeedSequence),
    the JAX package's draws."""
    return np.random.SeedSequence(entropy).generate_state(num)


def key_from_seed(seed: Optional[int],
                  device: Union[str, torch.device, None] = None
                  ) -> torch.Generator:
    """The port's counterpart of a jax PRNG key: a ``torch.Generator`` on
    ``device`` (default: the card; without one, name the CPU) seeded
    from an optional integer (0 if None)."""
    return generator_from_seed(seed, resolve_device(device,
                                                    "key_from_seed"))
