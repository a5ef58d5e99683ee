"""Carry trained factors across from the JAX package.

A JAX model's ``factors`` dict (converted to numpy by the caller, e.g.
``{k: np.asarray(v) for k, v in model.factors.items()}``) becomes a dict
of port tensors; :meth:`RecommenderModel.set_factors` then makes a port
model ready without a build.  Any factors dict carries across: the SVD
family's (item factors, singular values, user factors or None), the
user and item factors of ``ProbabilisticMF``, ``ImplicitALS`` and
``ImplicitBPR``, whose port then scores (and, for iALS and BPR, folds in
warm-start users) from the JAX model's factors, and ``CoffeeModel``'s
user, item and feedback factors with its ``core`` (its ``set_factors``
also makes the data's feedback-level index, so no build is needed).

:func:`result_from_jax` carries a solver's result across: an ``SvdResult``
(from ``randomized_svd`` or the streaming tier's
``distributed_chunked_rsvd``) or ``ImplicitFactors`` (from
``ials_train_events`` or ``distributed_ials_events``) becomes the port's
namedtuple of the same name, ready for the port's scoring.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Union

import numpy as np
import torch

from polara_tpu_torch.runtime.device import resolve_device


def factors_from_jax(factors: Dict[str, Optional[np.ndarray]],
                     device: Union[str, torch.device, None] = None,
                     dtype: torch.dtype = torch.float32
                     ) -> Dict[str, Optional[torch.Tensor]]:
    """``{name: array or None}`` -> ``{name: tensor or None}`` on
    ``device`` (default: the card; without one, name the CPU) in
    ``dtype`` (entries that are None stay None, like the JAX model's
    dropped user factors)."""
    device = resolve_device(device, "factors_from_jax")
    out: Dict[str, Optional[torch.Tensor]] = {}
    for name, value in factors.items():
        if value is None:
            out[name] = None
            continue
        array = np.array(value, copy=True, order="C")  # writable copy
        out[name] = torch.from_numpy(array).to(device=device, dtype=dtype)
    return out


def result_from_jax(result: NamedTuple,
                    device: Union[str, torch.device, None] = None,
                    dtype: torch.dtype = torch.float32) -> NamedTuple:
    """A JAX package ``SvdResult`` or ``ImplicitFactors`` as the port's
    namedtuple of the same name, its arrays as tensors on ``device``
    (default: the card) in ``dtype``."""
    from polara_tpu_torch.ops.implicit import ImplicitFactors
    from polara_tpu_torch.ops.rsvd import SvdResult

    port = {"SvdResult": SvdResult,
            "ImplicitFactors": ImplicitFactors}.get(type(result).__name__)
    if port is None:
        raise TypeError(f"no port counterpart for {type(result).__name__}")
    fields = factors_from_jax(
        {name: np.asarray(value) for name, value
         in zip(result._fields, result)},
        resolve_device(device, "result_from_jax"), dtype)
    return port(**fields)
