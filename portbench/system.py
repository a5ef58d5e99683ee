"""The system under test: the PyTorch/CUDA port, driven as a user does.

The only module of the benchmark that imports the port.  It hands the
benchmark's events and holdout to the port's data model and makes the
configuration's model over it, as the configuration states; what a unit
of work does with that model belongs to the traffic's kind.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

FIELDS = ("userid", "movieid", "rating")


def _frame(rows, cols, vals):
    import pandas as pd
    return pd.DataFrame({FIELDS[0]: rows, FIELDS[1]: cols,
                         FIELDS[2]: vals.astype(np.int64)})


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class PortSystem:
    """One configuration's models over one prepared data model, on the
    cell's cards (``devices``; a one-card model runs on the first)."""

    def __init__(self, cfg: dict, traffic: dict, devices, seed: int):
        self.cfg = cfg
        self.traffic = traffic
        self.devices = [torch.device(d) for d in devices]
        self.device = self.devices[0]
        self.seed = seed
        spec = cfg["model"]
        self.model_cls = getattr(importlib.import_module(spec["module"]),
                                 spec["class"])
        self.data = None

    def prepare(self, rows, cols, vals, hold) -> None:
        """The port's data model over the training events, with the
        benchmark's holdout as its test data (known users)."""
        from polara_tpu_torch.data import RecommenderData
        data = RecommenderData(_frame(rows[~hold], cols[~hold], vals[~hold]),
                               *FIELDS, seed=0, verbose=False)
        data.prepare_training_only()
        data.set_test_data(holdout=_frame(rows[hold], cols[hold], vals[hold]),
                           warm_start=False)
        self.data = data

    def new_model(self, overrides=None):
        """The configuration's model, its settings checked against what
        the configuration states; ``overrides`` then replace some (set-up's
        warm build: the same shapes with less work)."""
        model = self.model_cls(self.data, device=self.device)
        model.verbose = False
        spec = self.cfg["model"]
        for name, value in spec["attributes"].items():
            setattr(model, name, value)
        model.topk = self.traffic["topk"]
        model.filter_seen = self.traffic["filter_seen"]
        model.seed = self.seed
        stated = dict(spec["defaults"],
                      compute_dtype=getattr(torch, self.cfg["precision"]))
        for name, value in stated.items():
            if getattr(model, name) != value:
                raise ValueError(f"{type(model).__name__}.{name} is "
                                 f"{getattr(model, name)!r}, the "
                                 f"configuration states {value!r}")
        for name, value in (overrides or {}).items():
            setattr(model, name, value)
        return model

    def release(self) -> None:
        """Drop the data model and the device blocks cached on it."""
        self.data = None
