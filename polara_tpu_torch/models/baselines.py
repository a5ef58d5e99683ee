"""Non-personalized and neighborhood baselines.

Counterpart of :mod:`polara_tpu.models.baselines` (reference
``polara/recommender/models.py:607-725``).  Random scores come from a
``torch.Generator`` seeded from ``(seed, chunk.start)``: deterministic per
seed and chunk like the JAX package's ``fold_in`` keys, but a different
stream, so the two agree in distribution only.
"""
from __future__ import annotations

import contextlib
import warnings

import numpy as np
import torch

from polara_tpu_torch.models.base import RecommenderModel
from polara_tpu_torch.ops.scoring import TestChunk
from polara_tpu_torch.runtime.timing import track_time


def _chunk_generator(seed: int, chunk: TestChunk) -> torch.Generator:
    """Generator on the chunk's device for (seed, chunk start), mixed into
    32 bits (the CPU generator keeps only the low 32 bits of a seed)."""
    gen = torch.Generator(device=chunk.users.device)
    mixed = np.random.SeedSequence([int(seed), int(chunk.start)])
    gen.manual_seed(int(mixed.generate_state(1)[0]))
    return gen


@contextlib.contextmanager
def _full_f32():
    """f32 products in full f32 on the card (no TF32), restored after:
    co-occurrence counts stay exact integers below 2^24."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _item_groups(model):
    itemid = model.data.fields.itemid
    return model.data.training.groupby(itemid, sort=True)


class PopularityModel(RecommenderModel):
    """'MP': item interaction counts (or feedback sums) broadcast to every
    user (reference ``models.py:649-668``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.method = "MP"
        self.by_feedback_value = False

    def build(self):
        groups = _item_groups(self)
        if self.by_feedback_value:
            scores = groups[self.data.fields.feedback].sum().values
        else:
            scores = groups.size().values
        self.item_scores = torch.as_tensor(np.array(scores)).to(
            device=self.device, dtype=self.compute_dtype)

    def score_params(self) -> dict:
        return {"item_scores": self.item_scores}

    @staticmethod
    def score_chunk(params: dict, chunk: TestChunk) -> torch.Tensor:
        scores = params["item_scores"]
        return scores[None, :].expand(chunk.users.shape[0], -1)


class RandomModel(RecommenderModel):
    """'RND': uniform random scores, deterministic per (seed, chunk)
    (reference ``models.py:671-690``)."""

    row_local_scores = False  # one stream per chunk

    def __init__(self, *args, **kwargs):
        self.seed = kwargs.pop("seed", None)
        super().__init__(*args, **kwargs)
        self.method = "RND"

    def build(self):
        self.data.update()
        item_index = self.data.get_entity_index(self.data.fields.itemid)
        self.n_items = item_index.shape[0]
        self._seed_value = 0 if self.seed is None else int(self.seed)

    def score_params(self) -> dict:
        return {"seed": self._seed_value,
                "catalog": torch.zeros((self.n_items,),
                                       dtype=self.compute_dtype,
                                       device=self.device)}

    @staticmethod
    def score_chunk(params: dict, chunk: TestChunk) -> torch.Tensor:
        catalog = params["catalog"]
        return torch.rand((chunk.users.shape[0], catalog.shape[0]),
                          generator=_chunk_generator(params["seed"], chunk),
                          dtype=catalog.dtype, device=catalog.device)


class CooccurrenceModel(RecommenderModel):
    """'item-to-item': scores via the co-occurrence matrix ``RᵀR`` with the
    diagonal zeroed (reference ``models.py:693-725``), built densely on
    the model's device in full f32."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.method = "item-to-item"
        self.implicit = False

    def build(self):
        coo = self.get_training_matrix()
        vals = torch.sign(coo.vals) if self.implicit else coo.vals
        with track_time(self.training_time, verbose=self.verbose,
                        model=self.method):
            self._i2i_matrix = _build_i2i(coo.rows, coo.cols, vals,
                                          coo.shape)

    def score_params(self) -> dict:
        return {"i2i": self._i2i_matrix, "implicit": self.implicit}

    @staticmethod
    def score_chunk(params: dict, chunk: TestChunk) -> torch.Tensor:
        i2i = params["i2i"]
        vals = torch.sign(chunk.vals) if params["implicit"] else chunk.vals
        vals = torch.where(chunk.valid, vals, 0.0).to(i2i.dtype)
        profile = torch.zeros((chunk.users.shape[0], i2i.shape[0]),
                              dtype=i2i.dtype, device=i2i.device)
        profile.index_put_((chunk.rows, chunk.cols), vals, accumulate=True)
        with _full_f32():
            return profile @ i2i


def _build_i2i(rows, cols, vals, shape):
    dense = torch.zeros(shape, dtype=vals.dtype, device=vals.device)
    dense.index_put_((rows, cols), vals, accumulate=True)
    with _full_f32():
        i2i = dense.T @ dense
    return i2i.fill_diagonal_(0)


class NonPersonalized(RecommenderModel):
    """Deprecated most-popular / random / top-score model
    (reference ``models.py:607-646``), kept for API parity; use
    :class:`PopularityModel` or :class:`RandomModel` instead."""

    row_local_scores = False  # "random" draws one stream per chunk

    def __init__(self, kind, *args, **kwargs):
        warnings.warn("This is a deprecated method. Use either "
                      "PopularityModel or RandomModel instead.",
                      DeprecationWarning)
        self.seed = kwargs.pop("seed", None)
        super().__init__(*args, **kwargs)
        self.method = kind

    def build(self):
        groups = _item_groups(self)
        if self.method == "mostpopular":
            scores = groups.size().values
        elif self.method == "topscore":
            scores = groups[self.data.fields.feedback].sum().values
        elif self.method == "random":
            n_items = self.data.get_entity_index(
                self.data.fields.itemid).shape[0]
            scores = np.zeros(n_items)
        else:
            raise NotImplementedError(self.method)
        self.item_scores = torch.as_tensor(np.array(scores)).to(
            device=self.device, dtype=self.compute_dtype)

    def score_params(self) -> dict:
        return {"item_scores": self.item_scores,
                "randomized": self.method == "random",
                "seed": 0 if self.seed is None else int(self.seed)}

    @staticmethod
    def score_chunk(params: dict, chunk: TestChunk) -> torch.Tensor:
        scores = params["item_scores"]
        if params["randomized"]:
            return torch.rand((chunk.users.shape[0], scores.shape[0]),
                              generator=_chunk_generator(params["seed"],
                                                         chunk),
                              dtype=scores.dtype, device=scores.device)
        return scores[None, :].expand(chunk.users.shape[0], -1)
