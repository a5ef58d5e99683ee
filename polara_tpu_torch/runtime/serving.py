"""Low-latency serving bundle.

Counterpart of :mod:`polara_tpu.runtime.serving`: a trained factor model
packaged for online recommendation.  Requests arrive as raw user profiles
(dense rows or event lists).  The bundle pads them to a fixed shape
(``batch_size`` rows; event lists to power-of-two widths), computes the
user-side panel ``proj`` in torch (``profiles @ V``, the weighted sum of
``V[ids]``, or the fold-in solve of iALS and BPR) and hands ``proj``, the
item panel and the request's seen bits (:func:`pack_seen_bits`) to
:func:`~polara_tpu_torch.ops.fused_topk.fused_score_topk`: the JAX
bundle's fused ``(P·V)·Vᵀ → mask seen → top-k`` program, run by the
hand-written kernel on the card and by its plain version on the CPU.

Ties go to the lower item id, as with ``jax.lax.top_k``.  Where a row has
fewer unseen items than top-k, the kernel leaves PAD slots, and the
bundle fills them as ``lax.top_k`` does: with the row's seen items in
ascending id order.  A top-k above the kernel's limit (``MAX_K``, 128)
takes the plain route (one f32 score block and a stable sort): a rule of
the shape, not a fallback.  Scores are f32 whatever the bundle's dtype.
"""
from __future__ import annotations

from itertools import chain, repeat
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from polara_tpu_torch.ops.fused_topk import (MAX_K, fused_score_topk,
                                             pack_seen_bits, seen_mask)
from polara_tpu_torch.ops.implicit import canonical_weight, confidence
from polara_tpu_torch.ops.topk import PAD_CONST, top_k_indices
from polara_tpu_torch.runtime.checkpoint import load_factors, save_factors
from polara_tpu_torch.runtime.device import resolve_device

Device = Union[str, torch.device, None]
# (proj, seen_rows, seen_cols): a batch's user-side panel and seen pairs
StepInputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _event_mask(item_ids: torch.Tensor, lengths: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(valid, ids): slot validity from the lengths, and the ids as int64
    with invalid slots pointing at item 0."""
    width = item_ids.shape[1]
    valid = (torch.arange(width, device=item_ids.device)[None, :]
             < lengths[:, None])
    return valid, torch.where(valid, item_ids.long(), 0)


def _seen_pairs(mask: torch.Tensor, ids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, cols) of the set entries of ``mask``; with ``ids``, the
    columns are the ids at those slots."""
    rows, slots = torch.nonzero(mask, as_tuple=True)
    return rows, (slots if ids is None else ids[rows, slots])


def dense_inputs(right: torch.Tensor, profiles: torch.Tensor) -> StepInputs:
    """Dense-profile step: ``proj = profiles @ right``; seen is
    ``profiles > 0``."""
    return (profiles @ right, *_seen_pairs(profiles > 0))


def events_inputs(right: torch.Tensor, item_ids: torch.Tensor,
                  values: Optional[torch.Tensor], lengths: torch.Tensor
                  ) -> StepInputs:
    """Event-list step: ``proj = Σ weight · right[id]`` over each row's
    valid slots (``values=None``: unit weights); every valid id is seen,
    whatever its value."""
    valid, ids = _event_mask(item_ids, lengths)
    if values is None:
        weights = valid.to(right.dtype)
    else:
        weights = torch.where(valid, values.to(right.dtype), 0.0)
    proj = torch.einsum("bw,bwr->br", weights, right[ids])
    return (proj, *_seen_pairs(valid, ids))


def _cholesky_solve(a: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve; a system that is not positive definite raises."""
    chol, info = torch.linalg.cholesky_ex(a)
    if bool((info != 0).any()):
        raise torch.linalg.LinAlgError(
            "fold-in normal system is not positive definite (raise the "
            "regularization)")
    return torch.cholesky_solve(rhs[..., None], chol)[..., 0]


def _weighted_gram(weights: torch.Tensor, panels: torch.Tensor
                   ) -> torch.Tensor:
    """``Σ_j weights[b, j] · panels[.., j, :]ᵀ panels[.., j, :]`` per row b;
    ``panels`` is (n, r) shared by every row or (b, n, r)."""
    if panels.dim() == 2:
        panels = panels[None]
    return torch.matmul((weights[:, :, None] * panels).transpose(1, 2),
                        panels)


def foldin_inputs(panel: torch.Tensor, gram: torch.Tensor,
                  profiles: torch.Tensor, spec: dict) -> StepInputs:
    """Fold-in step on dense profiles: solve the model's own normal system
    against the fixed item factors (iALS confidence-weighted, or the BPR
    ridge over the seen set) for ``proj``; seen is ``profiles > 0``."""
    if spec["kind"] == "ials":
        cm1 = confidence(profiles, spec["alpha"], spec["weight"],
                         spec["epsilon"])
        rhs = torch.where(profiles > 0, cm1 + 1.0, 0.0) @ panel
        aw = cm1
    else:                       # "ridge": binary preferences (BPR)
        aw = (profiles > 0).to(panel.dtype)
        rhs = aw @ panel
    x = _cholesky_solve(gram[None] + _weighted_gram(aw, panel), rhs)
    return (x, *_seen_pairs(profiles > 0))


def events_foldin_inputs(panel: torch.Tensor, gram: torch.Tensor,
                         item_ids: torch.Tensor,
                         values: Optional[torch.Tensor],
                         lengths: torch.Tensor, spec: dict) -> StepInputs:
    """Event-list variant of :func:`foldin_inputs`: each row's normal
    system from its (ids, values) history; the peak intermediate is
    (batch, width, rank), never (batch, n_items)."""
    valid, ids = _event_mask(item_ids, lengths)
    v_ids = panel[ids]                               # (b, w, r)
    if spec["kind"] == "ials":
        vals = (torch.ones(ids.shape, dtype=panel.dtype, device=ids.device)
                if values is None else values.to(panel.dtype))
        vals = torch.where(valid, vals, 0.0)
        cm1 = confidence(vals, spec["alpha"], spec["weight"],
                         spec["epsilon"])
        w_rhs = torch.where(vals > 0, cm1 + 1.0, 0.0)
        aw = cm1
    else:
        aw = valid.to(panel.dtype)
        w_rhs = aw
    rhs = torch.einsum("bw,bwr->br", w_rhs, v_ids)
    x = _cholesky_solve(gram[None] + _weighted_gram(aw, v_ids), rhs)
    return (x, *_seen_pairs(valid, ids))


def rank_items(proj: torch.Tensor, left: torch.Tensor,
               seen_rows: torch.Tensor, seen_cols: torch.Tensor, topk: int,
               filter_seen: bool) -> torch.Tensor:
    """Top-k ids of ``proj @ leftᵀ`` in f32 with the seen pairs masked:
    :func:`fused_score_topk` for ``topk <= MAX_K``, else the plain route.
    Rows with fewer unseen items than ``topk`` keep PAD slots here
    (:func:`fill_short_rows` fills them)."""
    proj = proj.float().contiguous()
    left = left.float().contiguous()
    n_items = left.shape[0]
    bits = pack_seen_bits(seen_rows, seen_cols, proj.shape[0], n_items)
    if topk <= MAX_K:
        return fused_score_topk(proj, left, bits, topk,
                                filter_seen=filter_seen)
    scores = proj @ left.T
    if filter_seen:
        scores = scores.masked_fill(seen_mask(bits, n_items), -torch.inf)
    return top_k_indices(scores, topk)


def fill_short_rows(recs: np.ndarray,
                    seen_of_row: Callable[[int], np.ndarray]) -> np.ndarray:
    """``lax.top_k``'s picks for rows with fewer unseen items than top-k:
    the PAD slots (trailing) take the row's seen items in ascending id
    order (``seen_of_row(r)``: sorted unique ids)."""
    for r in np.nonzero((recs == PAD_CONST).any(axis=1))[0]:
        slots = np.nonzero(recs[r] == PAD_CONST)[0]
        fill = seen_of_row(r)[:len(slots)]
        recs[r, slots[:len(fill)]] = fill
    return recs


def _as_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A contiguous tensor (the kernel reads row-major panels; a model's
    factors may be views, e.g. HybridSVD's solved left projector)."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.array(x))
    return x.to(device=device, dtype=dtype).contiguous()


class ServingBundle:
    """Top-k recommender over fixed item factors.

    ``batch_size`` fixes the request shape; smaller request batches are
    padded (and the padding rows discarded).  ``device``: where the
    factors live and the steps run (default: that of a tensor
    ``item_factors``, else the card).
    """

    def __init__(self, item_factors, topk: int = 10,
                 filter_seen: bool = True, batch_size: int = 256,
                 dtype: torch.dtype = torch.float32, left_panel=None,
                 value_map: Optional[dict] = None,
                 default_weight: float = 1.0,
                 fold_in: Optional[dict] = None, device: Device = None):
        if device is None and isinstance(item_factors, torch.Tensor):
            device = item_factors.device
        self.device = resolve_device(device, "ServingBundle")
        self.item_factors = _as_tensor(item_factors, dtype, self.device)
        self.left_panel = (_as_tensor(left_panel, dtype, self.device)
                           if left_panel is not None
                           else self.item_factors)
        self.topk = int(topk)
        self.filter_seen = bool(filter_seen)
        self.batch_size = int(batch_size)
        # implicit-MF warm-start semantics: {"kind": "ials", "alpha",
        # "weight", "epsilon", "reg"} or {"kind": "ridge", "reg"}.
        # None = plain p·V·Vᵀ projection (SVD family).
        self.fold_in = None
        self._gram = None
        if fold_in is not None:
            if value_map is not None:
                raise ValueError("fold_in and value_map are mutually "
                                 "exclusive serving modes")
            kind = fold_in.get("kind")
            if kind not in ("ials", "ridge"):
                raise ValueError(f"unknown fold_in kind {kind!r}")
            spec = {"kind": kind, "reg": float(fold_in.get("reg", 0.01))}
            if kind == "ials":
                spec["alpha"] = float(fold_in.get("alpha", 1.0))
                spec["epsilon"] = float(fold_in.get("epsilon", 1.0))
                spec["weight"] = canonical_weight(
                    fold_in.get("weight", "log2"))
                if callable(spec["weight"]):
                    # one call on a 1-element tensor on the bundle's
                    # device: a callable that fails on torch tensors
                    # raises here, not inside the first request
                    try:
                        confidence(torch.ones(1, dtype=dtype,
                                              device=self.device),
                                   spec["alpha"], spec["weight"],
                                   spec["epsilon"])
                    except Exception as err:
                        raise ValueError(
                            "fold-in confidence weight callable fails on "
                            "a torch tensor; use a named weight ('log2', "
                            "'log', 'linear', 'sqrt') or a callable of "
                            "torch tensors") from err
            self.fold_in = spec
            v = self.item_factors
            eye = spec["reg"] * torch.eye(v.shape[1], dtype=v.dtype,
                                          device=v.device)
            # iALS carries the full VᵀV Gram (unit baseline confidence on
            # the unobserved entries); the BPR ridge solves only over the
            # seen set (``models/implicit_mf._lstsq_fold_in``)
            self._gram = (v.T @ v + eye) if kind == "ials" else eye
        # CoFFee-style collapsed scoring: raw rating -> per-level scalar
        # weight (``models/coffee.py``); None = identity (SVD/MF raw
        # ratings).  ``default_weight`` applies to implicit requests (bare
        # item-id lists): for CoFFee the top level's weight, the
        # reference's fake-user convention
        # (``polara/recommender/models.py:344-348``).
        self.value_map = (None if value_map is None
                          else {float(k): float(v)
                                for k, v in value_map.items()})
        self.default_weight = float(default_weight)

    @property
    def n_items(self) -> int:
        return self.item_factors.shape[0]

    @classmethod
    def from_model(cls, model, topk: Optional[int] = None,
                   **kwargs) -> "ServingBundle":
        """Bundle a trained SVD-family/MF model (anything whose scoring
        is ``profiles @ V @ Vᵀ`` over item factors; ``HybridSVD``-style
        ``<item>_projector_right``/``_left`` factors serve as the two
        panels), a CoFFee model (scoring collapses to the same shape with
        per-rating scalar weights) or an implicit-MF model (iALS/BPR,
        served through their warm-start fold-in solve, not projection).
        The bundle lives on the model's device unless ``device`` is
        given."""
        kwargs.setdefault("device", model.device)
        itemid = model.data.fields.itemid
        topk = topk if topk is not None else model.topk
        if hasattr(model, "_fold_in_users"):
            # implicit family: the model's own warm-start semantics
            factors = model.factors.get(itemid)
            if factors is None:
                raise ValueError(f"{model.method} has no item factors; "
                                 "build() first")
            if hasattr(model, "weight_func"):       # iALS
                fold_in = {"kind": "ials", "alpha": model.alpha,
                           "epsilon": model.epsilon,
                           "weight": model.weight_func,
                           "reg": model.regularization}
            else:                                    # BPR-style ridge
                fold_in = {"kind": "ridge", "reg": model.regularization}
            return cls(factors, topk=topk, filter_seen=model.filter_seen,
                       fold_in=fold_in, **kwargs)
        left = None
        factors = model.factors.get(f"{itemid}_projector_right")
        if factors is not None:  # HybridSVD: asymmetric projectors
            left = model.factors.get(f"{itemid}_projector_left")
        elif "core" in model.factors and hasattr(model, "flattener"):
            # CoFFee: item panel both sides; request ratings map to the
            # collapsed level weights alpha_f = w[f] . flatten(w)
            params = model.score_params()
            level_weights = params["level_weights"].cpu().double().numpy()
            fb_index = model._feedback_index()
            value_map = {float(old): float(level_weights[int(new)])
                         for old, new in zip(fb_index["old"].values,
                                             fb_index["new"].values)}
            top_level = int(fb_index.loc[fb_index["old"].idxmax(), "new"])
            return cls(params["item_panel"], topk=topk,
                       filter_seen=model.filter_seen, value_map=value_map,
                       default_weight=float(level_weights[top_level]),
                       **kwargs)
        else:
            factors = model.factors.get(itemid)
        if factors is None:
            raise ValueError(f"{model.method} has no item factors; "
                             "build() first")
        return cls(factors, topk=topk, filter_seen=model.filter_seen,
                   left_panel=left, **kwargs)

    # --- the steps -----------------------------------------------------------

    def dense_step_inputs(self, block: torch.Tensor) -> StepInputs:
        """``(proj, seen_rows, seen_cols)`` of a padded dense-profile batch
        on the device."""
        if self.fold_in is not None:
            return foldin_inputs(self.item_factors, self._gram, block,
                                 self.fold_in)
        return dense_inputs(self.item_factors, block)

    def events_step_inputs(self, item_ids: torch.Tensor,
                           values: Optional[torch.Tensor],
                           lengths: torch.Tensor) -> StepInputs:
        """``(proj, seen_rows, seen_cols)`` of a padded event-list batch on
        the device."""
        if self.fold_in is not None:
            return events_foldin_inputs(self.item_factors, self._gram,
                                        item_ids, values, lengths,
                                        self.fold_in)
        return events_inputs(self.item_factors, item_ids, values, lengths)

    def rank(self, inputs: StepInputs) -> torch.Tensor:
        """The batch's top-k ids on the device (PAD slots unfilled)."""
        proj, seen_rows, seen_cols = inputs
        return rank_items(proj, self.left_panel, seen_rows, seen_cols,
                          self.topk, self.filter_seen)

    def warmup(self, event_widths: Sequence[int] = (128,),
               explicit_values: bool = False) -> None:
        """Run each request shape once ahead of the first request: the
        dense-profile step and the event-list step at each width in
        ``event_widths`` (a width-w bucket serves histories of up to w
        events), with rating values too when ``explicit_values`` or a
        value map is set.  The kernel library loads on the first call."""
        dummy = torch.zeros((self.batch_size, self.n_items),
                            dtype=self.item_factors.dtype,
                            device=self.device)
        self.rank(self.dense_step_inputs(dummy)).cpu()
        explicit_values = explicit_values or self.value_map is not None
        lengths = torch.zeros((self.batch_size,), dtype=torch.int32,
                              device=self.device)
        for width in event_widths:
            ids = torch.as_tensor(np.zeros((self.batch_size, int(width)),
                                           self._wire_ids_dtype())
                                  ).to(self.device)
            variants = [None]
            if explicit_values:
                variants.append(torch.zeros((self.batch_size, int(width)),
                                            device=self.device))
            for values in variants:
                self.rank(self.events_step_inputs(ids, values,
                                                  lengths)).cpu()

    # --- requests ------------------------------------------------------------

    def _map_request_values(self, values: np.ndarray) -> np.ndarray:
        """Map raw request ratings through ``value_map`` (CoFFee level
        weights).  Unknown ratings are rejected: they have no trained
        feedback level."""
        # match in the wire dtype (f32): request values are f32-quantized
        # on assembly, so comparing against f64 keys would reject levels
        # not exactly representable in f32 (e.g. 0.1)
        keys = np.asarray(sorted(self.value_map), np.float32)
        weights = np.asarray([self.value_map[k]
                              for k in sorted(self.value_map)], np.float32)
        values = np.asarray(values, np.float32)
        pos = np.clip(np.searchsorted(keys, values), 0, len(keys) - 1)
        known = keys[pos] == values
        if not known.all():
            bad = np.unique(np.asarray(values)[~known])
            raise ValueError(f"request feedback values {bad.tolist()} are "
                             "absent from the trained feedback levels")
        return weights[pos]

    def _wire_ids_dtype(self):
        """Smallest integer encoding for item ids on the request wire."""
        return (np.int16 if self.n_items <= np.iinfo(np.int16).max
                else np.int32)

    def assemble_events(self, events: Sequence):
        """Host side of :meth:`recommend_events`: the requests as a padded
        ``(item_ids, values or None, lengths)`` block of power-of-two
        width, validated and mapped through the value map."""
        n = len(events)
        # one pass over the flattened events, then one fancy-indexed
        # scatter into the padded block
        events = [e if isinstance(e, dict) or hasattr(e, "__len__")
                  else list(e) for e in events]
        lengths = np.fromiter((len(e) for e in events), np.int64, n)
        total = int(lengths.sum())
        flat_ids = np.fromiter(
            chain.from_iterable(e.keys() if isinstance(e, dict) else e
                                for e in events), np.int64, total)
        if any(isinstance(e, dict) for e in events):
            flat_vals = np.fromiter(
                chain.from_iterable(
                    e.values() if isinstance(e, dict)
                    else repeat(1.0, len(e)) for e in events),
                np.float32, total)
            # all-unit-weight collapse is for the plain factor path only:
            # under a value_map a literal rating of 1.0 must still map
            # through its trained level weight, not the implicit default
            if self.value_map is None and (flat_vals == 1.0).all():
                flat_vals = None
        else:
            flat_vals = None    # item-id lists: implicit unit weights

        if total and not (0 <= flat_ids.min()
                          and flat_ids.max() < self.n_items):
            raise ValueError(
                f"event item ids must lie in [0, {self.n_items}); got "
                f"range [{flat_ids.min()}, {flat_ids.max()}] — out-of-range"
                " ids would silently wrap in the compact wire encoding")

        if self.value_map is not None and total:
            if flat_vals is None:        # implicit requests: top-level weight
                if self.default_weight != 1.0:
                    flat_vals = np.full(total, self.default_weight,
                                        np.float32)
            else:
                # mixed batches: only dict events carry real ratings;
                # item-id lists are implicit and take default_weight
                explicit = np.fromiter(
                    chain.from_iterable(
                        repeat(isinstance(e, dict), len(e))
                        for e in events), bool, total)
                mapped = np.full(total, self.default_weight, np.float32)
                if explicit.any():
                    mapped[explicit] = self._map_request_values(
                        flat_vals[explicit])
                flat_vals = mapped

        width = max(1, int(lengths.max()) if n else 1)
        width = 1 << (width - 1).bit_length()   # bucket to powers of two
        row_idx = np.repeat(np.arange(n), lengths)
        col_idx = np.arange(total) - np.repeat(
            np.cumsum(lengths) - lengths, lengths)
        item_ids = np.zeros((n, width), self._wire_ids_dtype())
        item_ids[row_idx, col_idx] = flat_ids
        values = None
        if flat_vals is not None:
            values = np.zeros((n, width), np.float32)
            values[row_idx, col_idx] = flat_vals
        return item_ids, values, lengths.astype(np.int32)

    def recommend_events(self, events: Sequence) -> np.ndarray:
        """Top-k for per-user event lists (item-id lists or
        {item: rating} dicts) without materializing dense profiles."""
        if len(events) == 0:
            return np.empty((0, self.topk), dtype=np.int32)
        return self.serve_events(*self.assemble_events(events))

    def serve_events(self, item_ids: np.ndarray,
                     values: Optional[np.ndarray],
                     lengths: np.ndarray) -> np.ndarray:
        """Device side of :meth:`recommend_events` for an assembled block:
        ``batch_size`` rows at a time."""
        n = item_ids.shape[0]
        out = np.empty((n, self.topk), dtype=np.int32)
        for start in range(0, n, self.batch_size):
            stop = min(start + self.batch_size, n)
            pad = ((0, self.batch_size - (stop - start)), (0, 0))

            def dev(array):
                return torch.as_tensor(np.pad(array, pad[:array.ndim])).to(
                    self.device)
            recs = self.rank(self.events_step_inputs(
                dev(item_ids[start:stop]),
                None if values is None else dev(values[start:stop]),
                dev(lengths[start:stop]))).cpu().numpy()[:stop - start]
            ids, lens = item_ids[start:stop], lengths[start:stop]
            out[start:stop] = fill_short_rows(
                recs, lambda r: np.unique(ids[r, :lens[r]]))
        return out

    def recommend(self, profiles) -> np.ndarray:
        """Top-k item ids per request row.

        ``profiles``: (n, n_items) array or tensor, or a sequence of
        per-user item-id lists / {item: rating} dicts (routed through the
        low-bandwidth event path).  A row is treated as an event list
        only when it cannot be a dense profile row (a dict, or a short
        list) — pass dense matrices as arrays and prefer
        :meth:`recommend_events` for explicit event requests.
        """
        if isinstance(profiles, torch.Tensor):
            profiles = profiles.cpu().numpy()
        if not isinstance(profiles, np.ndarray):
            rows = list(profiles)
            looks_like_events = rows and all(
                isinstance(r, dict)
                or (hasattr(r, "__len__") and len(r) != self.n_items)
                for r in rows)
            if not rows or looks_like_events:
                return self.recommend_events(rows)
            raise ValueError(
                "ambiguous request: rows of length n_items could be "
                "dense profiles or event lists — pass a numpy array for "
                "profiles, or call recommend_events() for event lists")
        if profiles.ndim == 1:
            profiles = profiles[None, :]
        if self.value_map is not None:
            # CoFFee: ratings must map to level weights AND the seen mask
            # must key on raw interactions (a level weight can be
            # negative): the event path handles both
            rows, cols = np.nonzero(profiles)
            split = np.searchsorted(rows, np.arange(1, profiles.shape[0]))
            events = [dict(zip(c.tolist(), v.tolist()))
                      for c, v in zip(np.split(cols, split),
                                      np.split(profiles[rows, cols], split))]
            return self.recommend_events(events)
        n = profiles.shape[0]
        out = np.empty((n, self.topk), dtype=np.int32)
        for start in range(0, n, self.batch_size):
            stop = min(start + self.batch_size, n)
            block = self.assemble_dense(profiles[start:stop])
            recs = self.rank(self.dense_step_inputs(block.to(self.device))
                             ).cpu().numpy()[:stop - start]
            rows = block[:stop - start].numpy()
            out[start:stop] = fill_short_rows(
                recs, lambda r: np.nonzero(rows[r] > 0)[0])
        return out

    def assemble_dense(self, profiles: np.ndarray) -> torch.Tensor:
        """Host side of :meth:`recommend` for up to ``batch_size`` rows:
        the padded block in the bundle's dtype (the values rounded on the
        host, as the JAX bundle does before its transfer)."""
        block = torch.zeros((self.batch_size, self.n_items),
                            dtype=self.item_factors.dtype)
        block[:len(profiles)] = torch.as_tensor(np.asarray(profiles))
        return block

    # --- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        """The bundle as one ``.npz`` in the JAX package's format (either
        package loads it)."""
        factors = {"item_factors": self.item_factors}
        if self.left_panel is not self.item_factors:
            factors["left_panel"] = self.left_panel
        meta = {"topk": self.topk,
                "filter_seen": self.filter_seen,
                "batch_size": self.batch_size,
                "kind": "ServingBundle"}
        if self.value_map is not None:
            keys = sorted(self.value_map)
            factors["value_map_keys"] = np.asarray(keys, np.float64)
            factors["value_map_weights"] = np.asarray(
                [self.value_map[k] for k in keys], np.float64)
            meta["default_weight"] = self.default_weight
        if self.fold_in is not None:
            if callable(self.fold_in.get("weight")):
                raise ValueError(
                    "cannot persist a bundle whose fold-in confidence "
                    "weight is a custom callable; use a named weight "
                    "('log2', 'log', 'linear', 'sqrt')")
            meta["fold_in"] = dict(self.fold_in)
        save_factors(path, factors, meta)

    @classmethod
    def load(cls, path: str, device: Device = None) -> "ServingBundle":
        """A bundle saved by :meth:`save` of either package, on ``device``
        (default: the card)."""
        device = resolve_device(device, "ServingBundle.load")
        factors, meta = load_factors(path, device=device)
        value_map = None
        if "value_map_keys" in factors:
            value_map = dict(zip(
                factors["value_map_keys"].cpu().double().tolist(),
                factors["value_map_weights"].cpu().double().tolist()))
        return cls(factors["item_factors"], topk=meta["topk"],
                   filter_seen=meta["filter_seen"],
                   batch_size=meta["batch_size"],
                   left_panel=factors.get("left_panel"),
                   value_map=value_map,
                   default_weight=float(meta.get("default_weight", 1.0)),
                   fold_in=meta.get("fold_in"), device=device)
