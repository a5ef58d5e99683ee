"""Stateless DataFrame-level preprocessing.

Host copy of :mod:`polara_tpu.preprocessing.dataframes` (reference
``polara/preprocessing/dataframes.py:10-183``): reindexing against
explicit pandas indexes, observation-matrix assembly, leave-one-out
holdout splitting, unseen-item sampling for sampled evaluation, temporal
leak-free splitting, and session-length filtering.  Everything here is
host-side (pandas/numpy); the samplers draw from
``numpy.random.RandomState`` as the JAX package does, so a seed gives the
same frames in both.  pandas loads on the first call.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from polara_tpu_torch.ops.samplers import split_top_continuous
from polara_tpu_torch.runtime.rng import check_random_state


def reindex(raw_data, index, filter_invalid: bool = True,
            names=None):
    """Map entity columns through the given pandas index(es).

    Columns named after each index are replaced by positional codes;
    with ``filter_invalid`` rows whose labels are absent from the index
    (indexer -1) are dropped (reference ``dataframes.py:10-39``).
    """
    import pandas as pd

    if isinstance(index, pd.Index):
        index = [index]
    if isinstance(names, str):
        names = [names]
    if isinstance(names, (list, tuple, pd.Index)):
        for i, name in enumerate(names):
            index[i].name = name

    codes = {idx.name: idx.get_indexer(raw_data[idx.name]) for idx in index}
    new_data = raw_data.assign(**codes)

    if filter_invalid:
        invalid = np.zeros(len(new_data), dtype=bool)
        for name in codes:
            invalid |= new_data[name].values == -1
        if invalid.any():
            print(f"Filtered {int(invalid.sum())} invalid observations.")
            new_data = new_data.loc[~invalid]
    return new_data


def matrix_from_observations(data, userid: str = "userid",
                             itemid: str = "itemid", user_index=None,
                             item_index=None, feedback: Optional[str] = None,
                             preserve_order: bool = False, shape=None,
                             dtype=None):
    """Encode an interaction frame as a sparse CSR matrix.

    Returns ``(matrix, user_index, item_index)``; when indexes are not
    provided, fresh ones are built by factorization.  Same call contract
    as the reference's ``dataframes.py:42-76`` (one correct shape for a
    frame→CSR encoder); body written independently.  The CSR output is
    host-side; hand it to :func:`polara_tpu_torch.ops.sparse.
    coo_from_arrays` (or :meth:`CooMatrix.from_numpy`) to move onto the
    device.
    """
    import pandas as pd
    from scipy.sparse import csr_matrix

    have_index = user_index is not None and item_index is not None
    if have_index:
        data = reindex(data, (user_index, item_index), filter_invalid=True)
        rows = data[userid].to_numpy()
        cols = data[itemid].to_numpy()
        if shape is None:
            shape = (len(user_index), len(item_index))
    else:
        rows, user_index = pd.factorize(data[userid], sort=preserve_order)
        cols, item_index = pd.factorize(data[itemid], sort=preserve_order)
        user_index = user_index.rename(userid)
        item_index = item_index.rename(itemid)

    values = (np.ones_like(cols, dtype=dtype) if feedback is None
              else data[feedback].to_numpy())
    matrix = csr_matrix((values, (rows, cols)), dtype=dtype, shape=shape)
    return matrix, user_index, item_index


def split_holdout(data, userid: str = "userid",
                  feedback: Optional[str] = None,
                  sample_max_rated: bool = False,
                  random_state=None) -> Tuple:
    """Leave-one-out split: sample one item per user.

    Input is always shuffled first so that ties among equally top-rated
    items are broken at random (reference ``dataframes.py:79-103``).
    """
    idx_grouper = (data
                   .sample(frac=1, random_state=random_state)
                   .groupby(userid, as_index=False, sort=False))
    if sample_max_rated:
        idx = idx_grouper[feedback].idxmax()[feedback]
    else:
        idx = idx_grouper.head(1).index
    observed = data.drop(idx.values)
    holdout = data.loc[idx.values]
    return observed, holdout


def sample_unseen_items(item_group, item_pool, n, random_state):
    """Per-group helper: choose n items from the pool excluding seen ones."""
    seen_items = item_group.values
    candidates = np.setdiff1d(item_pool, seen_items, assume_unique=True)
    return random_state.choice(candidates, n, replace=False)


def sample_unseen_interactions(data,
                               item_pool: Sequence,
                               n_random: int = 999,
                               random_state=None,
                               userid: str = "userid",
                               itemid: str = "itemid"):
    """Sample ``n_random`` unseen items per user (for sampled-candidate
    evaluation, reference ``dataframes.py:113-130``).  Assumes contiguous
    item index."""
    random_state = check_random_state(random_state)
    return (data
            .groupby(userid, sort=False)[itemid]
            .apply(sample_unseen_items, item_pool, n_random, random_state))


def verify_split(train, test,
                 random_holdout: bool, feedback: str,
                 userid: str = "userid") -> None:
    """Assert no training feedback exceeds the user's holdout feedback
    (top-rated holdout invariant, reference ``dataframes.py:133-139``)."""
    if random_holdout:
        return
    hold_gr = test.set_index(userid)[feedback]
    useridx = hold_gr.index
    train_gr = (train[train[userid].isin(useridx)]
                .groupby(userid)[feedback])
    assert train_gr.apply(lambda x: x.le(hold_gr.loc[x.name]).all()).all()


def to_numeric_array(series) -> np.ndarray:
    """Codes of a non-numeric series (its categories' codes), else its
    values."""
    from pandas.api.types import is_numeric_dtype

    if not is_numeric_dtype(series):
        if not hasattr(series, "cat"):
            series = series.astype("category")
        return series.cat.codes.values
    return series.values


def split_earliest_last(data, userid: str = "userid",
                        priority: str = "timestamp", copy: bool = False):
    """Temporal leak-free split: per user, the latest event goes to the
    holdout, strictly earlier events to the observed set, and events that
    would leak future information into training go to ``future``
    (reference ``dataframes.py:150-167``)."""
    topseq_idx, lowseq_idx, nonseq_idx = split_top_continuous(
        to_numeric_array(data[userid]), data[priority].values)
    observed = data.iloc[lowseq_idx]
    holdout = data.iloc[topseq_idx]
    future = data.iloc[nonseq_idx]
    if copy:
        observed, holdout, future = (observed.copy(), holdout.copy(),
                                     future.copy())
    return observed, holdout, future


def filter_sessions_by_length(data,
                              session_label: str = "userid",
                              min_session_length: int = 3):
    """Drop users with fewer than ``min_session_length`` interactions
    (reference ``dataframes.py:170-183``)."""
    if data.duplicated().any():
        raise NotImplementedError

    sz = data[session_label].value_counts(sort=False)
    valid_length = sz >= min_session_length
    if not valid_length.all():
        valid_sessions = sz.index[valid_length]
        new_data = data[data[session_label].isin(valid_sessions)].copy()
        print("Sessions are filtered by length")
    else:
        new_data = data
    return new_data
