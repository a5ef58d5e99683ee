"""Epinions loader and the graph Laplacian of an entity relation (host
copy of :mod:`polara_tpu.datasets.epinions`; reference
``polara/datasets/epinions.py:6-51``).

The Laplacian feeds the kernelized PMF model
(:class:`polara_tpu_torch.models.hybrid.KernelizedPMF`) through a side
relations data model.  pandas and scipy load on the first call.
"""
from __future__ import annotations

import numpy as np


def compute_graph_laplacian(edges, index):
    """Build the (symmetrized, self-link-free) adjacency over the entities
    of ``index`` (a pandas Index) and its graph Laplacian, both scipy CSR.
    Edges whose endpoints are absent from the index are skipped."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import laplacian as graph_laplacian

    all_edges = set()
    for a, b in edges:
        try:
            a = index.get_loc(a)
            b = index.get_loc(b)
        except KeyError:
            continue
        if a == b:  # exclude self links
            continue
        all_edges.add((a, b))
        all_edges.add((b, a))

    n = len(index)
    if all_edges:
        rows, cols = zip(*all_edges)
    else:
        rows, cols = (), ()
    # pin the shape so entities without edges keep their rows aligned
    # with the entity index (isolated nodes get zero Laplacian rows)
    adjacency = sp.csr_matrix((np.ones(len(all_edges)), (rows, cols)),
                              shape=(n, n))
    assert (adjacency.diagonal() == 0).all()
    return graph_laplacian(adjacency).tocsr(), adjacency


def get_epinions_data(ratings_path=None, trust_data_path=None):
    """Load the whitespace-separated ratings table and/or trust edges."""
    import pandas as pd

    res = []
    if ratings_path:
        ratings = pd.read_csv(ratings_path, sep=r"\s+", skiprows=[0],
                              skipfooter=1, engine="python", header=None,
                              skipinitialspace=True,
                              names=["user", "film", "rating"],
                              usecols=["user", "film", "rating"])
        res.append(ratings)
    if trust_data_path:
        edges = pd.read_table(trust_data_path, sep=r"\s+", skiprows=[0],
                              skipfooter=1, engine="python", header=None,
                              skipinitialspace=True, usecols=[0, 1])
        res.append(edges)
    return res[0] if len(res) == 1 else res
