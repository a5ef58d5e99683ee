"""Dataset loaders and generators (counterpart of
:mod:`polara_tpu.datasets`).

Each loader parses a locally available archive into pandas DataFrames with
the canonical ``userid / itemid / feedback`` column layout expected by
:class:`polara_tpu_torch.data.RecommenderData`; downloading is opt-in
(``allow_download=True``).  The loaders import pandas when called, so
this package imports without it.  The synthetic generators draw
realistically shaped logs without any download.
"""
from polara_tpu_torch.datasets.amazon import get_amazon_data
from polara_tpu_torch.datasets.bookcrossing import get_bookcrossing_data
from polara_tpu_torch.datasets.epinions import (compute_graph_laplacian,
                                                get_epinions_data)
from polara_tpu_torch.datasets.movielens import (filter_short_head,
                                                 get_movielens_data,
                                                 get_split_genres)
from polara_tpu_torch.datasets.netflix import get_netflix_data
from polara_tpu_torch.datasets.synthetic import (ML1M_GEOMETRY,
                                                 ML10M_GEOMETRY,
                                                 NETFLIX_GEOMETRY,
                                                 make_realistic_coo,
                                                 make_realistic_coo_device,
                                                 make_realistic_interactions,
                                                 make_synthetic_interactions)
from polara_tpu_torch.datasets.yahoo import get_yahoo_music_data

__all__ = ["get_amazon_data", "get_bookcrossing_data", "get_epinions_data",
           "compute_graph_laplacian", "get_movielens_data",
           "get_split_genres", "filter_short_head", "get_netflix_data",
           "get_yahoo_music_data", "ML1M_GEOMETRY", "ML10M_GEOMETRY",
           "NETFLIX_GEOMETRY", "make_realistic_coo",
           "make_realistic_coo_device", "make_realistic_interactions",
           "make_synthetic_interactions"]
