from polara_tpu_torch.datasets.epinions import compute_graph_laplacian
from polara_tpu_torch.datasets.movielens import get_split_genres
from polara_tpu_torch.datasets.synthetic import (ML1M_GEOMETRY,
                                                 ML10M_GEOMETRY,
                                                 NETFLIX_GEOMETRY,
                                                 make_realistic_coo,
                                                 make_realistic_coo_device,
                                                 make_realistic_interactions,
                                                 make_synthetic_interactions)

__all__ = ["ML1M_GEOMETRY", "ML10M_GEOMETRY", "NETFLIX_GEOMETRY",
           "compute_graph_laplacian", "get_split_genres",
           "make_realistic_coo", "make_realistic_coo_device",
           "make_realistic_interactions", "make_synthetic_interactions"]
