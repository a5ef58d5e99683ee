"""Import-path aliases mirroring the reference package layout
(counterpart of :mod:`polara_tpu.recommender`).

The reference exposes ``polara.recommender.data`` / ``.models`` /
``.evaluation``; scripts keep their import shapes:
``from polara_tpu_torch.recommender.data import RecommenderData``.
"""
from polara_tpu_torch.recommender import data, evaluation, models

__all__ = ["data", "models", "evaluation"]
