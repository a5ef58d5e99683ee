from polara_tpu_torch.models.base import EmbeddingsMixin, RecommenderModel
from polara_tpu_torch.models.baselines import (CooccurrenceModel,
                                               PopularityModel, RandomModel)
from polara_tpu_torch.models.svd import (ScaledMatrixMixin, ScaledSVD,
                                         SVDModel)

__all__ = ["RecommenderModel", "EmbeddingsMixin", "PopularityModel",
           "RandomModel", "CooccurrenceModel", "SVDModel", "ScaledSVD",
           "ScaledMatrixMixin"]
