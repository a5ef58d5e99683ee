from polara_tpu_torch.models.base import EmbeddingsMixin, RecommenderModel
from polara_tpu_torch.models.svd import SVDModel

__all__ = ["RecommenderModel", "EmbeddingsMixin", "SVDModel"]
