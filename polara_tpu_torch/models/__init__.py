from polara_tpu_torch.models.base import EmbeddingsMixin, RecommenderModel
from polara_tpu_torch.models.baselines import (CooccurrenceModel,
                                               PopularityModel, RandomModel)
from polara_tpu_torch.models.coffee import CoffeeModel
from polara_tpu_torch.models.coldstart import (
    HybridSVDItemColdStart, LCEModelItemColdStart,
    PopularityModelItemColdStart, RandomModelItemColdStart,
    ScaledHybridSVDItemColdStart, ScaledSVDItemColdStart,
    SimilarityAggregationItemColdStart, SVDModelItemColdStart)
from polara_tpu_torch.models.contextual import ItemPostFilteringMixin
from polara_tpu_torch.models.hybrid import (HybridSVD, KernelizedPMF,
                                            LCEModel, ScaledHybridSVD,
                                            SimilarityAggregation)
from polara_tpu_torch.models.implicit_mf import ImplicitALS, ImplicitBPR
from polara_tpu_torch.models.mf import ProbabilisticMF
from polara_tpu_torch.models.svd import (ScaledMatrixMixin, ScaledSVD,
                                         SVDModel)

__all__ = ["RecommenderModel", "EmbeddingsMixin", "PopularityModel",
           "RandomModel", "CooccurrenceModel", "SVDModel", "ScaledSVD",
           "ScaledMatrixMixin", "ProbabilisticMF", "CoffeeModel",
           "SimilarityAggregation", "KernelizedPMF", "LCEModel",
           "HybridSVD", "ScaledHybridSVD", "RandomModelItemColdStart",
           "PopularityModelItemColdStart",
           "SimilarityAggregationItemColdStart", "SVDModelItemColdStart",
           "HybridSVDItemColdStart", "ScaledSVDItemColdStart",
           "ScaledHybridSVDItemColdStart", "LCEModelItemColdStart",
           "ItemPostFilteringMixin", "ImplicitALS", "ImplicitBPR"]
