"""Host data tier (pandas): the interaction-data model and its split
state machine, the sampled-evaluation and long-tail mixins, the
side-relations data model, the item cold-start scenario and contextual
post-filtering."""
from polara_tpu_torch.data.dataset import (RecommenderData, TestData, Fields,
                                           build_entity_index)
from polara_tpu_torch.data.events import EventNotifier
from polara_tpu_torch.data.scenario import Scenario, UpdateRule, plan_update
from polara_tpu_torch.data.mixins import SampledEvaluationMixin, LongTailMixin
from polara_tpu_torch.data.hybrid import (SideRelationsMixin,
                                          IdentityDiagonalMixin,
                                          SimilarityDataModel)
from polara_tpu_torch.data.coldstart import (ItemColdStartData,
                                             ColdSimilarityMixin,
                                             ItemColdStartSimilarityData)
from polara_tpu_torch.data.contextual import ItemPostFilteringData

__all__ = ["RecommenderData", "TestData", "Fields", "build_entity_index",
           "EventNotifier", "Scenario", "UpdateRule", "plan_update",
           "SampledEvaluationMixin", "LongTailMixin", "SideRelationsMixin",
           "IdentityDiagonalMixin", "SimilarityDataModel",
           "ItemColdStartData", "ColdSimilarityMixin",
           "ItemColdStartSimilarityData", "ItemPostFilteringData"]
