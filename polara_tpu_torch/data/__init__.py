"""Host data tier (pandas): the interaction-data model and its split
state machine."""
from polara_tpu_torch.data.dataset import (RecommenderData, TestData, Fields,
                                           build_entity_index)
from polara_tpu_torch.data.events import EventNotifier
from polara_tpu_torch.data.scenario import Scenario, UpdateRule, plan_update

__all__ = ["RecommenderData", "TestData", "Fields", "build_entity_index",
           "EventNotifier", "Scenario", "UpdateRule", "plan_update"]
