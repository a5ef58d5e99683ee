from polara_tpu_torch.evaluation.metrics import (Experience, Hits, Ranking,
                                                 Relevance, SimpleRanking,
                                                 SimpleRelevance,
                                                 compute_metrics,
                                                 metrics_core)

__all__ = ["Relevance", "SimpleRelevance", "Ranking", "SimpleRanking",
           "Hits", "Experience", "compute_metrics", "metrics_core"]
