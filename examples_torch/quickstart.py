"""Quickstart: standard evaluation scenario, model comparison.

The PyTorch port's counterpart of ``examples/quickstart.py`` (the
reference's ``Example_ML1M.ipynb``): prepare a data model, build several
recommenders against the same shared data, compare metric families.  Runs
on synthetic data so it works offline; swap in
``get_movielens_data("ml-1m.zip")`` for the real thing.  The models run
on the GPU by default; pass ``device="cpu"`` to run without one.

    python3 examples_torch/quickstart.py
"""
import pandas as pd

from polara_tpu_torch import (CooccurrenceModel, PopularityModel,
                              RandomModel, RecommenderData, SVDModel)
from polara_tpu_torch.datasets import make_synthetic_interactions
from polara_tpu_torch.evaluation.engine import consolidate_metrics


def main(device=None, n_users=500, n_items=300, n_events=15_000):
    events = make_synthetic_interactions(n_users, n_items, n_events, seed=0)
    data = RecommenderData(events, "userid", "movieid", "rating", seed=0)
    data.name = "synthetic"
    data.warm_start = False
    data.test_ratio = 0.2
    data.holdout_size = 3
    data.prepare()

    models = [SVDModel(data, device=device),
              CooccurrenceModel(data, device=device),
              PopularityModel(data, device=device),
              RandomModel(data, seed=0, device=device)]
    models[0].rank = 30

    scores = {}
    for model in models:
        model.verbose = False
        scores[model.method] = consolidate_metrics(
            model.evaluate("all"), label=model.method)
    table = pd.concat(scores.values(), axis=1)
    print(f"models on {models[0].device}")
    print(table.T.round(4))
    return table


if __name__ == "__main__":
    main()
