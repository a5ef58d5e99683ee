"""Item cold-start: recommend users for items absent from training.

The PyTorch port's counterpart of ``examples/cold_start.py``
(``Comparing LightFM with HybridSVD.ipynb``, cold-start part):
feature-based fold-in models vs non-personalized baselines, on the GPU by
default (``device="cpu"`` without one).

    python3 examples_torch/cold_start.py
"""
import numpy as np
import pandas as pd

from polara_tpu_torch.data import ItemColdStartData
from polara_tpu_torch.datasets import make_synthetic_interactions
from polara_tpu_torch.models import (PopularityModelItemColdStart,
                                     RandomModelItemColdStart,
                                     SVDModelItemColdStart)


def main(device=None, n_items=200):
    events = make_synthetic_interactions(600, n_items, 18_000, seed=2)
    rs = np.random.RandomState(0)
    genres = ["action", "comedy", "drama", "horror", "scifi", "doc"]
    features = pd.DataFrame(
        {"genres": [sorted(rs.choice(genres, rs.randint(1, 4),
                                     replace=False).tolist())
                    for _ in range(n_items)]})

    data = ItemColdStartData(events, "userid", "movieid", "rating",
                             item_features=features, seed=0, verbose=False)
    data.prepare()
    print(f"cold items: {data.index.itemid.cold_start.shape[0]}, "
          f"holdout events: {data.test.holdout.shape[0]}")

    for model in (SVDModelItemColdStart(data, device=device),
                  PopularityModelItemColdStart(data, device=device),
                  RandomModelItemColdStart(data, seed=0, device=device)):
        model.verbose = False
        if hasattr(model, "rank"):
            model.rank = 20
        scores = model.evaluate("ranking")
        print(f"{model.method:12s} nDCG: {float(scores.ndcg):.4f}  "
              f"ARHR: {float(scores.arhr):.4f}")


if __name__ == "__main__":
    main()
