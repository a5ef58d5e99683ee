"""Contextual post-filtering: boost items matching the user's holdout
context before top-k.

The PyTorch port's counterpart of ``examples/contextual_postfiltering.py``:
the data model maps each test user's context (e.g. genre) to the internal
items carrying it; the model mixin applies the boost in the scoring step
(the unfused route: the plain model beside it scores through the fused
kernel on the GPU).  ``device="cpu"`` runs without a GPU.

    python3 examples_torch/contextual_postfiltering.py
"""
import numpy as np
import pandas as pd

from polara_tpu_torch.data import ItemPostFilteringData
from polara_tpu_torch.datasets import make_synthetic_interactions
from polara_tpu_torch.models import SVDModel
from polara_tpu_torch.models.contextual import ItemPostFilteringMixin


class ContextualSVD(ItemPostFilteringMixin, SVDModel):
    pass


def main(device=None, n_items=200):
    rs = np.random.RandomState(0)
    genres = np.array(["action", "comedy", "drama", "scifi"])
    item_genre = genres[rs.randint(0, len(genres), n_items)]

    events = make_synthetic_interactions(400, n_items, 12_000, seed=6)
    events = events.assign(genre=item_genre[events["movieid"].values])
    mapping = pd.DataFrame({"movieid": np.arange(n_items),
                            "genre": item_genre})

    data = ItemPostFilteringData(events, "userid", "movieid", "rating",
                                 item_context_mapping={"genre": mapping},
                                 seed=0, verbose=False)
    data.warm_start = False
    data.test_ratio = 0.2
    data.holdout_size = 1
    data.prepare()

    plain = SVDModel(data, device=device)
    contextual = ContextualSVD(data, device=device)
    for model in (plain, contextual):
        model.rank = 20
        model.verbose = False
        scores = model.evaluate("relevance", simple_rates=True)
        print(f"{type(model).__name__:14s} HR@{model.topk}: "
              f"{float(scores.hr):.4f}")


if __name__ == "__main__":
    main()
