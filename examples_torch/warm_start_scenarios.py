"""Warm-start vs standard (known-user) evaluation scenarios.

The PyTorch port's counterpart of ``examples/warm_start_scenarios.py``
(``Warm_start_and_standard_scenarios.ipynb``): the same data model
instance switches scenarios through config properties; subscribed models
rebuild or re-predict through the event system.  On the GPU by default
(``device="cpu"`` without one).

    python3 examples_torch/warm_start_scenarios.py
"""
from polara_tpu_torch import RecommenderData, SVDModel
from polara_tpu_torch.datasets import make_synthetic_interactions


def main(device=None):
    events = make_synthetic_interactions(400, 250, 12_000, seed=1)
    data = RecommenderData(events, "userid", "movieid", "rating", seed=0)
    data.verbose = False

    # warm start: test users unseen during training
    data.warm_start = True
    data.test_ratio = 0.2
    data.holdout_size = 1
    svd = SVDModel(data, device=device)
    svd.rank = 25
    svd.verbose = False
    warm = svd.evaluate("relevance", simple_rates=True)
    print(f"warm start     HR@{svd.topk}: {float(warm.hr):.4f}")

    # known users: the same model instance, the data re-splits lazily
    data.warm_start = False
    known = svd.evaluate("relevance", simple_rates=True)
    print(f"known users    HR@{svd.topk}: {float(known.hr):.4f}")

    # holdout only (no user fold)
    data.test_ratio = 0
    holdout_only = svd.evaluate("relevance", simple_rates=True)
    print(f"holdout only   HR@{svd.topk}: {float(holdout_only.hr):.4f}")
    return warm, known, holdout_only


if __name__ == "__main__":
    main()
