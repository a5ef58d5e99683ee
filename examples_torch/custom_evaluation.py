"""Custom evaluation with externally supplied test data.

The PyTorch port's counterpart of ``examples/custom_evaluation.py``
(``examples/Custom_evaluation.ipynb``): train on the full history with
``prepare_training_only()``, then inject externally prepared
holdout/testset frames through ``set_test_data`` instead of letting the
data model split: the known-user, selected-test-users and warm-start
scenarios.  On the GPU by default (``device="cpu"`` without one).

    python3 examples_torch/custom_evaluation.py
"""
import numpy as np

from polara_tpu_torch import RecommenderData, SVDModel
from polara_tpu_torch.datasets.synthetic import make_realistic_interactions


def main(device=None):
    events = make_realistic_interactions(n_users=400, n_items=250,
                                         n_events=12_000, seed=5)
    rng = np.random.RandomState(42)

    # hide one future interaction per sampled user as the external holdout
    holdout = (events.groupby("userid", group_keys=False)
               .apply(lambda g: g.tail(1), include_groups=False)
               .join(events[["userid"]]).sample(n=120, random_state=rng))
    observed = events.drop(holdout.index)

    data = RecommenderData(observed, "userid", "movieid", "rating", seed=0)
    data.verbose = False
    data.prepare_training_only()

    svd = SVDModel(data, device=device)
    svd.rank = 25
    svd.verbose = False
    svd.build()

    # known users, external holdout: the testset is recovered from the
    # training history of the holdout users
    data.set_test_data(holdout=holdout, warm_start=False)
    known = svd.evaluate("ranking")
    print(f"known users + external holdout  nDCG@{svd.topk}: "
          f"{float(known.ndcg):.4f}")

    # evaluate only a chosen user subset
    chosen = holdout["userid"].drop_duplicates().iloc[:40]
    data.set_test_data(holdout=holdout, test_users=chosen,
                       warm_start=False)
    subset = svd.evaluate("ranking")
    print(f"selected test users             nDCG@{svd.topk}: "
          f"{float(subset.ndcg):.4f}")

    # warm start: unseen users, external testset + holdout
    warm_users = events["userid"].drop_duplicates().sample(
        n=60, random_state=rng)
    warm_events = events[events["userid"].isin(warm_users)]
    warm_holdout = (warm_events.groupby("userid", group_keys=False)
                    .tail(1))
    warm_testset = warm_events.drop(warm_holdout.index)
    data.set_test_data(testset=warm_testset, holdout=warm_holdout,
                       warm_start=True)
    warm = svd.evaluate("relevance", simple_rates=True)
    print(f"warm start (external testset)   HR@{svd.topk}:   "
          f"{float(warm.hr):.4f}")
    return known, subset, warm


if __name__ == "__main__":
    main()
