"""Hyper-parameter tuning: cheap rank sweeps + cross-validation.

The PyTorch port's counterpart of ``examples/hyperparameter_tuning.py``:
the SVD rank sweep builds once at the maximum rank and truncates factors
per candidate rank (no retraining); the CV routine rotates the test fold
and rebuilds subscribed models automatically.  On the GPU by default
(``device="cpu"`` without one).

    python3 examples_torch/hyperparameter_tuning.py
"""
from polara_tpu_torch import RecommenderData, SVDModel
from polara_tpu_torch.datasets import make_synthetic_interactions
from polara_tpu_torch.evaluation.engine import run_cv_experiment, topk_test
from polara_tpu_torch.evaluation.pipelines import find_optimal_svd_rank


def main(device=None):
    events = make_synthetic_interactions(500, 300, 15_000, seed=3)
    data = RecommenderData(events, "userid", "movieid", "rating", seed=0)
    data.name = "synthetic"
    data.verbose = False
    data.warm_start = False
    data.test_ratio = 0.2
    data.holdout_size = 1
    data.prepare()

    svd = SVDModel(data, device=device)
    svd.verbose = False

    best_rank, scores = find_optimal_svd_rank(
        svd, ranks=[5, 10, 20, 40], target_metric="arhr",
        return_scores=True)
    print(f"best rank by ARHR: {best_rank}")
    print(scores.round(4))

    svd.rank = best_rank
    cv = run_cv_experiment([svd], folds=[1, 2, 3],
                           metrics=["relevance", "ranking"],
                           fold_experiment=topk_test, topk_list=[5, 10])
    print(cv.round(4))
    return best_rank, cv


if __name__ == "__main__":
    main()
