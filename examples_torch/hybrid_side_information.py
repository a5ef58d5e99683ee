"""Side-information models: SIM, HybridSVD over a similarity-aware data
model.

The PyTorch port's counterpart of ``examples/hybrid_side_information.py``
(the reference's HybridSVD notebook): the data model carries item
similarity matrices (reindexed lazily to internal ids); HybridSVD
factorizes the similarity-augmented matrix through the implicit
``Lᵀ R L`` operator with a device Cholesky.  On the GPU by default
(``device="cpu"`` without one).

    python3 examples_torch/hybrid_side_information.py
"""
import numpy as np

from polara_tpu_torch.data.hybrid import SimilarityDataModel
from polara_tpu_torch.datasets import make_synthetic_interactions
from polara_tpu_torch.models import (HybridSVD, SimilarityAggregation,
                                     SVDModel)


def main(device=None, n_items=150):
    rs = np.random.RandomState(0)
    base = rs.rand(n_items, 8)
    similarity = base @ base.T
    d = np.sqrt(np.diag(similarity))
    similarity = similarity / d[:, None] / d[None, :]

    events = make_synthetic_interactions(500, n_items, 14_000, seed=5)
    data = SimilarityDataModel(
        events, "userid", "movieid", "rating", seed=0, verbose=False,
        relations_matrices={"movieid": similarity},
        relations_indices={"movieid": np.arange(n_items)})
    data.warm_start = False
    data.test_ratio = 0.2
    data.holdout_size = 1
    data.prepare()

    for model in (SVDModel(data, device=device),
                  HybridSVD(data, device=device),
                  SimilarityAggregation(data, device=device)):
        model.verbose = False
        if hasattr(model, "rank"):
            model.rank = 25
        scores = model.evaluate("relevance", simple_rates=True)
        print(f"{model.method:10s} HR@{model.topk}: {float(scores.hr):.4f}")

    hybrid = HybridSVD(data, device=device)
    hybrid.rank = 25
    hybrid.verbose = False
    hybrid.features_weight = 0.8  # rebuilds the Cholesky factors in place
    scores = hybrid.evaluate("relevance", simple_rates=True)
    print(f"HybridSVD (w=0.8) HR@{hybrid.topk}: {float(scores.hr):.4f}")


if __name__ == "__main__":
    main()
