"""Comparing LightFM with (Scaled)HybridSVD in item cold start.

The PyTorch port's counterpart of ``examples/lightfm_vs_hybridsvd.py``
(the reference's ``Comparing LightFM with HybridSVD.ipynb``): items with
tag features are held out as cold, each model recommends the users most
likely to engage with every cold item, and the feature-aware models are
tuned and compared on precision / coverage.  The similarity data model
feeds tag-cosine item similarity into HybridSVD; LightFM consumes the raw
tag lists through the adapter's feature stacking.

The comparison needs the optional ``lightfm`` package (or a module
registered under that name, as the test suite's fake is); without it the
script says so and runs the SVD models only.  On the GPU by default
(``device="cpu"`` without one).

    python3 examples_torch/lightfm_vs_hybridsvd.py
"""
import numpy as np
import pandas as pd

from polara_tpu_torch.data.coldstart import ItemColdStartSimilarityData
from polara_tpu_torch.datasets import make_synthetic_interactions
from polara_tpu_torch.evaluation.engine import consolidate_metrics
from polara_tpu_torch.evaluation.pipelines import find_optimal_svd_rank
from polara_tpu_torch.models.coldstart import (ScaledHybridSVDItemColdStart,
                                               ScaledSVDItemColdStart)
from polara_tpu_torch.preprocessing.features import combine_similarity_data


def make_tagged_catalog(n_items, seed=0):
    rs = np.random.RandomState(seed)
    tags = [f"tag{i}" for i in range(12)]
    return pd.DataFrame(
        {"tags": [sorted(rs.choice(tags, size=rs.randint(2, 5),
                                   replace=False).tolist())
                  for _ in range(n_items)]},
        index=pd.RangeIndex(n_items))


def main(device=None, n_items=180):
    try:
        import lightfm
        backend = getattr(lightfm, "__version__", "lightfm")
    except ImportError as err:
        backend = None
        print(f"LightFM comparison skipped: {err}")

    events = make_synthetic_interactions(500, n_items, 16_000, seed=7)
    features = make_tagged_catalog(n_items)

    # tag-cosine similarity over the catalog feeds HybridSVD
    similarity = combine_similarity_data(features, similarity_type="cosine",
                                         device=device)
    data = ItemColdStartSimilarityData(
        events, "userid", "movieid", "rating", seed=0, verbose=False,
        item_features=features,
        relations_matrices={"movieid": similarity},
        relations_indices={"movieid": features.index})
    data.test_ratio = 0.1
    data.prepare()
    print(f"cold items: {data.index.itemid.cold_start.shape[0]}, "
          f"LightFM backend: {backend or 'none'}")

    # tune the SVD baselines (rank sweeps reuse one factorization)
    ranks = [10, 20, 30]
    svd = ScaledSVDItemColdStart(data, device=device)
    svd.col_scaling = 0.4
    svd.verbose = False
    best_rank = find_optimal_svd_rank(svd, ranks, "precision")

    hsvd = ScaledHybridSVDItemColdStart(data, device=device)
    hsvd.col_scaling = 0.4
    hsvd.features_weight = 0.9
    hsvd.verbose = False
    hsvd_rank = find_optimal_svd_rank(hsvd, ranks, "precision")

    svd.rank, hsvd.rank = best_rank, hsvd_rank
    results = {
        f"ScaledSVD (rank {best_rank})": svd.evaluate(),
        f"ScaledHybridSVD (rank {hsvd_rank})": hsvd.evaluate(),
    }
    if backend is not None:
        from polara_tpu_torch.models.external import LightFMItemColdStart
        lfm = LightFMItemColdStart(data, item_features=features,
                                   device=device)
        lfm.rank = 20
        lfm.verbose = False
        results["LightFM (rank 20)"] = lfm.evaluate()
    frame = pd.concat([consolidate_metrics(scores, label)
                       for label, scores in results.items()])
    frame.columns = frame.columns.droplevel(0)  # drop the metric-type level
    cols = [c for c in ("precision", "recall", "coverage")
            if c in frame.columns]
    print(frame[cols].round(4).to_string())


if __name__ == "__main__":
    main()
