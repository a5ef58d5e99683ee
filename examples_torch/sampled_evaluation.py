"""Sampled-candidate evaluation (EigenRec protocol).

The PyTorch port's counterpart of ``examples/sampled_evaluation.py``
(``Reproducing_EIGENREC_results.ipynb``): each test user is ranked over
their holdout item plus N random unseen items; MRR over that candidate
set.  The ScaledSVD (EigenRec) popularity rescaling is swept over the
column-scaling exponent.  On the GPU by default (``device="cpu"`` without
one).

    python3 examples_torch/sampled_evaluation.py
"""
from polara_tpu_torch.data import RecommenderData, SampledEvaluationMixin
from polara_tpu_torch.datasets import make_synthetic_interactions
from polara_tpu_torch.models.sampled import SampledEvaluationSVDMixin
from polara_tpu_torch.models.svd import ScaledSVD
from polara_tpu_torch.preprocessing.dataframes import \
    sample_unseen_interactions


class SampledData(SampledEvaluationMixin, RecommenderData):
    pass


class SampledScaledSVD(SampledEvaluationSVDMixin, ScaledSVD):
    pass


def main(device=None, n_items=400, n_random=99):
    events = make_synthetic_interactions(800, n_items, 25_000, seed=4)
    data = SampledData(events, "userid", "movieid", "rating", seed=0)
    data.verbose = False
    data.warm_start = False
    data.test_ratio = 0
    data.holdout_size = 1
    data.prepare()

    # unseen candidate lists per user in the raw id space; the data model
    # maps them onto internal ids
    item_pool = data.get_entity_index("movieid")["old"].values
    unseen = sample_unseen_interactions(
        events, item_pool, n_random=n_random, random_state=0,
        userid="userid", itemid="movieid")
    data.set_unseen_interactions(unseen, reindex=True)

    for scaling in (1.0, 0.6, 0.4):
        model = SampledScaledSVD(data, device=device)
        model.verbose = False
        model.rank = 30
        model.col_scaling = scaling
        mrr = model.evaluate("ranking", simple_rates=True).mrr
        print(f"col_scaling={scaling:<4} sampled MRR: {float(mrr):.4f}")


if __name__ == "__main__":
    main()
