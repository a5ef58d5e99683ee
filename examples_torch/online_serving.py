"""Online serving: train offline, package, serve event-list requests.

The PyTorch port's counterpart of ``examples/online_serving.py``: a
trained factor model becomes a ``ServingBundle``; requests arrive as raw
interaction histories (item-id lists or {item: rating} dicts), go to the
device as padded id buckets, are scored through the fused kernel on the
GPU, and come back as top-k item ids.  The bundle round-trips through an
npz artifact, so the serving process never needs the training data.  On
the GPU by default (``device="cpu"`` without one).

    python3 examples_torch/online_serving.py
"""
import tempfile

import numpy as np

from polara_tpu_torch import RecommenderData, SVDModel
from polara_tpu_torch.datasets import make_synthetic_interactions
from polara_tpu_torch.runtime.serving import ServingBundle


def main(device=None, n_users=500, n_items=300, n_events=15_000):
    # offline: train
    events = make_synthetic_interactions(n_users, n_items, n_events, seed=0)
    data = RecommenderData(events, "userid", "movieid", "rating", seed=0,
                           verbose=False)
    data.warm_start = False
    data.test_ratio = 0
    data.holdout_size = 1
    data.prepare()
    model = SVDModel(data, device=device)
    model.rank = 30
    model.verbose = False
    model.build()

    # package + ship
    bundle = ServingBundle.from_model(model, topk=5, batch_size=64)
    with tempfile.NamedTemporaryFile(suffix=".npz") as artifact:
        bundle.save(artifact.name)
        server = ServingBundle.load(artifact.name,     # the serving process
                                    device=model.device)
    server.warmup()                                    # before traffic

    # online: raw request payloads
    requests = [
        [3, 17, 42],                 # implicit history: item-id list
        {5: 5.0, 9: 2.0, 51: 4.0},   # explicit ratings
        [],                          # cold user
    ]
    recs = server.recommend_events(requests)
    for req, row in zip(requests, recs):
        print(f"history {req!r:<34} -> top-{server.topk}: {row.tolist()}")

    # a full batch at the bundle's batch size
    rs = np.random.RandomState(0)
    batch = [rs.choice(server.n_items, 20, replace=False).tolist()
             for _ in range(64)]
    out = server.recommend_events(batch)
    print(f"served batch of {len(batch)} histories on {model.device} -> "
          f"{out.shape} ids")
    return recs


if __name__ == "__main__":
    main()
