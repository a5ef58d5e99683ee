"""Scale-out on a device mesh.

The PyTorch port's counterpart of ``examples/distributed_mesh.py``: the
same workloads shard over a mesh of ``torch.device`` entries driven from
one process.  On the GPU the mesh takes the visible cards' entries, dealt
in turn (all ``cuda:0`` on one card: a logical mesh); with
``device="cpu"`` it repeats the ``"cpu"`` entry, so the sharded code
paths run anywhere.

    python3 examples_torch/distributed_mesh.py
"""
import numpy as np
import torch

from polara_tpu_torch.data import RecommenderData
from polara_tpu_torch.datasets import make_synthetic_interactions
from polara_tpu_torch.models import SVDModel
from polara_tpu_torch.ops.sparse import dense_from_coo
from polara_tpu_torch.parallel.distributed import (
    distributed_hooi, distributed_ials, distributed_randomized_svd)
from polara_tpu_torch.runtime.device import resolve_device
from polara_tpu_torch.runtime.mesh import make_mesh, use_mesh


def mesh_devices(device, n_entries=8):
    """``n_entries`` mesh entries: the card's entries dealt in turn, or the
    CPU repeated."""
    device = resolve_device(device, "distributed_mesh")
    if device.type == "cpu":
        return ["cpu"] * n_entries
    cards = torch.cuda.device_count()
    return [f"cuda:{i % cards}" for i in range(n_entries)]


def main(device=None):
    entries = mesh_devices(device)
    mesh = make_mesh(devices=entries, shape=(len(entries), 1))
    print(f"mesh entries: {len(entries)} over "
          f"{sorted(set(entries))}")

    events = make_synthetic_interactions(512, 200, 12_000, seed=0)

    # the easy path: hand any model a mesh (or scope one with use_mesh)
    # and build -> score -> evaluate runs sharded over it
    data = RecommenderData(events.copy(), "userid", "movieid", "rating",
                           seed=0, verbose=False)
    data.warm_start = False
    data.holdout_size = 2
    data.prepare()
    with use_mesh(mesh):
        svd = SVDModel(data, device=entries[0])
        svd.verbose = False
        svd.rank = 16
        print(f"mesh-built SVD relevance: {svd.evaluate('relevance')}")

    # the explicit ops, for custom pipelines
    idx = events[["userid", "movieid"]].values
    val = events["rating"].values.astype(float)
    dense = dense_from_coo(idx, val, (512, 200), device=entries[0])

    # row-sharded randomized SVD: Gram sums over the mesh
    result = distributed_randomized_svd(dense, k=16, mesh=mesh, n_iter=6)
    print(f"rSVD factors: u{tuple(result.u.shape)} s{tuple(result.s.shape)} "
          f"v{tuple(result.v.shape)}; top sigma {float(result.s[0]):.2f}")

    # row-sharded confidence-weighted ALS
    factors = distributed_ials(dense, rank=8, mesh=mesh, num_epochs=4)
    print(f"iALS factors: user{tuple(factors.user.shape)} "
          f"item{tuple(factors.item.shape)}")

    # event-sharded HOOI (tensor mode)
    fb_levels = events["rating"].values.astype(int) - 1
    tensor_idx = np.column_stack([idx, fb_levels])
    hooi_result = distributed_hooi(tensor_idx, np.ones(len(val)),
                                   (512, 200, 5), (8, 6, 2), mesh,
                                   num_iters=4, growth_tol=0.0)
    print(f"HOOI core: {tuple(hooi_result.core.shape)}, "
          f"{len(hooi_result.growth_history)} sweeps")


if __name__ == "__main__":
    main()
