"""Training and scoring over a device mesh (counterpart of
:mod:`polara_tpu.parallel`: the SVD family, iALS, BPR, HOOI and the
event-sharded streaming tier)."""
from polara_tpu_torch.parallel.distributed import (cholesky_qr2,
                                                   distributed_bpr,
                                                   distributed_chunked_rsvd,
                                                   distributed_hooi,
                                                   distributed_ials,
                                                   distributed_ials_events,
                                                   distributed_randomized_svd,
                                                   full_train_step,
                                                   score_mask_topk_step,
                                                   sharded_score_topk_2d)
from polara_tpu_torch.runtime.mesh import (get_default_mesh, make_mesh,
                                           set_default_mesh, shard_rows,
                                           use_mesh, user_sharding)

__all__ = ["cholesky_qr2", "distributed_randomized_svd",
           "distributed_ials", "distributed_bpr", "distributed_hooi",
           "distributed_chunked_rsvd", "distributed_ials_events",
           "score_mask_topk_step", "sharded_score_topk_2d",
           "full_train_step",
           "make_mesh", "user_sharding", "shard_rows",
           "set_default_mesh", "get_default_mesh", "use_mesh"]
