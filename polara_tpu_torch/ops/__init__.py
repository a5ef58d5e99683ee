"""Device operators: top-k, sparse/dense matrices, padded rows and
batched inner products, randomized SVD, similarity, exclusion sampling,
the fused score/mask/top-k kernel and the chunked scoring loop."""
from polara_tpu_torch.ops.rsvd import (SvdResult, orthogonalize,
                                       randomized_svd, randomized_svd_krylov)
from polara_tpu_torch.ops.scoring import (ChunkedTestData, TestChunk,
                                          run_scoring)
from polara_tpu_torch.ops.sparse import (CooMatrix, MatmulOperator,
                                         PaddedRows, coo_from_arrays,
                                         dense_from_coo, dense_operator,
                                         inner_product_at, pad_rows)
from polara_tpu_torch.ops.topk import (downvote_items, mask_and_topk,
                                       top_k_indices)

__all__ = ["CooMatrix", "MatmulOperator", "PaddedRows", "coo_from_arrays",
           "dense_from_coo", "dense_operator", "inner_product_at",
           "pad_rows", "randomized_svd",
           "randomized_svd_krylov", "SvdResult", "orthogonalize",
           "mask_and_topk", "top_k_indices", "downvote_items",
           "ChunkedTestData", "TestChunk", "run_scoring"]
