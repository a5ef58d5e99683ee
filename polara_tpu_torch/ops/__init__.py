"""Device operators: top-k, sparse/dense matrices, randomized SVD, the
fused score/mask/top-k kernel and the chunked scoring loop."""
