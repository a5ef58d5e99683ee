"""Stateless preprocessing utilities (counterpart of
:mod:`polara_tpu.preprocessing`): frame-level splits and samplers
(``dataframes``), CSR-level splits, samplers and the EigenRec rescaling
(``matrices``), and the feature encoders (``features``, which needs
pandas and scipy)."""
from polara_tpu_torch.preprocessing import dataframes, features, matrices

__all__ = ["dataframes", "features", "matrices"]
