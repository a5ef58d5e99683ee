"""Stateless preprocessing utilities (counterpart of
:mod:`polara_tpu.preprocessing`; ``dataframes`` and ``matrices`` are not
ported yet).  ``features`` needs pandas and scipy."""
from polara_tpu_torch.preprocessing import features

__all__ = ["features"]
