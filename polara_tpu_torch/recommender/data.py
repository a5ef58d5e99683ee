"""Alias of :mod:`polara_tpu_torch.data` matching the reference import
path."""
from polara_tpu_torch.data import *                      # noqa: F401,F403
from polara_tpu_torch.data import __all__                # noqa: F401
from polara_tpu_torch.data.dataset import TestData       # noqa: F401
