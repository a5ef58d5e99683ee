"""Alias of :mod:`polara_tpu_torch.models` matching the reference import
path."""
from polara_tpu_torch.models import *                    # noqa: F401,F403
from polara_tpu_torch.models import __all__              # noqa: F401
from polara_tpu_torch.models.baselines import NonPersonalized  # noqa: F401
