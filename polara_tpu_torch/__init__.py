"""polara_tpu_torch: the PyTorch/CUDA port of polara_tpu.

Mirrors the JAX package's module layout and names.  The device tier
(``ops``, ``models``, ``evaluation``, ``runtime``, ``datasets``) imports
torch and numpy only (the dataset loaders import pandas when called); the
pandas data tier (``data``) loads on first use of
:class:`RecommenderData`, so importing this package loads neither pandas
nor jax.
"""

__version__ = "0.1.0"

_LAZY = {
    "RecommenderData": "polara_tpu_torch.data",
    "RecommenderModel": "polara_tpu_torch.models",
    "SVDModel": "polara_tpu_torch.models",
    "ScaledSVD": "polara_tpu_torch.models",
    "PopularityModel": "polara_tpu_torch.models",
    "RandomModel": "polara_tpu_torch.models",
    "CooccurrenceModel": "polara_tpu_torch.models",
    "get_movielens_data": "polara_tpu_torch.datasets",
    "get_netflix_data": "polara_tpu_torch.datasets",
    "get_bookcrossing_data": "polara_tpu_torch.datasets",
    "get_amazon_data": "polara_tpu_torch.datasets",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(module), name)
