"""Utilities of the port (``gpquad/utils``): dataset loaders, profiling
scopes, checkpoints, float64 oracles.

The loaders are exported as gpquad's are, but imported on first use, so
that the ops layer, which opens ``utils.profiling``'s scopes, does not load
the loaders (and the models they draw from) with it."""
import importlib

__all__ = [
    "data_dir", "load_co2", "load_era5", "load_oisst", "load_oisst_grid",
    "load_prism", "load_prism_dataset", "load_roads", "load_synthetic_gp",
    "load_taxi",
]


def __getattr__(name):
    if name in __all__:
        return getattr(importlib.import_module(".loaders", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
