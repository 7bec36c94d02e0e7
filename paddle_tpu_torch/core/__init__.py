"""Core utilities: errors, dtypes, places, the profiler's spans."""
from . import config, dtypes, errors, place, profiler, unique_name
from .errors import EnforceError, NotFoundError, ShapeError, enforce
from .place import CPUPlace, CUDAPlace, Place, TPUPlace, default_place, device_count

__all__ = [
    "config", "dtypes", "errors", "place", "profiler", "unique_name",
    "EnforceError", "NotFoundError", "ShapeError", "enforce",
    "CPUPlace", "CUDAPlace", "Place", "TPUPlace", "default_place", "device_count",
]
