"""Fleet layer of the port: continuous batching and the decode serving
front (router, remote replicas and the autoscaler come later)."""

from .batching import BatchPolicy

__all__ = ["BatchPolicy"]
