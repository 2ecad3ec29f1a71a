"""Serving runtime: the continuous-batching scheduler around the decode paths."""
from .scheduler import BatchScheduler, Request

__all__ = ["BatchScheduler", "Request"]
