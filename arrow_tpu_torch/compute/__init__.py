"""Operator tier (ported so far: filter and the sort route of hash aggregate)."""

from .filter import filter, filter_count, filter_indices
from .hash_aggregate import hash_aggregate

__all__ = ["filter", "filter_count", "filter_indices", "hash_aggregate"]
