"""Operator tier (ported so far: filter, the sort and merge routes of hash
aggregate, sort and join)."""

from .filter import filter, filter_count, filter_indices
from .hash_aggregate import hash_aggregate
from .join import hash_join, join_indices
from .sort import argsort, lex_sort, sort, sort_by_key

__all__ = [
    "argsort", "filter", "filter_count", "filter_indices", "hash_aggregate", "hash_join",
    "join_indices", "lex_sort", "sort", "sort_by_key",
]
