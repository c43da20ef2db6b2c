"""Counting/priority-queue utilities (berkeley-utils equivalents).

Reference: deeplearning4j-nn berkeley/*.java (SURVEY.md §2.1) — legacy
Berkeley NLP `Counter`, `PriorityQueue`, `Pair`, `Triple` used across the
reference. Python's stdlib covers most of this (collections.Counter, heapq,
tuples); this module provides the reference's richer Counter surface
(normalization, argmax, scaling) and a max-priority queue with the Berkeley
API shape, so ported call sites have a one-to-one target.
"""
from __future__ import annotations

import heapq
import itertools
from collections import Counter as _Counter
from typing import Dict, Generic, Iterator, List, Optional, Tuple, TypeVar

K = TypeVar("K")
V = TypeVar("V")


class Counter(Generic[K]):
    """reference berkeley/Counter.java: float-valued counts with
    normalization/argmax/scale."""

    def __init__(self):
        self._c: Dict[K, float] = {}

    def increment_count(self, key: K, amount: float = 1.0) -> None:
        self._c[key] = self._c.get(key, 0.0) + amount

    def set_count(self, key: K, count: float) -> None:
        self._c[key] = count

    def get_count(self, key: K) -> float:
        return self._c.get(key, 0.0)

    def total_count(self) -> float:
        return sum(self._c.values())

    def argmax(self) -> Optional[K]:
        return max(self._c, key=self._c.get) if self._c else None

    def max_count(self) -> float:
        return max(self._c.values()) if self._c else 0.0

    def normalize(self) -> None:
        total = self.total_count()
        if total:
            for k in self._c:
                self._c[k] /= total

    def scale(self, factor: float) -> None:
        for k in self._c:
            self._c[k] *= factor

    def remove_key(self, key: K) -> None:
        self._c.pop(key, None)

    def key_set(self) -> List[K]:
        return list(self._c)

    def is_empty(self) -> bool:
        return not self._c

    def __len__(self) -> int:
        return len(self._c)

    def __iter__(self) -> Iterator[K]:
        return iter(self._c)

    def items(self):
        return self._c.items()

    def to_collections_counter(self) -> _Counter:
        return _Counter(self._c)


class PriorityQueue(Generic[V]):
    """reference berkeley/PriorityQueue.java: MAX-priority queue with
    iterator-style next()/peek() (heapq is a min-heap; priorities negate)."""

    def __init__(self):
        self._heap: List[Tuple[float, int, V]] = []
        self._tie = itertools.count()

    def put(self, item: V, priority: float) -> None:
        heapq.heappush(self._heap, (-priority, next(self._tie), item))

    # Berkeley API name
    add = put

    def next(self) -> V:
        return heapq.heappop(self._heap)[2]

    def peek(self) -> V:
        return self._heap[0][2]

    def get_priority(self) -> float:
        return -self._heap[0][0]

    def has_next(self) -> bool:
        return bool(self._heap)

    def is_empty(self) -> bool:
        return not self._heap

    def __len__(self) -> int:
        return len(self._heap)

    def __iter__(self) -> Iterator[V]:
        while self.has_next():
            yield self.next()


def pair(first, second) -> Tuple:
    """reference berkeley/Pair.java — a plain tuple in Python."""
    return (first, second)


def triple(first, second, third) -> Tuple:
    """reference berkeley/Triple.java."""
    return (first, second, third)
