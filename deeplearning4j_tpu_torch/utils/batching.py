"""K-step batch grouping for the fused fit loops.

Counterpart of ``deeplearning4j_tpu/utils/batching.py``: one state machine
for ``MultiLayerNetwork.fit_iterator`` and ``ComputationGraph.fit_iterator``
that gathers up to ``k`` same-shape batches into a group for one K-step
dispatch, and routes the batches the caller declines (masked ones) to its
single-step path. A change of shape (the ragged last batch of an epoch)
flushes the pending group first, so a group always stacks.
"""
from __future__ import annotations

from typing import Callable, Iterable, Iterator, Tuple


def _leaves(batch) -> list:
    if isinstance(batch, (list, tuple)):
        return [leaf for b in batch for leaf in _leaves(b)]
    return [batch]


def _shape_key(batch) -> list:
    """The shapes of a batch's arrays (numpy arrays or tensors), in order."""
    return [tuple(a.shape) for a in _leaves(batch)]


def k_step_groups(iterator: Iterable, k: int,
                  to_batch: Callable) -> Iterator[Tuple[str, object]]:
    """Yield ``("group", [batch, ...])`` (1 <= len <= k, identical shapes) or
    ``("single", ds)`` for the datasets ``to_batch`` declines.

    ``to_batch(ds)`` returns the dataset's arrays (nested lists or tuples of
    host arrays) to include it in a group, or None to send it to the
    caller's single-step path. A declined dataset or a shape change flushes
    the pending group first."""
    pending: list = []
    for ds in iterator:
        batch = to_batch(ds)
        if batch is None:
            if pending:
                yield "group", pending
                pending = []
            yield "single", ds
            continue
        if pending and _shape_key(batch) != _shape_key(pending[-1]):
            yield "group", pending
            pending = []
        pending.append(batch)
        if len(pending) == k:
            yield "group", pending
            pending = []
    if pending:
        yield "group", pending
