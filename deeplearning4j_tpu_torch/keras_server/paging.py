"""The decode memory plane: a refcounted physical page pool for KV state.

Counterpart of ``deeplearning4j_tpu/keras_server/paging.py``. The device
holds one fixed physical pool ``[n_pages + 1, page_size, H, D]`` per
transformer layer and each slot owns a page-table row of physical page ids;
a slot consumes pages only for tokens it has written.

Page 0 is the **trash page**: never allocated, never mapped by a live slot,
the scatter target for writes that must not land (inactive slots, parked
slots, positions past the context ceiling). Its contents are garbage that
the ``j <= position`` attention mask never selects.

Completed prompt pages are published in a prefix registry keyed by the
exact token prefix they cover; a session with a matching prompt maps the
same pages and bumps their refcount. A write into a page with refcount > 1
forks it first, so sharers never see each other's writes. Refcount 0 frees
the page and drops its registry keys.

The pool is host bookkeeping; the engine owns the device tensors and holds
its lock around every call.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch

#: physical page 0, the scatter target for suppressed writes
TRASH_PAGE = 0


class PagePool:
    """Host-side allocator for one engine's physical page pool: the free
    list, per-page refcounts and the prompt-prefix registry."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1:
            raise ValueError("page pool needs at least one page")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        # LIFO free list: a just-freed page is reused first
        self._free: List[int] = list(range(self.n_pages, 0, -1))
        self._ref: Dict[int, int] = {}
        self._prefix: Dict[Tuple[int, ...], int] = {}
        self._keys: Dict[int, Set[Tuple[int, ...]]] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.n_pages - len(self._free)

    def alloc(self) -> Optional[int]:
        """One exclusively owned page, or ``None`` when the pool is empty."""
        if not self._free:
            return None
        pid = self._free.pop()
        self._ref[pid] = 1
        return pid

    def incref(self, pid: int) -> None:
        self._ref[pid] += 1

    def refcount(self, pid: int) -> int:
        return self._ref.get(pid, 0)

    def decref(self, pid: int) -> bool:
        """Drop one reference; True when this freed the page (and its
        prefix-registry keys)."""
        n = self._ref[pid] - 1
        if n > 0:
            self._ref[pid] = n
            return False
        del self._ref[pid]
        for key in self._keys.pop(pid, ()):
            if self._prefix.get(key) == pid:
                del self._prefix[key]
        self._free.append(pid)
        return True

    def register(self, prefix: Sequence[int], pid: int) -> None:
        """Publish ``pid`` as holding the KV rows of exactly the prompt
        ``prefix``. First writer wins: KV at position j is a function of
        tokens[0..j] alone, so an equal prefix is an equivalent page."""
        key = tuple(int(t) for t in prefix)
        if key in self._prefix:
            return
        self._prefix[key] = pid
        self._keys.setdefault(pid, set()).add(key)

    def match_prompt(self, prompt: Sequence[int]) -> Tuple[List[int], int]:
        """Longest registered prefix of ``prompt``: full pages first, then the
        longest partial tail inside the next page. Returns the page chain and
        the prompt tokens it covers; refcounts are not touched."""
        ps = self.page_size
        prompt = [int(t) for t in prompt]
        pids: List[int] = []
        covered = 0
        for k in range(len(prompt) // ps):
            pid = self._prefix.get(tuple(prompt[:(k + 1) * ps]))
            if pid is None:
                break
            pids.append(pid)
            covered = (k + 1) * ps
        tail: Optional[Tuple[int, int]] = None
        for m in range(covered + 1, min(len(prompt), covered + ps) + 1):
            pid = self._prefix.get(tuple(prompt[:m]))
            if pid is not None:
                tail = (pid, m)
        if tail is not None:
            pids.append(tail[0])
            covered = tail[1]
        return pids, covered

    @property
    def prefix_entries(self) -> int:
        return len(self._prefix)


# KV pools are always float32, as in the JAX package.

def alloc_dense_kv(cap: int, max_context: int, n_heads: int, head_dim: int,
                   device: torch.device):
    """One dense per-slot KV block ``[cap, max_context, H, D]`` (k and v),
    the paged layout's bitwise oracle."""
    shape = (cap, max_context, n_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=torch.float32, device=device),
            "v": torch.zeros(shape, dtype=torch.float32, device=device)}


def alloc_page_pool(n_pages: int, page_size: int, n_heads: int,
                    head_dim: int, device: torch.device):
    """One physical page pool ``[n_pages + 1, page_size, H, D]`` (k and v);
    row 0 is the trash page. Allocated once per engine."""
    shape = (n_pages + 1, page_size, n_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=torch.float32, device=device),
            "v": torch.zeros(shape, dtype=torch.float32, device=device)}
