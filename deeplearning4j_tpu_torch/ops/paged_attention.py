"""Page-table gather for the paged decode plane.

Counterpart of ``deeplearning4j_tpu/ops/paged_attention.py``. The paged
decode step keeps KV in a physical page pool ``[n_pages + 1, page_size, H,
D]`` and resolves each slot's logical ``[P * page_size, H, D]`` view through
its page-table row. On CUDA tensors :func:`paged_gather` launches
``csrc/paged_gather.cu``; on CPU tensors it runs the plain version. Both are
pure data movement over the same indices, so they are bitwise equal.
"""
from __future__ import annotations

import torch

from . import _cuda


def paged_gather_plain(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The plain version: one ``index_select`` along the page axis."""
    _, ps, H, D = pool.shape
    cap, P = table.shape
    return pool.index_select(0, table.reshape(-1).to(torch.long)).view(
        cap, P * ps, H, D)


_ARGS = [_cuda.PTR, _cuda.PTR, _cuda.PTR, _cuda.INT, _cuda.INT,
         _cuda.LONG, _cuda.PTR]


@_cuda.counted
def paged_gather(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Materialize the logical KV view ``[cap, P * page_size, H, D]`` of
    ``pool [n_pages + 1, page_size, H, D]`` through ``table [cap, P]`` (int32
    physical page ids). Rows gathered from the trash page are garbage that
    the caller's attention mask never selects."""
    if pool.ndim != 4 or table.ndim != 2:
        raise ValueError(f"paged_gather needs pool [n,ps,H,D] and table "
                         f"[cap,P]; got {tuple(pool.shape)}, {tuple(table.shape)}")
    if table.dtype != torch.int32:
        raise TypeError(f"paged_gather needs an int32 table, got {table.dtype}")
    if pool.device != table.device:
        raise ValueError("paged_gather operands must share one device")
    if pool.device.type == "cpu":
        return paged_gather_plain(pool, table)
    if pool.device.type != "cuda":
        raise ValueError(f"paged_gather: unsupported device {pool.device}")
    if not (pool.is_contiguous() and table.is_contiguous()):
        raise ValueError("paged_gather needs contiguous operands")
    n_total, ps, H, D = pool.shape
    cap, P = table.shape
    out = torch.empty((cap, P * ps, H, D), dtype=pool.dtype, device=pool.device)
    if out.numel() == 0:
        return out
    fn = _cuda.function("paged_gather", "paged_gather", _ARGS)
    rc = fn(pool.data_ptr(), table.data_ptr(), out.data_ptr(), n_total,
            cap * P, ps * H * D * pool.element_size(), _cuda.stream_handle())
    _cuda.check(rc, "paged_gather", "paged_gather launch")
    _cuda.count(paged_gather)
    return out
