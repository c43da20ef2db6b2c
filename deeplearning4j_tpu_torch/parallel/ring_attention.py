"""Long-context attention over a sequence axis: ring and Ulysses.

Counterpart of ``deeplearning4j_tpu/parallel/ring_attention.py``. The time
axis of q, k and v (``[B, T, H, D]``) is split over the ranks of a mesh
axis, each rank holding ``T / N`` consecutive positions:

* ring attention keeps its queries and passes the K/V blocks round the ring
  (``batch_isend_irecv`` to the next rank, from the previous one), adding
  each block to an online softmax as the JAX ``_online_block`` does, in
  plain PyTorch as the JAX package computes it in ``jnp``; the causal mask
  uses the blocks' global offsets. The rotation is an ``autograd.Function``
  whose backward sends the cotangent the other way round.
* Ulysses swaps the sequence split for a head split with one
  ``all_to_all_single`` for each of q, k and v, runs the port's flash
  attention (``flash_fwd`` forward, ``flash_bwd_dq``/``flash_bwd_dkv``
  backward on the card) on the whole sequence and ``H / N`` heads, and
  swaps back. The heads must divide the axis.

The ``_sharded`` entry points take and return this rank's blocks, as a
layer calls them in a step (:func:`~..nn.conf.layers.attention.attend`);
the others take the whole arrays on every rank and return the whole output,
differentiably (the split's backward gathers, the gather's backward takes
this rank's block). Every ``autograd.Function`` keeps its process group in
``ctx``: autograd runs the backward on a thread of its own.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import Mesh

NEG = -1e30


def attention_reference(q, k, v, causal: bool = False) -> torch.Tensor:
    """Plain softmax attention over the whole sequence (the oracle):
    ``[B, T, H, D]`` in and out."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        mask = (torch.arange(tq, device=q.device)[:, None]
                >= torch.arange(tk, device=q.device)[None, :])
        s = torch.where(mask, s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _online_block(q, k, v, m_prev, l_prev, o_prev, q_off: int, kv_off: int,
                  causal: bool):
    """One online-softmax step against a K/V block (JAX ``_online_block``):
    q ``[B, Tq, H, D]``, k/v ``[B, Tk, H, D]``, m/l ``[B, H, Tq]``, o like q."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        q_pos = q_off + torch.arange(tq, device=q.device)
        kv_pos = kv_off + torch.arange(tk, device=q.device)
        mask = q_pos[:, None] >= kv_pos[None, :]
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG))
    m_blk = s.amax(dim=-1)
    m_new = torch.maximum(m_prev, m_blk)
    p = torch.exp(s - m_new[..., None])
    # a fully masked block adds exactly nothing
    p = torch.where(s <= NEG, torch.zeros_like(p), p)
    scale = torch.exp(m_prev - m_new)
    l_new = l_prev * scale + p.sum(dim=-1)
    o_scaled = o_prev * scale.permute(0, 2, 1)[..., None]
    o_new = o_scaled + torch.einsum("bhqk,bkhd->bqhd", p, v)
    return m_new, l_new, o_new


def _exchange(tensors, group, send_to: int, recv_from: int) -> list:
    """Send ``tensors`` to global rank ``send_to`` and receive tensors of
    the same shapes from ``recv_from``, in one ``batch_isend_irecv``."""
    got = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
           for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), send_to, group)
           for t in tensors]
    ops += [dist.P2POp(dist.irecv, g, recv_from, group) for g in got]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got


class _RingShift(torch.autograd.Function):
    """K and V passed one rank on round the ring; the backward passes
    their cotangents one rank back."""

    @staticmethod
    def forward(ctx, k, v, group, send_to: int, recv_from: int):
        ctx.group, ctx.send_to, ctx.recv_from = group, send_to, recv_from
        return tuple(_exchange([k, v], group, send_to, recv_from))

    @staticmethod
    def backward(ctx, dk, dv):
        dk, dv = _exchange([dk, dv], ctx.group, ctx.recv_from, ctx.send_to)
        return dk, dv, None, None, None


def _axis(mesh: Mesh, axis_name: str):
    """``(group, size, this rank's index)`` of a mesh axis."""
    return mesh.group(axis_name), mesh.shape[axis_name], mesh.coords[axis_name]


def ring_attention_sharded(q, k, v, mesh: Mesh, axis_name: str = "sp",
                           causal: bool = False,
                           batch_axis: Optional[str] = None) -> torch.Tensor:
    """Ring attention on this rank's blocks ``[B, T/N, H, D]`` (rank ``i``
    holds positions ``i T/N`` on); returns its output block. ``batch_axis``
    is the JAX signature's: a rank's rows are its own already."""
    group, n, idx = _axis(mesh, axis_name)
    B, Tq, H, _ = q.shape
    Tk = k.shape[1]
    m = torch.full((B, H, Tq), NEG, dtype=q.dtype, device=q.device)
    l = torch.zeros((B, H, Tq), dtype=q.dtype, device=q.device)
    o = torch.zeros_like(q)
    send_to = mesh.global_rank(axis_name, (idx + 1) % n)
    recv_from = mesh.global_rank(axis_name, (idx - 1) % n)
    k_cur, v_cur = k, v
    for step in range(n):
        # the block held now came from rank (idx - step) % n
        src = (idx - step) % n
        m, l, o = _online_block(q, k_cur, v_cur, m, l, o, idx * Tq, src * Tk,
                                causal)
        if step < n - 1:
            k_cur, v_cur = _RingShift.apply(k_cur, v_cur, group, send_to,
                                            recv_from)
    return o / torch.clamp_min(l.permute(0, 2, 1)[..., None], 1e-20)


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of ``[N, ...]``: block ``j`` goes to the
    group's rank ``j``, block ``i`` of the result came from rank ``i``. The
    adjoint is the same exchange."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty(g.shape, dtype=g.dtype, device=g.device)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


def _swap(x, group):
    return x if group is None else _AllToAll.apply(x, group)


def ulysses_attention_sharded(q, k, v, mesh: Mesh, axis_name: str = "sp",
                              causal: bool = False,
                              batch_axis: Optional[str] = None
                              ) -> torch.Tensor:
    """Ulysses attention on this rank's blocks ``[B, T/N, H, D]``: the
    sequence split swapped for a head split (``H % N == 0``), the flash
    kernels on ``[B, T, H/N, D]``, swapped back. Returns the output
    block."""
    from ..ops.flash_attention import flash_attention

    group, n, _ = _axis(mesh, axis_name)
    B, Tl, H, D = q.shape
    if H % n:
        raise ValueError(f"num heads {H} not divisible by axis size {n}")
    h = H // n

    def seq_to_heads(x):
        # [B, Tl, H, D] -> [n (head group, sent to its rank), B, Tl, h, D]
        x = x.reshape(B, Tl, n, h, D).permute(2, 0, 1, 3, 4).contiguous()
        # -> [n (sequence block, from its rank), B, Tl, h, D] -> [B, T, h, D]
        return _swap(x, group).permute(1, 0, 2, 3, 4).reshape(B, n * Tl, h, D)

    og = flash_attention(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v),
                         causal)[0]
    # [B, T, h, D] -> [n (sequence block, sent to its rank), B, Tl, h, D]
    og = og.reshape(B, n, Tl, h, D).permute(1, 0, 2, 3, 4).contiguous()
    # -> [n (head group, from its rank), B, Tl, h, D] -> [B, Tl, H, D]
    return _swap(og, group).permute(1, 2, 0, 3, 4).reshape(B, Tl, H, D)


class _SplitSeq(torch.autograd.Function):
    """This rank's block of a whole array along the time axis; the
    backward gathers every rank's block gradient (the array is the same on
    every rank)."""

    @staticmethod
    def forward(ctx, x, group, n: int, idx: int):
        ctx.group, ctx.n = group, n
        return x.chunk(n, dim=1)[idx].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_seq(g, ctx.group, ctx.n), None, None, None


class _GatherSeq(torch.autograd.Function):
    """The whole array from every rank's block along the time axis; the
    backward takes this rank's block (what follows runs the same on every
    rank)."""

    @staticmethod
    def forward(ctx, x, group, n: int, idx: int):
        ctx.n, ctx.idx = n, idx
        return _gather_seq(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, dim=1)[ctx.idx].contiguous(), None, None, None


def _gather_seq(x, group, n: int) -> torch.Tensor:
    if group is None:
        return x
    x = x.movedim(1, 0).contiguous()
    buf = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(buf, x, group=group)
    return buf.movedim(0, 1)


def _whole(sharded_fn, q, k, v, mesh, axis_name, causal):
    group, n, idx = _axis(mesh, axis_name)
    if q.shape[1] % n:
        raise ValueError(f"sequence length {q.shape[1]} is not divisible by "
                         f"the {axis_name!r} axis size {n}")
    blocks = [_SplitSeq.apply(t, group, n, idx) for t in (q, k, v)]
    out = sharded_fn(*blocks, mesh, axis_name, causal)
    return _GatherSeq.apply(out, group, n, idx)


def ring_attention(q, k, v, mesh: Mesh, axis_name: str = "sp",
                   causal: bool = False) -> torch.Tensor:
    """Exact ring attention of whole ``[B, T, H, D]`` arrays (the same on
    every rank), the time axis split over ``axis_name``; the whole output
    on every rank."""
    return _whole(ring_attention_sharded, q, k, v, mesh, axis_name, causal)


def ulysses_attention(q, k, v, mesh: Mesh, axis_name: str = "sp",
                      causal: bool = False) -> torch.Tensor:
    """Ulysses attention of whole ``[B, T, H, D]`` arrays (the same on
    every rank); the heads must divide the axis. The whole output on every
    rank."""
    n = mesh.shape[axis_name]
    if q.shape[2] % n:
        raise ValueError(f"num heads {q.shape[2]} not divisible by axis "
                         f"size {n}")
    return _whole(ulysses_attention_sharded, q, k, v, mesh, axis_name, causal)
