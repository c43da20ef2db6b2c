"""Expert parallelism: the GShard all_to_all MoE dispatch over a mesh axis.

Counterpart of ``deeplearning4j_tpu/parallel/moe.py``. Tokens are split over
the expert axis (it doubles as a data axis, the standard EP layout) and so
are the experts: rank ``r`` of the axis runs experts ``r·E/n ..
(r+1)·E/n``. Each rank routes its own tokens, packs them into per-expert
buffers of ``capacity`` slots, exchanges the buffers with
``all_to_all_single`` so that every rank holds the tokens bound for its
experts from every rank, runs its experts' FFNs, exchanges the results
back and combines them with the gates. It equals the dense ``MoELayer``
math wherever no expert overflows its capacity; a token past its expert's
capacity is dropped (its output is 0), as in GShard and Switch.

A token's slot is the running count of the tokens before it (in this
rank's flattened ``[Bl·T]`` order) routed to the same expert, counted in
integers; JAX counts in float32 so that a bf16 policy cannot merge slots,
and both are exact at these sizes, so the same tokens drop. The packing
and the combine are an ``index_add`` into the buffers and an
``index_select`` out of them where JAX contracts one-hot tensors: each
buffer slot receives at most one token, so both give the token's values
bitwise.

In the port each rank's parameters are whole (data parallelism), and the
rank's forward reads its experts' slices of ``W1``/``b1``/``W2``/``b2``.
The backward of the exchange carries every rank's output gradient to the
expert's rank, so an expert's gradient is formed there from all the tokens
it served (zero on the other ranks); the data-parallel step's average over
the ranks then gives each expert the global gradient.

The Switch balance term is this rank's share ``E · Σ_e f_e · P_e`` with
``f_e`` the routed share over the expert and sequence axes (all-reduced)
and ``P_e`` this rank's mean router probability: its mean over the ranks
is JAX's term (the ``pmean`` of both), and so is its gradient.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch
import torch.distributed as dist

from .compile_seam import count_collective
from .mesh import Mesh
from .ring_attention import _AllToAll, _per_step

_lock = threading.Lock()
_tokens = 0
#: tokens dropped past their expert's capacity, a device counter by device
#: (read at :func:`stats`, so the step never waits on it)
_dropped: dict = {}


def _note(tokens: int, dropped: torch.Tensor) -> None:
    global _tokens
    with _lock:
        _tokens += tokens
        at = _dropped.get(dropped.device)
        _dropped[dropped.device] = (dropped.detach() if at is None
                                    else at + dropped.detach())


def stats() -> dict:
    """``{"tokens": n, "dropped": n}``: the tokens this process dispatched
    and those that found their expert's buffer full, since the last
    :func:`reset_stats` (the JAX package has no series for them; the dropped
    count is read from the card here, never in the step). The dispatch's
    bytes are the ``dl4j_collective_bytes_per_step`` series."""
    with _lock:
        return {"tokens": _tokens,
                "dropped": int(sum(int(t) for t in _dropped.values()))}


def reset_stats() -> None:
    global _tokens
    with _lock:
        _tokens = 0
        _dropped.clear()


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _AllToAll.apply(x, group)


def _mean_over(t: torch.Tensor, group, n: int) -> torch.Tensor:
    if group is None:
        return t
    t = t.clone()
    dist.all_reduce(t, group=group)
    return t / n


def _moe_local(layer, params: dict, x: torch.Tensor, *, group, n: int,
               index: int, capacity: int, train: bool, gen, mean_group,
               n_mean: int):
    """This rank's tokens ``x [Bl, T, F]`` through the dispatch: ``(y
    without the layer's activation, this rank's aux share)``; a token past
    its expert's ``capacity`` gets 0."""
    E = layer.n_experts
    El = E // n
    Bl, T, F = x.shape
    S = Bl * T
    x2d = x.reshape(S, F)
    eidx, gate, probs = layer.route(params, x2d, train, gen)
    sel = layer._one_hot(eidx, torch.float32)                  # [S, E]
    frac = _mean_over(sel.mean(dim=0), mean_group, n_mean)
    aux = E * torch.sum(frac * probs.to(torch.float32).mean(dim=0))
    # a token's slot: the tokens before it routed to its expert
    pos = (torch.cumsum(sel.to(torch.int64), dim=0) - 1).gather(
        1, eidx[:, None])[:, 0]
    keep = pos < capacity
    _note(S, S - keep.sum())
    # slot index in the [E * C] buffers; a dropped token goes to one spare
    # row past the end, which nothing reads
    dest = torch.where(keep, eidx * capacity + pos,
                       torch.full_like(pos, E * capacity))
    buf = x2d.new_zeros(E * capacity + 1, F).index_add(0, dest, x2d)
    buf = buf[:E * capacity].reshape(n, El, capacity, F)
    buf = _exchange(buf, group)                                 # [n, El, C, F]
    lo = index * El
    mine = {k: params[k][lo:lo + El] for k in ("W1", "b1", "W2", "b2")}
    out = layer.expert_ffn(mine, buf.transpose(0, 1).reshape(
        El, n * capacity, F))                                   # [El, nC, F]
    out = out.reshape(El, n, capacity, F).transpose(0, 1).contiguous()
    out = _exchange(out, group).reshape(E * capacity, F)
    out = torch.cat([out, out.new_zeros(1, F)])
    y = out.index_select(0, dest) * gate[:, None].to(out.dtype)
    # two all_to_alls of every rank's [n, El, C, F] buffer, from its shape
    # (the device's dropped count is never read here)
    nbytes = 2 * buf.numel() * buf.element_size()
    _per_step("all_to_all", "moe_dispatch").set(n * nbytes)
    if group is not None:
        count_collective("all_to_all", "moe_dispatch", nbytes)
    return y.to(x2d.dtype).reshape(Bl, T, F), aux


def expert_parallel_ffn(layer, params: dict, x: torch.Tensor, mesh: Mesh,
                        axis_name: str, capacity_factor: float = 2.0,
                        train: bool = False, gen=None,
                        seq_axis: Optional[str] = None):
    """The dispatch a MoE layer runs when a ``ParallelContext`` declares an
    expert axis. ``x`` is this rank's tokens ``[Bl, T, F]`` (or ``[Bl, F]``,
    read as T = 1): its rows of the batch split over ``axis_name`` and,
    with ``seq_axis``, its block of the time axis. Returns ``(y, aux)``, y
    without the layer's activation (the caller applies it where the dense
    path does) and aux this rank's share of the balance term. An expert's
    buffer has ``max(1, int(cf · (B/n) · (T/n_seq) / E))`` slots, JAX's
    capacity from this rank's ``Bl = B/n`` rows and ``T = T/n_seq``
    steps."""
    n = mesh.shape[axis_name]
    if layer.n_experts % n:
        raise ValueError(f"{layer.n_experts} experts not divisible by "
                         f"mesh axis size {n}")
    squeeze = x.ndim == 2
    if squeeze:
        x = x[:, None, :]
    Bl, T, _ = x.shape
    if seq_axis == axis_name:
        seq_axis = None
    mean_axes = (axis_name,) + ((seq_axis,) if seq_axis else ())
    capacity = max(1, int(capacity_factor * Bl * T / layer.n_experts))
    y, aux = _moe_local(
        layer, params, x, group=mesh.group(axis_name), n=n,
        index=mesh.coords[axis_name], capacity=capacity, train=train,
        gen=gen, mean_group=mesh.group(*mean_axes),
        n_mean=mesh.axis_size(*mean_axes))
    if squeeze:
        y = y[:, 0, :]
    return y, aux


class _GatherRows(torch.autograd.Function):
    """Every rank's rows of ``[Bl, ...]`` concatenated in rank order; the
    backward keeps this rank's rows of the gradient (the ranks compute the
    same function of the gathered tensor)."""

    @staticmethod
    def forward(ctx, x, group, n: int, index: int):
        ctx.n, ctx.index = n, index
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n)[ctx.index], None, None, None


class ExpertParallelMoE:
    """Run a ``MoELayer``'s parameters expert-parallel over ``axis_name``:
    ``__call__(params, x)`` takes the whole batch ``[B, T, F]`` on every
    rank, dispatches this rank's rows and returns the whole output."""

    def __init__(self, layer, mesh: Mesh, axis_name: str = "expert",
                 capacity_factor: float = 2.0):
        self.layer = layer
        self.mesh = mesh
        self.axis_name = axis_name
        self.capacity_factor = capacity_factor
        n = mesh.shape[axis_name]
        if layer.n_experts % n:
            raise ValueError(f"{layer.n_experts} experts not divisible by "
                             f"mesh axis size {n}")

    def __call__(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        mesh, axis = self.mesh, self.axis_name
        n, index = mesh.shape[axis], mesh.coords[axis]
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} not divisible by expert "
                             f"axis size {n}")
        mine = x.chunk(n)[index]
        y, _ = expert_parallel_ffn(self.layer, params, mine, mesh, axis,
                                   self.capacity_factor)
        # the dense MoELayer's epilogue: the activation after the combine
        y = self.layer.act_fn()(y)
        group = mesh.group(axis)
        return y if group is None else _GatherRows.apply(y, group, n, index)
