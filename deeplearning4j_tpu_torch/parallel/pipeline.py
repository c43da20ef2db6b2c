"""Pipeline parallelism: the GPipe schedule over the ``stage`` axis.

Counterpart of ``deeplearning4j_tpu/parallel/pipeline.py``. A stack of
homogeneous blocks is cut into ``S`` stages of ``n_blocks / S`` blocks, one
stage a rank of the mesh's ``stage`` axis, and a batch into ``M``
microbatches. The schedule has ``S + M - 1`` ticks: at tick ``t`` stage
``s`` runs its blocks on microbatch ``t - s`` (stage 0 ingests it from the
input, every other stage takes the activation the stage before sent it at
tick ``t - 1``), then hands its output on to stage ``s + 1``; the last stage
writes microbatch ``t - (S - 1)`` of the output from tick ``S - 1`` on. A
stage idles in its bubble ticks (``t < s`` or ``t >= s + M``) where the JAX
body computes on a placeholder: it launches its blocks ``M`` times a pass,
and the bubble share is ``(S - 1) / (S + M - 1)`` in both packages.

Only the last stage's output is real; the other stages return zeros of its
shape, and nothing gathers the output stack (the JAX executor slices out
the last stage's shard for the same reason).

The schedule is one ``autograd.Function`` (:class:`_GPipe`). Its forward
runs the ticks with each microbatch's graph kept; its backward is the
reverse pipeline: the ticks in reverse order, each stage taking its
output's gradient from the stage after it, running the backward of its
blocks, and handing the input's gradient to the stage before, as autodiff
through the ``ppermute``\\ s makes it in JAX. One function holds the whole
schedule because the handoffs are collectives: every rank must enter them
in the same order, and a handoff node per tick would never run its
backward on a rank that does not use what it received (stage 0, the
bubbles).

The handoff route follows the group's backend and the tensors' device
(:func:`handoff_route`): ``send``/``recv`` pairs (``batch_isend_irecv``),
except for a gloo group on CUDA tensors, where gloo fails
``batch_isend_irecv`` but runs ``all_to_all_single``: there one
``all_to_all_single`` a tick with the split sizes of the pairs that move.
A route that fails raises; nothing falls back to the host or to one rank.
"""
from __future__ import annotations

from collections import Counter
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from .compile_seam import count_collective
from .mesh import Mesh

def stack_block_params(params_list) -> dict:
    """Per-block param dicts (one structure) stacked on a leading stage
    axis: ``[{k: [..]}, ...] -> {k: [S, ..]}``."""
    keys = params_list[0].keys()
    return {k: torch.stack([p[k] for p in params_list]) for k in keys}


def unstack_block_params(stacked: dict) -> list:
    n = next(iter(stacked.values())).shape[0]
    return [{k: v[i] for k, v in stacked.items()} for i in range(n)]


def handoff_route(group, device: torch.device) -> str:
    """``"all_to_all"`` on a gloo group with tensors on ``device`` CUDA,
    ``"p2p"`` on any other group of several ranks, ``"none"`` without a
    group or on a group of one (no stage hands anything on)."""
    if group is None or dist.get_world_size(group) == 1:
        return "none"
    if dist.get_backend(group) == "gloo" and device.type == "cuda":
        return "all_to_all"
    return "p2p"


class _Handoff:
    """Stage ``s`` sends to ``s + step`` and receives from ``s - step`` in
    one exchange over the stage group (``step`` -1 is the reverse)."""

    def __init__(self, pipe: "PipelineParallel"):
        self.pipe = pipe

    def __call__(self, send: Optional[torch.Tensor], recv_like, step: int,
                 site: str, ref: torch.Tensor) -> Optional[torch.Tensor]:
        """``send`` (or None) to stage ``s + step``; a tensor like
        ``recv_like`` (or nothing, when None) from ``s - step``. ``ref``
        gives the device and dtype of an empty exchange."""
        pipe = self.pipe
        s, S = pipe.stage, pipe.n_stages
        dst, src = s + step, s - step
        recv = (torch.empty_like(recv_like) if recv_like is not None
                else None)
        if pipe.route == "p2p":
            ops = []
            if send is not None:
                ops.append(dist.P2POp(dist.isend, send.contiguous(),
                                      pipe.ranks[dst], pipe.group))
            if recv is not None:
                ops.append(dist.P2POp(dist.irecv, recv, pipe.ranks[src],
                                      pipe.group))
            if ops:
                for w in dist.batch_isend_irecv(ops):
                    w.wait()
        else:
            inp = (send.contiguous().reshape(-1) if send is not None
                   else ref.new_empty(0))
            out = (recv.reshape(-1) if recv is not None
                   else ref.new_empty(0))
            in_split = [0] * S
            out_split = [0] * S
            if send is not None:
                in_split[dst] = inp.numel()
            if recv is not None:
                out_split[src] = out.numel()
            dist.all_to_all_single(out, inp, out_split, in_split,
                                   group=pipe.group)
        if send is not None:
            pipe.counts["handoffs"] += 1
            count_collective(pipe.route, site,
                             send.numel() * send.element_size())
        return recv


class _GPipe(torch.autograd.Function):
    """The whole schedule on this rank: ``x`` the batch (read by stage 0),
    ``flat`` this stage's block params; returns the output (real on the
    last stage)."""

    @staticmethod
    def forward(ctx, pipe, names, x, *flat):
        S, M, s = pipe.n_stages, pipe.n_microbatches, pipe.stage
        blocks = pipe._as_blocks(names, flat)
        mb = x.shape[0] // M
        xs = x.reshape(M, mb, *x.shape[1:])
        like = xs[0]
        handoff = _Handoff(pipe)
        saved: List[Optional[tuple]] = [None] * M
        outs: List[Optional[torch.Tensor]] = [None] * M
        recv = None
        for t in range(S + M - 1):
            y = None
            if pipe.active(s, t):
                m = t - s
                src = xs[m] if s == 0 else recv
                x_in = src.detach().requires_grad_(x.requires_grad or s > 0)
                with torch.enable_grad():
                    y = pipe._stage_fn(blocks, x_in)
                if y.shape != like.shape or y.dtype != like.dtype:
                    raise ValueError(
                        f"pipelined blocks must keep the activation's shape "
                        f"and dtype: {tuple(like.shape)} {like.dtype} in, "
                        f"{tuple(y.shape)} {y.dtype} out")
                saved[m] = (x_in, y)
                if s == S - 1:
                    outs[m] = y.detach()
            if S > 1:
                send = y.detach() if (y is not None and s < S - 1) else None
                want = like if (s > 0 and pipe.active(s - 1, t)) else None
                recv = handoff(send, want, 1, "pipeline_forward", like)
        pipe.counts["ticks"] += S + M - 1
        pipe.counts["stage_runs"] += M
        ctx.pipe, ctx.saved, ctx.flat = pipe, saved, flat
        ctx.x_grad = x.requires_grad
        if s == S - 1:
            return torch.cat(outs).reshape(x.shape)
        return torch.zeros_like(x)

    @staticmethod
    def backward(ctx, g_out):
        pipe, saved, flat = ctx.pipe, ctx.saved, ctx.flat
        S, M, s = pipe.n_stages, pipe.n_microbatches, pipe.stage
        handoff = _Handoff(pipe)
        wants = [p.requires_grad for p in flat]
        g_params: List[Optional[torch.Tensor]] = [None] * len(flat)
        g_xs: List[Optional[torch.Tensor]] = [None] * M
        g_ys = (g_out.reshape(M, -1, *g_out.shape[1:])
                if s == S - 1 else None)
        g_recv = None      # the gradient of this tick's output, from s + 1
        g_send = None      # the gradient of the input of tick t + 1
        for t in reversed(range(S + M - 1)):
            if S > 1:
                # the reverse of tick t's handoff
                like = saved[t - s][1] if pipe.active(s, t) else None
                want = like if s < S - 1 else None
                send = g_send if s > 0 and pipe.active(s - 1, t) else None
                g_recv = handoff(send, want, -1, "pipeline_backward",
                                 g_out)
                g_send = None
            if not pipe.active(s, t):
                continue
            m = t - s
            x_in, y = saved[m]
            g_y = g_ys[m] if s == S - 1 else g_recv
            inputs = [x_in] + [p for p, w in zip(flat, wants) if w]
            if not x_in.requires_grad:
                inputs = inputs[1:]
            got = torch.autograd.grad(y, inputs, g_y, allow_unused=True)
            if x_in.requires_grad:
                g_x, got = got[0], got[1:]
                if s == 0:
                    g_xs[m] = g_x
                else:
                    g_send = g_x
            it = iter(got)
            for j, w in enumerate(wants):
                if not w:
                    continue
                g = next(it)
                if g is not None:
                    g_params[j] = g if g_params[j] is None else g_params[j] + g
            saved[m] = None
        g_x = None
        if s == 0 and ctx.x_grad:
            g_x = torch.stack(g_xs).reshape(
                (-1,) + tuple(g_xs[0].shape[1:]))
        return (None, None, g_x, *g_params)


class PipelineParallel:
    """GPipe executor for a stack of homogeneous blocks.

    ``block_fn(params, x) -> y`` applies one block. The stage count is the
    size of the mesh's ``axis_name``; ``n_blocks`` must divide by it, and
    this rank runs the blocks of its stage (``own_blocks``) in order. The
    handoff route (:func:`handoff_route`) is taken from the group and the
    input's device at each :meth:`run`."""

    def __init__(self, mesh: Mesh, block_fn: Callable, n_blocks: int,
                 axis_name: str = "stage", n_microbatches: int = 4):
        self.mesh = mesh
        self.axis_name = axis_name
        self.n_stages = mesh.shape[axis_name]
        if n_blocks % self.n_stages:
            raise ValueError(f"{n_blocks} blocks not divisible by "
                             f"{self.n_stages} stages")
        self.n_blocks = n_blocks
        self.blocks_per_stage = n_blocks // self.n_stages
        self.n_microbatches = n_microbatches
        self.block_fn = block_fn
        self.stage = mesh.coords[axis_name]
        self.group = mesh.group(axis_name)
        #: global rank of each stage, this rank's coordinates elsewhere
        self.ranks = [mesh.global_rank(axis_name, i)
                      for i in range(self.n_stages)]
        #: the handoff route of the last run (None before the first)
        self.route: Optional[str] = None
        self.counts: Counter = Counter()

    @property
    def is_last(self) -> bool:
        return self.stage == self.n_stages - 1

    def own_blocks(self) -> range:
        """Indices (in the stack) of this stage's blocks."""
        b = self.blocks_per_stage
        return range(self.stage * b, (self.stage + 1) * b)

    def active(self, stage: int, tick: int) -> bool:
        """Whether ``stage`` runs a microbatch at ``tick``."""
        return stage <= tick < stage + self.n_microbatches

    def stats(self) -> dict:
        """The handoff route and the counters: ticks, stage runs (a
        microbatch through this stage's blocks) and handoffs sent."""
        return {"route": self.route, **dict(self.counts)}

    def _stage_fn(self, blocks: list, x):
        """This stage's blocks (a list of param dicts) in order."""
        for p in blocks:
            x = self.block_fn(p, x)
        return x

    @staticmethod
    def _as_blocks(names: list, flat) -> list:
        blocks: List[dict] = []
        for (b, k), t in zip(names, flat):
            while len(blocks) <= b:
                blocks.append({})
            blocks[b][k] = t
        return blocks

    def run(self, stage_blocks: list, x: torch.Tensor) -> torch.Tensor:
        """``x [B, ...]`` through every stage: this rank's blocks are
        ``stage_blocks`` (param dicts in order). Every rank of the stage
        group calls it with its own blocks; the last stage gets the output,
        the others zeros of its shape."""
        M = self.n_microbatches
        B = x.shape[0]
        if B % M:
            raise ValueError(f"batch {B} not divisible by {M} microbatches")
        if len(stage_blocks) != self.blocks_per_stage:
            raise ValueError(f"{len(stage_blocks)} blocks given to a stage "
                             f"of {self.blocks_per_stage}")
        self.route = handoff_route(self.group, x.device)
        names = [(b, k) for b, p in enumerate(stage_blocks) for k in p]
        flat = [stage_blocks[b][k] for b, k in names]
        return _GPipe.apply(self, names, x, *flat)

    def __call__(self, stacked_params: dict, x: torch.Tensor
                 ) -> torch.Tensor:
        """``x [B, T, F]`` through all blocks; ``stacked_params`` is
        ``{k: [n_blocks, ...]}`` (whole on every rank, each stage reading
        its blocks). Returns the output on the last stage, zeros of its
        shape on the others."""
        own = self.own_blocks()
        blocks = [{k: v[i] for k, v in stacked_params.items()} for i in own]
        return self.run(blocks, x)

    def reference_forward(self, stacked_params: dict, x: torch.Tensor
                          ) -> torch.Tensor:
        """The blocks in sequence on one rank (the test oracle)."""
        for p in unstack_block_params(stacked_params):
            x = self.block_fn(p, x)
        return x
