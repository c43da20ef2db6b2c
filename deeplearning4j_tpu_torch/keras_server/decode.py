"""Continuous (iteration-level) batching for autoregressive decode.

Counterpart of ``deeplearning4j_tpu/keras_server/decode.py`` for
decoder-only transformer stacks and LSTM stacks. One persistent step runs every iteration
over a fixed-capacity slot tensor; sessions are admitted into free slots
between steps and evicted the step their sequence ends, so the device batch
stays full while sessions churn. Capacity grows in power-of-two buckets.

State layouts, one per transformer block:

- ``kv="dense"``: a KV cache ``[cap, max_context, heads, head_dim]``, written
  at each slot's position and attention-masked to ``j <= position``; a freed
  slot's stale rows are unreachable, so admission never clears the cache;
- ``kv="paged"``: the same logical cache resolved through a per-slot page
  table over one physical page pool (``paging.py``). The step scatters this
  iteration's k/v through the table, gathers the logical view back with the
  ``paged_gather`` kernel, and runs the same masked attention, so paged and
  dense decode are bitwise equal. Sessions whose prompts share a prefix map
  the same pages copy-on-write;
- LSTM stacks: ``h``/``c`` blocks ``[cap, hidden]`` per streaming LSTM
  layer. The step one-hots the slot tokens, zeroes the state of slots
  admitted since the last step (``fresh``), runs ``apply_streaming`` at
  T = 1 (the ``lstm_fwd`` kernel on the card) and writes the new state back.
  A stack mixing LSTM and transformer layers, a bidirectional LSTM and
  ``kv="paged"`` with an LSTM are refused, as in the JAX package.

Prompt prefill feeds prompt tokens one per step through the same step
(teacher forcing). ``mode="static"`` admits only when every slot has
drained, the request-level baseline. Sampling is greedy argmax.
``quant="int8"`` pins int8 weights; every matmul of the step then runs the
``int8_matmul`` kernel (``ops/quant.py``) and the embedding gathers int8
rows (``gather_rows``); an LSTM step dequantizes the tree instead, as the JAX
step does, so no ``int8_matmul`` runs there. Attention inside the step is
plain PyTorch, as it is plain XLA in the JAX package.

Every step runs under the dtype policy the served network's config names
(the ambient one when it names none): under a bf16 policy the int8 matmuls
take bf16 ``x``. The KV blocks and the LSTM state blocks stay float32
under every policy, as the JAX package keeps its pools; this step's k and
v are widened into them.

The KV blocks are updated in place (the JAX package donates them to its
compiled step instead). They are confined to the pump thread, which launches
every kernel on its own current CUDA stream; ``next_tok.cpu()`` is each
iteration's sync point. Speculative decoding is not ported yet
(ROADMAP.md).
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from ..common import get_policy, host_numpy, resolve_device, wrap_with_policy
from ..nn.conf.layers.attention import TransformerBlock, gelu, layer_norm
from ..nn.conf.layers.feedforward import EmbeddingLayer
from ..nn.conf.layers.recurrent import (
    GravesBidirectionalLSTM, RnnOutputLayer, streaming_lstm,
)
from ..nn.inference import copy_tree
from ..ops.paged_attention import paged_gather
from ..ops.quant import (
    dequantize_tree, gather_rows, quantize_tree, quantized_matmul,
    tree_param_bytes,
)
from .admission import RejectedError
from .paging import TRASH_PAGE, PagePool, alloc_dense_kv, alloc_page_pool

DECODE_MODES = ("continuous", "static")
DECODE_KV = ("dense", "paged")
NEG = -1e30


class DecodeSession:
    """One generation request: a prompt plus a token budget. The engine
    appends generated tokens as they materialize; ``result()`` blocks until
    eviction."""

    _next_sid = [0]
    _sid_lock = threading.Lock()

    def __init__(self, prompt, max_new_tokens: int, stream=None):
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("prompt must contain at least one token id")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        with self._sid_lock:
            self._next_sid[0] += 1
            self.sid = self._next_sid[0]
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.stream = stream
        self.tokens: List[int] = []         #: generated token ids
        self.token_times: List[float] = []  #: host perf_counter per token
        self.probs: List[np.ndarray] = []   #: per-token dists (opt-in)
        self.t_sched = time.perf_counter()
        self.t_first: Optional[float] = None
        self.t_done: Optional[float] = None
        self.evict_reason: Optional[str] = None
        self.done = threading.Event()
        self._prompt_idx = 0

    @property
    def ttft_s(self) -> Optional[float]:
        return None if self.t_first is None else self.t_first - self.t_sched

    def result(self, timeout: Optional[float] = None) -> List[int]:
        if not self.done.wait(timeout):
            raise TimeoutError(
                f"session {self.sid} not finished within {timeout}s")
        return self.tokens


class _DenseKV:
    """Dense cache adapter: write this step's k/v at each slot's position,
    read back the stored block. The oracle layout the paged adapter must
    equal bitwise."""

    def __init__(self, blocks):
        self.blocks = blocks

    def write_read(self, i, k, v, positions):
        K, V = self.blocks[i]["k"], self.blocks[i]["v"]
        cap, tmax = K.shape[:2]
        valid = (positions < tmax)[:, None, None]
        pos = positions.clamp(max=tmax - 1).long()
        rows = torch.arange(cap, device=K.device)
        # in place; a position past the ceiling rewrites its row unchanged
        K[rows, pos] = torch.where(valid, k.to(K.dtype), K[rows, pos])
        V[rows, pos] = torch.where(valid, v.to(V.dtype), V[rows, pos])
        return K, V


class _PagedKV:
    """Paged cache adapter: scatter this step's k/v into the physical pool
    through the slot's page-table row, then gather the logical
    ``[cap, max_context, H, D]`` view back. Positions at or past the context
    ceiling (the parking sentinel included) write the trash page."""

    def __init__(self, blocks, table, page_size):
        self.blocks = blocks
        self.table = table
        self.page_size = page_size

    def write_read(self, i, k, v, positions):
        ps = self.page_size
        pool_k, pool_v = self.blocks[i]["k"], self.blocks[i]["v"]
        cap, P = self.table.shape
        in_range = positions < P * ps
        pidx = (positions // ps).clamp(0, P - 1).long()
        rows = self.table[torch.arange(cap, device=pool_k.device), pidx]
        wp = torch.where(in_range, rows, torch.full_like(rows, TRASH_PAGE)).long()
        off = torch.where(in_range, positions % ps,
                          torch.zeros_like(positions)).long()
        # In place. Active slots own their write page exclusively (the
        # planner's invariant), so indices collide only on the trash page.
        # On CUDA the order of colliding writes is unspecified; that is
        # harmless there only, because no mask ever reads the trash page.
        pool_k[wp, off] = k.to(pool_k.dtype)
        pool_v[wp, off] = v.to(pool_v.dtype)
        return paged_gather(pool_k, self.table), paged_gather(pool_v, self.table)


def _fork_pages(blocks, fork_src, fork_dst) -> None:
    """This iteration's copy-on-write forks, in place and before any write:
    page ``fork_src[c]`` is copied onto ``fork_dst[c]`` (non-forking slots
    carry trash -> trash, colliding only on the trash page)."""
    src, dst = fork_src.long(), fork_dst.long()
    for b in blocks:
        if b:
            b["k"][dst] = b["k"][src]
            b["v"][dst] = b["v"][src]


def _tf_forward(layers, params_list, tokens, positions, kv):
    """One token through the transformer stack for every slot. Dense and
    paged decode run exactly these ops; only ``kv.write_read`` differs, and
    it is pure data movement."""
    pol = get_policy()
    od, cd = pol.output_dtype, pol.compute_dtype
    cap = tokens.shape[0]
    x = None
    for i, layer in enumerate(layers):
        p = params_list[i]
        if isinstance(layer, EmbeddingLayer):
            x = (gather_rows(p["W"], tokens) + p["b"]).to(od)
            x = layer.act_fn()(x)
        elif isinstance(layer, TransformerBlock):
            F_ = layer.n_out
            H = layer.n_heads
            D = F_ // H
            h = layer_norm(x, p["ln1_g"], p["ln1_b"])
            qkv = quantized_matmul(h.to(cd), p["Wqkv"], compute_dtype=cd)
            q, k, v = (t.reshape(cap, H, D)
                       for t in torch.split(qkv.to(od), F_, dim=-1))
            K, V = kv.write_read(i, k, v, positions)
            tmax = K.shape[1]
            # a freed slot's stale rows sit at j > position of the next
            # tenant, so the mask doubles as the admission reset
            valid = (torch.arange(tmax, device=K.device)[None, None, :]
                     <= positions[:, None, None])
            s = torch.einsum("chd,cthd->cht", q.to(torch.float32),
                             K.to(torch.float32)) / math.sqrt(D)
            s = torch.where(valid, s, torch.full_like(s, NEG))
            w = torch.softmax(s, dim=-1)
            o = torch.einsum("cht,cthd->chd", w,
                             V.to(torch.float32)).reshape(cap, F_)
            att = quantized_matmul(o.to(cd), p["Wo"], compute_dtype=cd)
            x = x + att.to(od) + p["bo"].to(od)
            h = layer_norm(x, p["ln2_g"], p["ln2_b"])
            h = quantized_matmul(h.to(cd), p["W1"], compute_dtype=cd)
            h = gelu(h.to(od) + p["b1"].to(od))
            h = quantized_matmul(h.to(cd), p["W2"], compute_dtype=cd)
            x = x + h.to(od) + p["b2"].to(od)
        elif isinstance(layer, RnnOutputLayer):
            logits = quantized_matmul(x.to(cd), p["W"], compute_dtype=cd)
            x = layer.act_fn()(logits.to(od) + p["b"].to(od))
        else:
            raise ValueError(f"decode cannot stream layer {type(layer).__name__}")
    return torch.argmax(x, dim=-1).to(torch.int32), x


def _lstm_forward(layers, params_list, blocks, tokens, fresh, vocab: int):
    """One token through the LSTM stack for every slot: the state of fresh
    slots starts at zero; the new ``h``/``c`` are written into ``blocks`` in
    place."""
    x = torch.nn.functional.one_hot(tokens.long(), vocab).to(
        torch.float32)[:, None, :]
    for i, layer in enumerate(layers):
        p = params_list[i]
        if streaming_lstm(layer):
            b = blocks[i]
            stale = fresh[:, None]
            st = {k: torch.where(stale, torch.zeros_like(b[k]), b[k])
                  for k in ("h", "c")}
            x, rs = layer.apply_streaming(p, st, x)
            b["h"].copy_(rs["h"])  # widened into the float32 block
            b["c"].copy_(rs["c"])
        else:
            x = layer.apply(p, x)
    probs = x[:, -1, :]
    return torch.argmax(probs, dim=-1).to(torch.int32), probs


class DecodeEngine:
    """Persistent decode loop with slot-level admission and eviction.

    ``submit()`` queues a session; one daemon pump thread admits, steps and
    evicts. ``device=None`` means CUDA. ``kv="paged"`` swaps the dense KV
    blocks for ``n_pages`` physical pages of ``page_size`` tokens, shared
    copy-on-write across sessions with equal prompt prefixes."""

    def __init__(self, net, *, device=None, max_context: int = 128,
                 min_slots: int = 2, max_slots: int = 16,
                 eos_id: Optional[int] = None, mode: str = "continuous",
                 quant: Optional[str] = None, capture_probs: bool = False,
                 max_queue: int = 4096, kv: str = "dense",
                 page_size: int = 16, n_pages: Optional[int] = None,
                 draft_net=None):
        if draft_net is not None:
            raise NotImplementedError(
                "speculative decoding is not ported yet (ROADMAP.md)")
        if mode not in DECODE_MODES:
            raise ValueError(f"mode must be one of {DECODE_MODES}, got {mode!r}")
        if kv not in DECODE_KV:
            raise ValueError(f"kv must be one of {DECODE_KV}, got {kv!r}")
        if not (1 <= min_slots <= max_slots):
            raise ValueError("need 1 <= min_slots <= max_slots")
        net._require_init()
        layers = list(net.layers)
        out = layers[-1]
        if not isinstance(out, RnnOutputLayer):
            raise ValueError("decode needs a time-distributed output head "
                             f"(RnnOutputLayer), got {type(out).__name__}")
        self.vocab = int(out.n_out)
        if int(layers[0].n_in) != self.vocab:
            raise ValueError(
                f"decode feeds outputs back as inputs: first-layer n_in "
                f"{layers[0].n_in} must equal output vocab {self.vocab}")
        has_tf = any(isinstance(l, TransformerBlock) for l in layers)
        has_lstm = any(streaming_lstm(l) for l in layers)
        if has_tf and has_lstm:
            raise ValueError("decode supports pure-LSTM or pure-transformer "
                             "stacks, not a mix")
        if not (has_tf or has_lstm):
            raise ValueError("decode needs a stateful sequence model (LSTM "
                             "stack or TransformerBlock stack)")
        if any(isinstance(l, GravesBidirectionalLSTM) for l in layers):
            raise ValueError("bidirectional LSTMs cannot stream (the backward "
                             "pass needs the full sequence)")
        self.device = resolve_device(device)
        self.kind = "transformer" if has_tf else "lstm"
        self.mode = mode
        self.max_context = int(max_context)
        self.min_slots = int(min_slots)
        self.max_slots = int(max_slots)
        self.eos_id = eos_id
        self.capture_probs = bool(capture_probs)
        self.quant = "int8" if quant == "int8" else None
        #: the dtype policy every step runs under (the config's, else None)
        self.policy = net.conf.global_conf.dtype
        #: one step of every slot, under that policy
        self._step = wrap_with_policy(self._step_body, self.policy)
        self.kv = kv
        self.page_size = int(page_size)
        self._layers = layers
        self._pool: Optional[PagePool] = None
        if kv == "paged":
            if self.kind != "transformer":
                raise ValueError("kv='paged' needs a transformer stack (LSTM "
                                 "state is h/c vectors, not a KV cache)")
            if self.page_size < 1 or self.max_context % self.page_size:
                raise ValueError(f"max_context {self.max_context} must be a "
                                 f"multiple of page_size {self.page_size}")
            self._pages_per_slot = self.max_context // self.page_size
            if n_pages is None:
                # capacity parity with the dense layout at max_slots
                n_pages = self.max_slots * self._pages_per_slot
            if int(n_pages) < 1:
                raise ValueError("n_pages must be >= 1")
            self._n_pages = int(n_pages)
            self._pool = PagePool(self._n_pages, self.page_size)
        # pinned snapshot on this engine's device, like PredictFn
        self._params = copy_tree(net.params_list, self.device)
        if self.quant == "int8":
            self._params = quantize_tree(self._params)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: deque = deque()
        self.max_queue = int(max_queue)
        self._closed = False
        self._cap = 0
        self._slots: List[Optional[DecodeSession]] = []
        self._tokens_h = np.zeros((0,), np.int32)
        self._pos_h = np.zeros((0,), np.int32)
        self._fresh_h = np.zeros((0,), bool)
        self._table_h = np.zeros((0, 0), np.int32)
        self._fork_src_h = np.zeros((0,), np.int32)
        self._fork_dst_h = np.zeros((0,), np.int32)
        self._park_h = np.zeros((0,), bool)
        self._blocks = None
        self._grow_to(self.min_slots)
        self._steps = 0
        self._generated = 0
        self._evicted = 0
        self._occupancy_sum = 0.0
        self._peak_active = 0
        self._shared_tokens = 0
        self._prompt_tokens = 0
        self._buckets: set = set()
        self.last_error: Optional[str] = None
        self._thread = threading.Thread(
            target=self._loop, name="serve-decode-engine", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- slot state
    def _zero_blocks(self, cap: int):
        blocks = []
        for layer in self._layers:
            if self.kind == "lstm" and streaming_lstm(layer):
                blocks.append({k: torch.zeros(cap, layer.n_out,
                                              dtype=torch.float32,
                                              device=self.device)
                               for k in ("h", "c")})
            elif isinstance(layer, TransformerBlock):
                hd = layer.n_out // layer.n_heads
                if self.kv == "paged":
                    blocks.append(alloc_page_pool(
                        self._n_pages, self.page_size, layer.n_heads, hd,
                        self.device))
                else:
                    blocks.append(alloc_dense_kv(
                        cap, self.max_context, layer.n_heads, hd, self.device))
            else:
                blocks.append({})
        return blocks

    #: requires-lock: _cond
    def _grow_to(self, cap: int) -> None:
        """Move to a larger capacity bucket. Dense blocks copy their rows on
        the device; the paged pool is capacity-independent and stays."""
        old = self._cap
        self._slots += [None] * (cap - old)
        for name_ in ("_tokens_h", "_pos_h", "_fresh_h", "_fork_src_h",
                      "_fork_dst_h", "_park_h"):
            a = getattr(self, name_)
            grown = np.zeros((cap,), a.dtype)
            grown[:old] = a
            setattr(self, name_, grown)
        if self._pool is not None:
            t = np.full((cap, self._pages_per_slot), TRASH_PAGE, np.int32)
            if old:
                t[:old] = self._table_h
            self._table_h = t
            if self._blocks is None:
                self._blocks = self._zero_blocks(cap)
        else:
            new_blocks = self._zero_blocks(cap)
            if self._blocks is not None and old:
                for nb, ob in zip(new_blocks, self._blocks):
                    for key in nb:
                        nb[key][:old] = ob[key]
            self._blocks = new_blocks
        self._cap = cap

    # --------------------------------------------------------------- producer
    def submit(self, prompt, max_new_tokens: int = 32,
               stream=None) -> DecodeSession:
        """Queue one generation session; returns immediately. ``stream``,
        when given, is called as ``stream(sid, token, time)`` for every
        generated token."""
        sess = DecodeSession(prompt, max_new_tokens, stream=stream)
        bad = [t for t in sess.prompt if not 0 <= t < self.vocab]
        if bad:
            raise ValueError(f"prompt token ids {bad} outside vocab "
                             f"[0, {self.vocab})")
        if self._pool is not None:
            span = min(len(sess.prompt) + sess.max_new_tokens, self.max_context)
            worst = -(-span // self.page_size)
            if worst > self._n_pages:
                # the session can never fit this pool: fail fast with a 429
                raise RejectedError(worst, self._n_pages, 60.0)
        with self._cond:
            if self._closed:
                raise RuntimeError("DecodeEngine is closed")
            if len(self._queue) >= self.max_queue:
                raise RejectedError(len(self._queue), self.max_queue, 1.0)
            self._queue.append(sess)
            self._cond.notify()
        return sess

    # ----------------------------------------------------------------- pump
    def _active_count(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    #: requires-lock: _cond
    def _admit_locked(self) -> None:
        """Move queued sessions into free slots: any free slot in continuous
        mode, only a drained batch in static mode. Capacity grows by powers of
        two when demand outruns it. Paged engines also gate on free pages
        (FIFO) and map registered prefix pages copy-on-write."""
        active = self._active_count()
        if self.mode == "static" and active:
            return
        while self._queue and active >= self._cap and self._cap < self.max_slots:
            self._grow_to(min(self._cap * 2, self.max_slots))
        for i in range(self._cap):
            if not self._queue:
                break
            if self._slots[i] is not None:
                continue
            sess = self._queue[0]
            skip = 0
            if self._pool is not None:
                pids, covered = self._pool.match_prompt(sess.prompt)
                ps = self.page_size
                fresh_pages = (-(-len(sess.prompt) // ps)) - len(pids) \
                    + (1 if covered % ps else 0)
                if self._pool.free_pages < fresh_pages + 1:
                    break
                for k, pid in enumerate(pids):
                    self._pool.incref(pid)
                    self._table_h[i, k] = pid
                skip = min(covered, len(sess.prompt) - 1)
                self._shared_tokens += skip
                self._prompt_tokens += len(sess.prompt)
            self._queue.popleft()
            self._slots[i] = sess
            self._tokens_h[i] = sess.prompt[skip]
            self._pos_h[i] = skip
            self._fresh_h[i] = True
            sess._prompt_idx = skip
            active += 1
        self._peak_active = max(self._peak_active, active)

    #: requires-lock: _cond
    def _release_pages_locked(self, i: int) -> None:
        row = self._table_h[i]
        for pid in {int(x) for x in row.tolist()} - {TRASH_PAGE}:
            self._pool.decref(pid)
        row[:] = TRASH_PAGE

    #: requires-lock: _cond
    def _evict_locked(self, i: int, reason: str) -> None:
        sess = self._slots[i]
        self._slots[i] = None
        if self._pool is not None:
            self._release_pages_locked(i)
        self._evicted += 1
        sess.evict_reason = reason
        sess.t_done = time.perf_counter()
        sess.done.set()

    #: requires-lock: _cond
    def _map_window_locked(self, i: int, window: int) -> bool:
        """Ensure slot ``i`` owns pages for its next ``window`` write
        positions: allocate unmapped pages, fork shared ones. False means the
        pool is exhausted (the caller parks or preempts)."""
        pool, ps = self._pool, self.page_size
        pos = int(self._pos_h[i])
        for t in range(window):
            q = pos + t
            if q >= self.max_context:
                break  # clamped to the trash page in-step
            k = q // ps
            pid = int(self._table_h[i, k])
            if pid == TRASH_PAGE:
                npid = pool.alloc()
                if npid is None:
                    return False
                self._table_h[i, k] = npid
            elif pool.refcount(pid) > 1:
                npid = pool.alloc()
                if npid is None:
                    return False
                if q % ps:
                    # mid-page: earlier offsets hold this slot's history and
                    # are copied src -> dst inside the step; one fork per
                    # slot suffices, park if a second would arise
                    if int(self._fork_dst_h[i]) != TRASH_PAGE:
                        pool.decref(npid)
                        return False
                    self._fork_src_h[i] = pid
                    self._fork_dst_h[i] = npid
                pool.decref(pid)
                self._table_h[i, k] = npid
        return True

    #: requires-lock: _cond
    def _plan_pages_locked(self, window: int) -> None:
        """Map every active slot's write window; when no slot can move,
        preempt the youngest tenant so the rest make progress."""
        self._fork_src_h[:] = TRASH_PAGE
        self._fork_dst_h[:] = TRASH_PAGE
        self._park_h[:] = False
        pending = [i for i in range(self._cap) if self._slots[i] is not None]
        any_live = False
        while True:
            still = []
            for i in pending:
                if self._map_window_locked(i, window):
                    any_live = True
                else:
                    still.append(i)
            if any_live or not still:
                for i in still:
                    self._park_h[i] = True
                break
            victim = max(still, key=lambda i: self._slots[i].sid)
            self._evict_locked(victim, "pool_exhausted")
            pending = [i for i in still if i != victim]
            if not pending:
                break

    #: requires-lock: _cond
    def _register_prefix_locked(self, i: int, sess, lo: int, hi: int) -> None:
        """Publish the prompt pages slot ``i`` finished writing in
        ``[lo, hi)``; generated positions are never registered."""
        ps = self.page_size
        for q in range(lo, min(hi, len(sess.prompt))):
            self._pool.register(sess.prompt[:q + 1],
                                int(self._table_h[i, q // ps]))

    @torch.no_grad()
    def _step_body(self, tokens, fresh, positions, paged_args):
        if self.kind == "lstm":
            params = self._params
            if self.quant == "int8":
                params = dequantize_tree(params)
            return _lstm_forward(self._layers, params, self._blocks, tokens,
                                 fresh, self.vocab)
        if self._pool is not None:
            table, fork_src, fork_dst = paged_args
            _fork_pages(self._blocks, fork_src, fork_dst)
            kv = _PagedKV(self._blocks, table, self.page_size)
        else:
            kv = _DenseKV(self._blocks)
        return _tf_forward(self._layers, self._params, tokens, positions, kv)

    def _pump_once(self) -> bool:
        """One admit/step/bookkeep iteration; False when idle and closed."""
        dev = self.device
        with self._cond:
            while True:
                self._admit_locked()
                if self._active_count():
                    break
                if self._closed and not self._queue:
                    return False
                self._cond.wait(0.05)
            cap = self._cap
            if self._pool is not None:
                self._plan_pages_locked(1)
            active = [(i, self._slots[i]) for i in range(cap)
                      if self._slots[i] is not None]
            if not active:
                return True  # planning preempted the whole batch
            parked = self._park_h.copy() if self._pool is not None else None
            tokens = torch.from_numpy(self._tokens_h.copy()).to(dev)
            fresh = torch.from_numpy(self._fresh_h.copy()).to(dev)
            pos_np = self._pos_h.copy()
            if parked is not None:
                # parked slots write the trash page and advance nothing
                pos_np[parked] = self.max_context
            positions = torch.from_numpy(pos_np).to(dev)
            paged_args = None
            if self._pool is not None:
                paged_args = tuple(torch.from_numpy(a.copy()).to(dev) for a in
                                   (self._table_h, self._fork_src_h,
                                    self._fork_dst_h))
        try:
            next_tok, probs = self._step(tokens, fresh, positions, paged_args)
            # the iteration's sync point: the emitted token drives admission
            # and eviction and is the next input
            next_h = next_tok.cpu().numpy()
            probs_h = host_numpy(probs) if self.capture_probs else None
        except Exception as e:
            self.last_error = repr(e)
            with self._cond:
                for i, _ in active:
                    self._evict_locked(i, "error")
            raise
        now = time.perf_counter()
        with self._cond:
            self._steps += 1
            self._buckets.add(cap)
            self._occupancy_sum += len(active) / cap
            for i, sess in active:
                if parked is not None and parked[i]:
                    continue  # wrote trash; retry when pages free up
                p0 = int(self._pos_h[i])
                self._fresh_h[i] = False
                self._pos_h[i] += 1
                if self._pool is not None:
                    self._register_prefix_locked(i, sess, p0, p0 + 1)
                if sess._prompt_idx < len(sess.prompt) - 1:
                    sess._prompt_idx += 1
                    self._tokens_h[i] = sess.prompt[sess._prompt_idx]
                else:
                    tok = int(next_h[i])
                    sess.tokens.append(tok)
                    sess.token_times.append(now)
                    if probs_h is not None:
                        sess.probs.append(probs_h[i].copy())
                    if sess.t_first is None:
                        sess.t_first = now
                    self._generated += 1
                    if sess.stream is not None:
                        sess.stream(sess.sid, tok, now)
                    if self.eos_id is not None and tok == self.eos_id:
                        self._evict_locked(i, "eos")
                        continue
                    if len(sess.tokens) >= sess.max_new_tokens:
                        self._evict_locked(i, "max_tokens")
                        continue
                    self._tokens_h[i] = tok
                if self.kind == "transformer" \
                        and self._pos_h[i] >= self.max_context:
                    self._evict_locked(i, "context")
        return True

    def _loop(self) -> None:
        while True:
            try:
                if not self._pump_once():
                    return
            except Exception:
                # the sessions in flight were failed by _pump_once
                continue

    # ---------------------------------------------------------------- control
    def stats(self) -> dict:
        with self._lock:
            out = {
                "mode": self.mode, "kind": self.kind, "quant": self.quant,
                "kv": self.kv, "device": str(self.device),
                "capacity": self._cap, "max_slots": self.max_slots,
                "buckets": sorted(self._buckets),
                "bucket_count": len(self._buckets),
                "steps": self._steps, "tokens": self._generated,
                "evictions": self._evicted,
                "queue_depth": len(self._queue),
                "active": self._active_count(),
                "peak_active": self._peak_active,
                "mean_occupancy": (self._occupancy_sum / self._steps
                                   if self._steps else 0.0),
                "param_bytes": tree_param_bytes(self._params),
                "last_error": self.last_error,
            }
            if self._pool is not None:
                out["page_size"] = self.page_size
                out["pool_pages"] = self._n_pages
                out["pages_in_use"] = self._pool.pages_in_use
                out["pages_free"] = self._pool.free_pages
                out["prefix_entries"] = self._pool.prefix_entries
                out["prefix_share_ratio"] = (
                    self._shared_tokens / self._prompt_tokens
                    if self._prompt_tokens else 0.0)
            return out

    def idle(self) -> bool:
        with self._lock:
            return not self._queue and not self._active_count()

    def close(self, timeout_s: float = 30.0) -> None:
        """Stop accepting sessions; the pump drains what is queued first."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout_s)
