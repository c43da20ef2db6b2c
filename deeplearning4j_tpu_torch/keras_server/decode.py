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
iteration's sync point.

**Speculative decoding** (``draft_net=``, transformer targets): each round
the draft proposes ``spec_tokens`` (γ) tokens, one single-token step of its
own at a time over its own dense float32 KV blocks (no kernel: no int8, no
pages), and the target verifies them in one round of T = γ + 1 calls of the
same ``_tf_forward`` the plain step runs, each at M = capacity rows, token t
at ``position + t``. The longest prefix whose argmax agrees is accepted; a
rejected write sits at ``j > position`` behind the mask, as a freed slot's
rows do. Every verify position runs the plain step's ops at the plain
step's shapes, so the emitted stream equals plain greedy decode at any
acceptance rate; the T positions are never folded into one forward of
``cap * T`` rows, which would give ``int8_matmul`` another M and another
K split. Prefill rides the same round: prompt tokens are inputs whose
acceptance is certain.
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

    def __init__(self, prompt, max_new_tokens: int,
                 t_sched: Optional[float] = None, stream=None):
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
        #: the offered arrival (an open-loop client's schedule); TTFT counts
        #: from it, so queueing in the engine is not hidden
        self.t_sched = time.perf_counter() if t_sched is None \
            else float(t_sched)
        self.t_first: Optional[float] = None
        self.t_done: Optional[float] = None
        self.evict_reason: Optional[str] = None
        self.done = threading.Event()
        self._prompt_idx = 0
        #: every input token the target has consumed or will consume next
        #: (prompt + emissions); speculative rounds read their inputs here
        self._hist: List[int] = []
        self._spec_proposed = 0
        self._spec_accepted = 0

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


def _tf_verify(layers, params_list, tokens, positions, kv):
    """The spec-decode verify round: ``_tf_forward`` once for each of the T
    columns of ``tokens`` ``[cap, T]``, column t at ``positions + t``, each
    at M = cap rows exactly as the plain step; outputs ``[cap, T]`` and
    ``[cap, T, vocab]``."""
    outs, probs = [], []
    for t in range(tokens.shape[1]):
        tok, pr = _tf_forward(layers, params_list,
                              tokens[:, t].contiguous(), positions + t, kv)
        outs.append(tok)
        probs.append(pr)
    return torch.stack(outs, dim=1), torch.stack(probs, dim=1)


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
    copy-on-write across sessions with equal prompt prefixes. ``draft_net``
    (a transformer over the target's vocabulary) turns on speculative
    decoding with ``spec_tokens`` proposals a round."""

    def __init__(self, net, *, device=None, max_context: int = 128,
                 min_slots: int = 2, max_slots: int = 16,
                 eos_id: Optional[int] = None, mode: str = "continuous",
                 quant: Optional[str] = None, capture_probs: bool = False,
                 max_queue: int = 4096, kv: str = "dense",
                 page_size: int = 16, n_pages: Optional[int] = None,
                 draft_net=None, spec_tokens: int = 3):
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
        self._spec_draft = None
        self.spec_tokens = int(spec_tokens)
        if draft_net is not None:
            if self.kind != "transformer":
                raise ValueError("speculative decoding needs a transformer "
                                 "target (the verify round is the "
                                 "teacher-forcing prefill path)")
            draft_net._require_init()
            dlayers = list(draft_net.layers)
            dout = dlayers[-1]
            if not isinstance(dout, RnnOutputLayer) \
                    or int(dout.n_out) != self.vocab:
                raise ValueError(
                    "draft model must share the target's vocab "
                    f"({self.vocab}) and end in an RnnOutputLayer")
            if not any(isinstance(l, TransformerBlock) for l in dlayers):
                raise ValueError("draft model must be a transformer stack")
            if self.spec_tokens < 1:
                raise ValueError("spec_tokens must be >= 1")
            self._spec_draft = draft_net
            self._draft_layers = dlayers
            #: the draft's pinned float32 snapshot: dense, never quantized
            self._draft_params = copy_tree(draft_net.params_list, self.device)
            self._draft_step = wrap_with_policy(
                self._draft_body, draft_net.conf.global_conf.dtype)
            self._verify_T = self.spec_tokens + 1
            self._verify = wrap_with_policy(self._verify_body, self.policy)
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
        self._dpos_h = np.zeros((0,), np.int32)
        self._blocks = None
        self._draft_blocks = None
        self._grow_to(self.min_slots)
        self._steps = 0
        self._generated = 0
        self._evicted = 0
        self._occupancy_sum = 0.0
        self._peak_active = 0
        self._shared_tokens = 0
        self._prompt_tokens = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._draft_steps = 0
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

    def _zero_draft_blocks(self, cap: int):
        """The draft's dense KV blocks for one capacity bucket."""
        return [alloc_dense_kv(cap, self.max_context, layer.n_heads,
                               layer.n_out // layer.n_heads, self.device)
                if isinstance(layer, TransformerBlock) else {}
                for layer in self._draft_layers]

    #: requires-lock: _cond
    def _grow_to(self, cap: int) -> None:
        """Move to a larger capacity bucket. Dense blocks copy their rows on
        the device; the paged pool is capacity-independent and stays."""
        old = self._cap
        self._slots += [None] * (cap - old)
        for name_ in ("_tokens_h", "_pos_h", "_fresh_h", "_fork_src_h",
                      "_fork_dst_h", "_park_h", "_dpos_h"):
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
        if self._spec_draft is not None:
            new_draft = self._zero_draft_blocks(cap)
            if self._draft_blocks is not None and old:
                for nb, ob in zip(new_draft, self._draft_blocks):
                    for key in nb:
                        nb[key][:old] = ob[key]
            self._draft_blocks = new_draft
        self._cap = cap

    # --------------------------------------------------------------- producer
    def submit(self, prompt, max_new_tokens: int = 32,
               t_sched: Optional[float] = None,
               stream=None) -> DecodeSession:
        """Queue one generation session; returns immediately. ``stream``,
        when given, is called as ``stream(sid, token, time)`` for every
        generated token; ``t_sched`` is the offered arrival an open-loop
        client scheduled (TTFT counts from it)."""
        sess = DecodeSession(prompt, max_new_tokens, t_sched=t_sched,
                             stream=stream)
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
            sess._hist = list(sess.prompt)
            if self._spec_draft is not None:
                self._dpos_h[i] = 0
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

    #: requires-lock: _cond
    def _settle_locked(self, i: int, sess, p: int, n_ok: int, outs_row,
                       probs_rows, now: float) -> int:
        """Settle slot ``i`` after a step or verify round that consumed the
        inputs at positions ``[p, p + n_ok)``: emit each output past the
        prompt (``outs_row[t]`` follows position ``p + t``), evict on eos,
        max_tokens or the context ceiling, publish the prompt pages
        written, and set the next input. Returns the positions kept
        (``n_ok``, cut at an emission that evicts)."""
        h = sess._hist
        evict = None
        for t in range(n_ok):
            if p + t + 1 < len(h):
                continue  # a teacher-forced prefill output
            tok = int(outs_row[t])
            h.append(tok)
            sess.tokens.append(tok)
            sess.token_times.append(now)
            if probs_rows is not None:
                sess.probs.append(probs_rows[t].copy())
            if sess.t_first is None:
                sess.t_first = now
            self._generated += 1
            if sess.stream is not None:
                sess.stream(sess.sid, tok, now)
            if self.eos_id is not None and tok == self.eos_id:
                evict, n_ok = "eos", t + 1
                break
            if len(sess.tokens) >= sess.max_new_tokens:
                evict, n_ok = "max_tokens", t + 1
                break
        new_p = p + n_ok
        self._fresh_h[i] = False
        self._pos_h[i] = new_p
        sess._prompt_idx = min(new_p, len(sess.prompt) - 1)
        if self._pool is not None:
            self._register_prefix_locked(i, sess, p, new_p)
        if evict is None and self.kind == "transformer" \
                and new_p >= self.max_context:
            evict = "context"
        if evict is not None:
            self._evict_locked(i, evict)
        else:
            self._tokens_h[i] = h[new_p]
        return n_ok

    def _target_kv(self, paged_args):
        """The target's cache adapter for one step or verify round, after
        this iteration's copy-on-write forks."""
        if self._pool is None:
            return _DenseKV(self._blocks)
        table, fork_src, fork_dst = paged_args
        _fork_pages(self._blocks, fork_src, fork_dst)
        return _PagedKV(self._blocks, table, self.page_size)

    @torch.no_grad()
    def _step_body(self, tokens, fresh, positions, paged_args):
        if self.kind == "lstm":
            params = self._params
            if self.quant == "int8":
                params = dequantize_tree(params)
            return _lstm_forward(self._layers, params, self._blocks, tokens,
                                 fresh, self.vocab)
        return _tf_forward(self._layers, self._params, tokens, positions,
                           self._target_kv(paged_args))

    @torch.no_grad()
    def _draft_body(self, tokens, positions):
        return _tf_forward(self._draft_layers, self._draft_params, tokens,
                           positions, _DenseKV(self._draft_blocks))

    @torch.no_grad()
    def _verify_body(self, tokens, positions, paged_args):
        return _tf_verify(self._layers, self._params, tokens, positions,
                          self._target_kv(paged_args))

    #: requires-lock: _cond
    def _await_active_locked(self) -> bool:
        """Admit until a slot is active; False when idle and closed."""
        while True:
            self._admit_locked()
            if self._active_count():
                return True
            if self._closed and not self._queue:
                return False
            self._cond.wait(0.05)

    def _pump_once(self) -> bool:
        """One admit/step/bookkeep iteration; False when idle and closed."""
        if self._spec_draft is not None:
            return self._pump_once_spec()
        dev = self.device
        with self._cond:
            if not self._await_active_locked():
                return False
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
                self._settle_locked(
                    i, sess, int(self._pos_h[i]), 1, next_h[i:i + 1],
                    None if probs_h is None else probs_h[i:i + 1], now)
        return True

    def _pump_once_spec(self) -> bool:
        """One speculative round: γ draft proposals, one verify round over
        T = γ + 1 positions, acceptance of the longest argmax-agreeing
        prefix. Prefill rides the same round (prompt tokens are certain
        inputs), so at acceptance 0 a round still emits the plain engine's
        one token."""
        gamma, T, dev = self.spec_tokens, self._verify_T, self.device
        with self._cond:
            if not self._await_active_locked():
                return False
            cap = self._cap
            if self._pool is not None:
                self._plan_pages_locked(T)
            active = [(i, self._slots[i]) for i in range(cap)
                      if self._slots[i] is not None]
            if not active:
                return True
            parked = (self._park_h.copy() if self._pool is not None
                      else np.zeros((cap,), bool))
            paged_args = None
            if self._pool is not None:
                paged_args = tuple(torch.from_numpy(a.copy()).to(dev) for a in
                                   (self._table_h, self._fork_src_h,
                                    self._fork_dst_h))
            d0 = self._dpos_h.copy()
            base_pos = self._pos_h.copy()
        live = [(i, s) for i, s in active if not parked[i]]
        try:
            # the draft: γ single-token steps over its own dense blocks
            props = {i: {} for i, _ in active}   # stream index -> proposal
            dins = {i: [] for i, _ in active}    # tokens the draft consumed
            dcur = d0.copy()
            n_draft = 0
            for _ in range(gamma):
                dtok = np.zeros((cap,), np.int32)
                for i, s in live:
                    c = int(dcur[i])
                    tok = s._hist[c] if c < len(s._hist) else props[i][c]
                    dtok[i] = tok
                    dins[i].append(tok)
                dpos = dcur.copy()
                dpos[parked] = self.max_context
                dout, _ = self._draft_step(torch.from_numpy(dtok).to(dev),
                                           torch.from_numpy(dpos).to(dev))
                n_draft += 1
                # the proposal is the draft's own next input: its sync point
                dout_h = dout.cpu().numpy()
                for i, s in live:
                    c = int(dcur[i])
                    if c + 1 >= len(s._hist):
                        props[i][c + 1] = int(dout_h[i])
                    dcur[i] = c + 1
            # the target: one verify round over T positions
            vtok = np.zeros((cap, T), np.int32)
            trusted = {}
            for i, s in live:
                p = int(base_pos[i])
                row = []
                for t in range(T):
                    sidx = p + t
                    if sidx < len(s._hist):
                        vtok[i, t] = s._hist[sidx]
                        row.append(True)
                    elif sidx in props[i]:
                        vtok[i, t] = props[i][sidx]
                        row.append(False)
                    else:
                        # the draft is still catching up: a pad, always
                        # rejected, its write behind the position mask
                        vtok[i, t] = s._hist[-1]
                        row.append(None)
                trusted[i] = row
            vpos = base_pos.copy()
            vpos[parked] = self.max_context
            outs, vprobs = self._verify(torch.from_numpy(vtok).to(dev),
                                        torch.from_numpy(vpos).to(dev),
                                        paged_args)
            # accept/reject drives eviction and the next round's inputs
            outs_h = outs.cpu().numpy()
            vprobs_h = host_numpy(vprobs) if self.capture_probs else None
        except Exception as e:
            self.last_error = repr(e)
            with self._cond:
                for i, _ in active:
                    self._evict_locked(i, "error")
            raise
        now = time.perf_counter()
        with self._cond:
            self._steps += 1
            self._draft_steps += n_draft
            self._buckets.add(cap)
            self._occupancy_sum += len(active) / cap
            for i, s in live:
                p = int(base_pos[i])
                row = trusted[i]
                # writes past the context ceiling went to the trash: never
                # accepted, the slot evicts at the ceiling
                max_ok = min(T, self.max_context - p)
                n_ok = max_ok
                # a proposal is judged only up to the first reject, so a
                # draft with the target's weights reads acceptance 1.0
                proposed = accepted = 0
                for t in range(1, max_ok):
                    if row[t] is True:
                        continue
                    if row[t] is False:
                        proposed += 1
                        if int(vtok[i, t]) == int(outs_h[i, t - 1]):
                            accepted += 1
                            continue
                    n_ok = t
                    break
                self._settle_locked(
                    i, s, p, n_ok, outs_h[i],
                    None if vprobs_h is None else vprobs_h[i], now)
                self._spec_proposed += proposed
                self._spec_accepted += accepted
                s._spec_proposed += proposed
                s._spec_accepted += accepted
                # the draft keeps KV only for inputs that match the settled
                # stream; the rest rolls back behind its position mask
                h = s._hist
                dvalid = 0
                c0 = int(d0[i])
                for j, tok in enumerate(dins[i]):
                    if c0 + j < len(h) and tok == h[c0 + j]:
                        dvalid += 1
                    else:
                        break
                self._dpos_h[i] = c0 + dvalid
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
            if self._spec_draft is not None:
                out["spec_tokens"] = self.spec_tokens
                out["spec_proposed"] = self._spec_proposed
                out["spec_accepted"] = self._spec_accepted
                out["spec_acceptance"] = (
                    self._spec_accepted / self._spec_proposed
                    if self._spec_proposed else 0.0)
                out["draft_steps"] = self._draft_steps
                out["draft_param_bytes"] = tree_param_bytes(
                    self._draft_params)
            return out

    def state_bytes(self) -> int:
        """Device bytes of the slot state blocks (the paged pool and its
        page tables, the draft's blocks with a draft)."""
        with self._lock:
            total = tree_param_bytes(self._blocks)
            if self._pool is not None:
                total += self._table_h.nbytes
            if self._draft_blocks is not None:
                total += tree_param_bytes(self._draft_blocks)
            return total

    def idle(self) -> bool:
        """No queued or active session: an engine of a version no longer
        active may retire exactly then."""
        with self._lock:
            return not self._queue and not self._active_count()

    def drain(self, timeout_s: float = 60.0) -> None:
        """Block until every queued and active session has finished; raises
        ``TimeoutError`` after ``timeout_s``."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.idle():
                return
            time.sleep(0.002)
        raise TimeoutError("decode engine did not drain in time")

    def close(self, timeout_s: float = 30.0) -> None:
        """Stop accepting sessions; the pump drains what is queued first."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout_s)
