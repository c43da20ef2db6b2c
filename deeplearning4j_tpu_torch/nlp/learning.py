"""The batched skip-gram / CBOW training step.

Counterpart of ``deeplearning4j_tpu/nlp/learning.py`` (reference
models/embeddings/learning/impl/elements/{SkipGram,CBOW}.java, which queue
AggregateSkipGram ops and execute the batch natively, SkipGram.java:
168-178). One step takes a fixed-shape batch of training pairs and updates
the embedding tables in place with gathers and scatter-adds. Hierarchical
softmax (:225) and negative sampling (:258) are both supported; CBOW and
PV-DM reuse the same step with multi-token inputs (a masked mean).

Update convention as classic word2vec and the reference: for a pair the
input vector is h = mean(syn0[ctx]) (one token for skip-gram), the outputs
are the target word's Huffman path (syn1) and/or sampled negatives
(syn1neg); g = (label - sigmoid(h.v)) * lr; each input token receives the
whole accumulated gradient (no 1/n on the backward, as in word2vec C).

The JAX step is one compiled program that applies the batch in sequential
chunks of ``chunk`` pairs (a ``lax.scan``): frequent rows (the Huffman
root is in nearly every pair) would otherwise take hundreds of colliding
updates computed from one stale snapshot. Here the step is one function
over the batch that loops its chunks in order, with fixed shapes and no
host synchronisation inside (no ``.item()``, no shape that depends on the
data), the plain PyTorch of what XLA computes. The JAX package has no
Pallas kernel on this path.

Out-of-range indices keep the JAX semantics, where PyTorch would raise on
the CPU and assert on the card:

* a scatter drops an index outside ``[0, rows)`` (JAX ``mode="drop"``):
  padding pairs scatter to row ``n_words``, and a negative drawn at or
  above the float32 ``cum_table[-1]`` (which can round below 1.0) is
  ``len(cum_table)``. The update of such an index is multiplied by zero
  and added to row 0, which leaves every value as it was;
* a gather clamps an index to the last row (JAX's gather): that negative
  reads row ``n - 1``;
* duplicate indices accumulate, on both routes.

The negatives' uniforms are an argument, ``u`` of shape ``(C, S, k)``, one
slice per chunk: :class:`~.sequencevectors.SequenceVectors` draws them
from its own CPU generator, so the card and the CPU draw the same
negatives, and a test can hand the step exactly the uniforms JAX draws
(``jax.random.split(key, C)``, then ``uniform(k_c, (S, k))`` per chunk).
:func:`stage` moves a batch, the learning rate and the uniforms to the
device in one pinned, non-blocking copy.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F


class PairBatch(NamedTuple):
    """One padded batch of training pairs: numpy arrays as the host
    assembles them (:class:`BatchAccumulator`), tensors on the device once
    :func:`stage` has moved them."""

    ctx: object        # (B, W) int32 input-token indices
    ctx_mask: object   # (B, W) float32 — 1 for real input tokens
    target: object     # (B,) int32 target-word indices
    points: object     # (B, L) int32 Huffman inner-node indices (HS)
    codes: object      # (B, L) float32 Huffman branch codes (HS)
    code_mask: object  # (B, L) float32 — 1 for real code positions
    pair_mask: object  # (B,) float32 — 1 for real (non-padding) pairs
    update_dest: object  # (B, W) int32 where input-gradients are scattered


#: vocab-size ceiling of the dense one-hot-matmul update route when a step
#: is built with ``dense_update=None``: 0, the JAX package's default, so the
#: scatter route runs (its env overrides of a TPU trade-off,
#: ``DL4J_W2V_DENSE*`` and ``DL4J_W2V_CHUNK``, are not carried over)
DENSE_UPDATE_MAX_VOCAB = 0


def resolve_dense_update(n_words: int) -> bool:
    """Whether a step built with ``dense_update=None`` takes the dense
    route for a vocab of ``n_words``: only at or under the ceiling."""
    return n_words <= DENSE_UPDATE_MAX_VOCAB


_INTS = ("ctx", "target", "points", "update_dest")
_FLOATS = ("ctx_mask", "codes", "code_mask", "pair_mask")


def chunking(batch_rows: int, chunk: int) -> tuple:
    """``(C, S)``: the step applies a batch of ``batch_rows`` pairs as ``C``
    chunks of ``S`` (the JAX step's sizing: ``S = min(chunk, B)``, the
    whole batch when ``S`` does not divide it)."""
    S = min(chunk, batch_rows)
    if batch_rows % S != 0:
        S = batch_rows
    return batch_rows // S, S


def stage(batch: PairBatch, device, lr: float,
          u: Optional[np.ndarray] = None) -> tuple:
    """``(batch, lr, u)`` on ``device``: a host batch, the learning rate (a
    float32 scalar tensor) and the negatives' uniforms moved in one copy
    of one buffer, pinned and non-blocking on the card; the fields are
    views of it."""
    device = torch.device(device)
    parts = [np.ascontiguousarray(getattr(batch, f), np.int32).reshape(-1)
             for f in _INTS]
    floats = [np.asarray(getattr(batch, f), np.float32).reshape(-1)
              for f in _FLOATS]
    floats.append(np.asarray([lr], np.float32))
    if u is not None:
        floats.append(np.asarray(u, np.float32).reshape(-1))
    parts += [f.view(np.int32) for f in floats]
    sizes = [p.size for p in parts]
    host = torch.empty(sum(sizes), dtype=torch.int32,
                       pin_memory=device.type == "cuda")
    host.numpy()[:] = np.concatenate(parts)
    dev = host.to(device, non_blocking=True)
    views, at = [], 0
    for n in sizes:
        views.append(dev[at:at + n])
        at += n
    out = {}
    for f, v in zip(_INTS, views[:4]):
        out[f] = v.view(np.shape(getattr(batch, f)))
    for f, v in zip(_FLOATS, views[4:8]):
        out[f] = v.view(torch.float32).view(np.shape(getattr(batch, f)))
    lr_t = views[8].view(torch.float32)[0]
    u_t = (views[9].view(torch.float32).view(np.shape(u))
           if u is not None else None)
    return PairBatch(**out), lr_t, u_t


def _scatter_add(table: torch.Tensor, idx_flat: torch.Tensor,
                 upd_flat: torch.Tensor, dense: bool) -> torch.Tensor:
    """``table[idx] += upd`` in place, with the same meaning on both
    routes: duplicate indices accumulate, an index outside ``[0, rows)`` is
    dropped (its update, times zero, goes to row 0). ``dense`` takes a
    one-hot matmul instead of ``index_add_``."""
    n = table.shape[0]
    keep = (idx_flat >= 0) & (idx_flat < n)
    safe = torch.where(keep, idx_flat, torch.zeros_like(idx_flat))
    upd = upd_flat * keep.unsqueeze(1).to(upd_flat.dtype)
    if dense:
        oh = F.one_hot(safe.long(), n).to(upd.dtype)
        table.add_(torch.einsum("nv,nd->vd", oh, upd))
    else:
        table.index_add_(0, safe, upd)
    return table


def make_train_step(use_hs: bool, negative: int, chunk: int = 64,
                    dense_update: Optional[bool] = None):
    """Returns ``step(syn0, syn1, syn1neg, cum_table, batch, lr, u)``,
    which updates the three tables in place (and returns them) from a
    staged batch, in chunks of ``chunk`` pairs applied in order.

    ``u`` holds the negatives' uniforms ``(C, S, negative)`` for the
    ``C`` chunks of ``S`` pairs (:func:`chunking`); None when
    ``negative`` is 0. ``dense_update=True`` routes the table updates
    through one-hot matmuls; None asks :func:`resolve_dense_update`, which
    takes the scatter route (the JAX package's default)."""

    def apply_chunk(syn0, syn1, syn1neg, cum_table, b: PairBatch, lr, u):
        S, _ = b.ctx.shape
        d = syn0.shape[1]
        dense = (dense_update if dense_update is not None
                 else resolve_dense_update(syn0.shape[0]))
        ctx_vecs = syn0[b.ctx]                            # (S, W, D)
        cmask = b.ctx_mask.unsqueeze(-1)                  # (S, W, 1)
        counts = torch.clamp(b.ctx_mask.sum(1, keepdim=True), min=1.0)
        h = (ctx_vecs * cmask).sum(1) / counts            # (S, D) masked mean
        neu1e = torch.zeros((S, d), dtype=syn0.dtype, device=syn0.device)
        pmask = b.pair_mask.unsqueeze(1)

        if use_hs:
            p_vecs = syn1[b.points]                       # (S, L, D)
            f = torch.sigmoid(torch.einsum("bd,bld->bl", h, p_vecs))
            # word2vec label = 1 - code
            g = (1.0 - b.codes - f) * lr * b.code_mask * pmask   # (S, L)
            neu1e = neu1e + torch.einsum("bl,bld->bd", g, p_vecs)
            dsyn1 = torch.einsum("bl,bd->bld", g, h)
            _scatter_add(syn1, b.points.reshape(-1), dsyn1.reshape(-1, d),
                         dense)

        if negative > 0:
            k = negative
            negs = torch.searchsorted(cum_table, u, out_int32=True)  # (S, k)
            tgts = torch.cat([b.target.unsqueeze(1), negs], 1)       # (S, 1+k)
            labels = torch.cat(
                [torch.ones((S, 1), dtype=h.dtype, device=h.device),
                 torch.zeros((S, k), dtype=h.dtype, device=h.device)], 1)
            # sampled negative == true target => skip (word2vec: continue)
            valid = torch.cat(
                [torch.ones((S, 1), dtype=torch.bool, device=h.device),
                 negs != b.target.unsqueeze(1)], 1)
            # a gather clamps to the last row, as JAX's does
            n_vecs = syn1neg[torch.clamp(tgts, max=syn1neg.shape[0] - 1)]
            f = torch.sigmoid(torch.einsum("bd,bkd->bk", h, n_vecs))
            g = (labels - f) * lr * valid.to(h.dtype) * pmask       # (S, 1+k)
            neu1e = neu1e + torch.einsum("bk,bkd->bd", g, n_vecs)
            dneg = torch.einsum("bk,bd->bkd", g, h)
            _scatter_add(syn1neg, tgts.reshape(-1), dneg.reshape(-1, d),
                         dense)

        # scatter the accumulated input gradient to every real input token
        upd = neu1e.unsqueeze(1) * cmask * b.pair_mask.view(-1, 1, 1)
        _scatter_add(syn0, b.update_dest.reshape(-1), upd.reshape(-1, d),
                     dense)

    @torch.no_grad()
    def step(syn0, syn1, syn1neg, cum_table, batch: PairBatch, lr, u=None):
        C, S = chunking(batch.ctx.shape[0], chunk)
        for c in range(C):
            rows = slice(c * S, (c + 1) * S)
            part = PairBatch(*(t[rows] for t in batch))
            apply_chunk(syn0, syn1, syn1neg, cum_table, part, lr,
                        None if u is None else u[c])
        return syn0, syn1, syn1neg

    return step


class BatchAccumulator:
    """Host-side pair accumulator producing fixed-shape :class:`PairBatch`
    es of numpy arrays (replaces the reference's Aggregate op queue; fixed
    shapes keep the step's shapes fixed)."""

    def __init__(self, batch_size: int, window_width: int, code_length: int,
                 n_words: int):
        self.B = batch_size
        self.W = window_width
        self.L = code_length
        self.n_words = n_words
        self._rows: list = []

    def add(self, ctx_indices, target_idx: int, points, codes,
            update_dest=None) -> Optional[PairBatch]:
        self._rows.append((ctx_indices, target_idx, points, codes,
                           update_dest if update_dest is not None
                           else ctx_indices))
        if len(self._rows) >= self.B:
            return self.flush()
        return None

    def flush(self) -> Optional[PairBatch]:
        if not self._rows:
            return None
        B, W, L = self.B, self.W, self.L
        ctx = np.zeros((B, W), np.int32)
        cmask = np.zeros((B, W), np.float32)
        tgt = np.zeros((B,), np.int32)
        pts = np.zeros((B, L), np.int32)
        codes = np.zeros((B, L), np.float32)
        pmask = np.zeros((B, L), np.float32)
        pair_mask = np.zeros((B,), np.float32)
        # out of range: dropped by the scatter
        dest = np.full((B, W), self.n_words, np.int32)
        for i, (c, t, p, cd, ud) in enumerate(self._rows):
            nc = min(len(c), W)
            ctx[i, :nc] = c[:nc]
            cmask[i, :nc] = 1.0
            dest[i, :nc] = ud[:nc]
            tgt[i] = t
            npts = min(len(p), L)
            pts[i, :npts] = p[:npts]
            codes[i, :npts] = cd[:npts]
            pmask[i, :npts] = 1.0
            pair_mask[i] = 1.0
        self._rows = []
        return PairBatch(ctx, cmask, tgt, pts, codes, pmask, pair_mask, dest)
