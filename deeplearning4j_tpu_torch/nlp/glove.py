"""GloVe embeddings.

Reference: models/glove/Glove.java (438 LoC) + glove/count/ (cooccurrence
counting). Host-side symmetric-window cooccurrence counting with 1/distance
weighting, then batched AdaGrad updates on shuffled (i, j, Xij) batches —
the reference's per-pair AdaGrad loop becomes one batched device step.

Counterpart of ``deeplearning4j_tpu/nlp/glove.py``. Counting, the numpy
init and the permutation are the JAX package's; the AdaGrad step runs on
the model's device in the same order (the histories accumulate first, the
updates read them back). Each batch moves in one pinned copy. The last
batch is padded, as in JAX, with pairs drawn at random from the real ones
(the JAX comment's "weight 0" does not hold: the padding pairs train).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from .sequencevectors import SequenceVectors


class Glove(SequenceVectors):
    def __init__(self, *, x_max: float = 100.0, alpha: float = 0.75,
                 learning_rate: float = 0.05, symmetric: bool = True, **kwargs):
        kwargs.setdefault("learning_rate", learning_rate)
        kwargs.setdefault("use_hierarchic_softmax", False)
        super().__init__(**kwargs)
        self.x_max = x_max
        self.alpha = alpha
        self.symmetric = symmetric
        self.bias: Optional[torch.Tensor] = None
        self.bias_ctx: Optional[torch.Tensor] = None
        self.ctx_vectors: Optional[torch.Tensor] = None

    # ------------------------------------------------------------------ builder
    class Builder:
        def __init__(self):
            self._kw = {}

        def layer_size(self, n: int):
            self._kw["vector_length"] = n
            return self

        def window_size(self, n: int):
            self._kw["window"] = n
            return self

        def learning_rate(self, lr: float):
            self._kw["learning_rate"] = lr
            return self

        def epochs(self, n: int):
            self._kw["epochs"] = n
            return self

        def min_word_frequency(self, n: int):
            self._kw["min_word_frequency"] = n
            return self

        def x_max(self, v: float):
            self._kw["x_max"] = v
            return self

        def alpha(self, v: float):
            self._kw["alpha"] = v
            return self

        def symmetric(self, flag: bool):
            self._kw["symmetric"] = flag
            return self

        def seed(self, s: int):
            self._kw["seed"] = s
            return self

        def batch_size(self, n: int):
            self._kw["batch_size"] = n
            return self

        def device(self, device):
            """Where the vectors live and the step runs (None: CUDA)."""
            self._kw["device"] = device
            return self

        def build(self) -> "Glove":
            return Glove(**self._kw)

    @staticmethod
    def builder() -> "Glove.Builder":
        return Glove.Builder()

    # ------------------------------------------------------------------ training
    def _count_cooccurrences(self, seqs: List[List[int]]):
        counts: dict = defaultdict(float)
        for seq in seqs:
            for pos, w in enumerate(seq):
                lo = max(0, pos - self.window)
                for j in range(lo, pos):
                    c = seq[j]
                    weight = 1.0 / (pos - j)
                    counts[(w, c)] += weight
                    if self.symmetric:
                        counts[(c, w)] += weight
        return counts

    def fit(self, sequences: Iterable[Sequence[str]], labels=None) -> None:
        seq_list = [list(s) for s in sequences]
        if self.vocab is None:
            self.build_vocab(seq_list)
        cache = self.vocab
        n, d = cache.num_words(), self.vector_length
        idx_seqs = [[cache.index_of(t) for t in s] for s in seq_list]
        idx_seqs = [[i for i in s if i >= 0] for s in idx_seqs]
        counts = self._count_cooccurrences(idx_seqs)
        if not counts:
            return
        pairs = np.array(list(counts.keys()), np.int32)
        xij = np.array(list(counts.values()), np.float32)

        rng = np.random.default_rng(self.seed)
        dev = self.device

        def on_dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        w = on_dev((rng.random((n, d), np.float32) - 0.5) / d)
        wc = on_dev((rng.random((n, d), np.float32) - 0.5) / d)
        b = torch.zeros((n,), dtype=torch.float32, device=dev)
        bc = torch.zeros((n,), dtype=torch.float32, device=dev)
        hist = tuple(torch.ones(s, dtype=torch.float32, device=dev)
                     for s in ((n, d), (n, d), (n,), (n,)))

        x_max, alpha, lr = self.x_max, self.alpha, self.learning_rate

        @torch.no_grad()
        def glove_step(w, wc, b, bc, hist, wi, ci, x):
            """One AdaGrad step on the batch, in place."""
            hw, hwc, hb, hbc = hist
            vi, vj = w[wi], wc[ci]                  # (B, D)
            diff = (torch.sum(vi * vj, -1) + b[wi] + bc[ci] - torch.log(x))
            fx = torch.clamp((x / x_max) ** alpha, max=1.0)
            g = fx * diff                            # (B,)
            gw = g[:, None] * vj
            gwc = g[:, None] * vi
            # AdaGrad: accumulate squared grads then scale
            hw.index_add_(0, wi, gw * gw)
            hwc.index_add_(0, ci, gwc * gwc)
            hb.index_add_(0, wi, g * g)
            hbc.index_add_(0, ci, g * g)
            w.index_add_(0, wi, -lr * gw / torch.sqrt(hw[wi]))
            wc.index_add_(0, ci, -lr * gwc / torch.sqrt(hwc[ci]))
            b.index_add_(0, wi, -lr * g / torch.sqrt(hb[wi]))
            bc.index_add_(0, ci, -lr * g / torch.sqrt(hbc[ci]))

        B = self.batch_size
        n_pairs = pairs.shape[0]
        pinned = dev.type == "cuda"
        for _ in range(self.epochs):
            order = rng.permutation(n_pairs)
            for s in range(0, n_pairs, B):
                sel = order[s:s + B]
                if len(sel) < B:  # pad to fixed shape with real pairs
                    pad = rng.integers(0, n_pairs, B - len(sel))
                    sel = np.concatenate([sel, pad])
                host = torch.empty(3 * B, dtype=torch.int32,
                                   pin_memory=pinned)
                hv = host.numpy()
                hv[:B], hv[B:2 * B] = pairs[sel, 0], pairs[sel, 1]
                hv[2 * B:] = xij[sel].view(np.int32)
                staged = host.to(dev, non_blocking=True)
                glove_step(w, wc, b, bc, hist, staged[:B], staged[B:2 * B],
                           staged[2 * B:].view(torch.float32))

        self.lookup.syn0 = w + wc  # GloVe convention: sum of word+context vectors
        self.ctx_vectors = wc
        self.bias, self.bias_ctx = b, bc
