"""Distributed Word2Vec/GloVe-style training: TextPipeline + param averaging.

Reference: deeplearning4j-scaleout dl4j-spark-nlp (SURVEY.md §2.4) —
`TextPipeline` (tokenize + vocab build via Spark accumulators, broadcast
vocab) and spark/models/embeddings/word2vec/Word2Vec.java:61 (per-partition
First/SecondIterationFunction skip-gram training, averaging on the master).

The corpus is sharded across ``num_workers`` logical workers; each worker
trains the skip-gram/CBOW step (nlp/learning.py) over its shard starting
from the broadcast parameters, and after every averaging round the
workers' {syn0, syn1, syn1neg} are averaged — the BSP parameter-averaging
semantics of the Spark master.

Counterpart of ``deeplearning4j_tpu/nlp/distributed.py``. The workers run
one after another in one process, on the model's device (``device=`` among
the Word2Vec keywords; None means CUDA). Each worker trains on its own
clone of the broadcast tables, since the step updates them in place, and
the mean is the JAX package's: the sum in worker order over the count.
"""
from __future__ import annotations

import copy
from concurrent.futures import ThreadPoolExecutor
from collections import Counter
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from .lookup import InMemoryLookupTable
from .tokenization import (
    CommonPreprocessor, DefaultTokenizerFactory, TokenizerFactory,
)
from .vocab import VocabCache, VocabConstructor, build_huffman
from .word2vec import Word2Vec


class TextPipeline:
    """Corpus -> token sequences + vocabulary (reference spark TextPipeline:
    tokenization and word counts accumulate in parallel, then the vocab is
    'broadcast' — here: shared by reference)."""

    def __init__(self, tokenizer_factory: Optional[TokenizerFactory] = None,
                 min_word_frequency: int = 1, num_workers: int = 4):
        if tokenizer_factory is None:
            tokenizer_factory = DefaultTokenizerFactory()
            tokenizer_factory.set_token_pre_processor(CommonPreprocessor())
        self.tokenizer_factory = tokenizer_factory
        self.min_word_frequency = min_word_frequency
        self.num_workers = max(1, num_workers)

    def tokenize(self, sentences: Iterable[str]) -> List[List[str]]:
        sents = list(sentences)
        chunk = max(1, len(sents) // self.num_workers)
        chunks = [sents[i:i + chunk] for i in range(0, len(sents), chunk)]

        def work(part: List[str]) -> List[List[str]]:
            return [self.tokenizer_factory.create(s).get_tokens()
                    for s in part]

        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            parts = list(ex.map(work, chunks))
        return [t for part in parts for t in part]

    def word_counts(self, token_seqs: List[List[str]]) -> Counter:
        chunk = max(1, len(token_seqs) // self.num_workers)
        chunks = [token_seqs[i:i + chunk]
                  for i in range(0, len(token_seqs), chunk)]

        def count(part) -> Counter:
            c: Counter = Counter()
            for seq in part:
                c.update(seq)
            return c

        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            counters = list(ex.map(count, chunks))
        total: Counter = Counter()
        for c in counters:
            total.update(c)
        return total

    def build_vocab(self, token_seqs: List[List[str]]) -> VocabCache:
        constructor = VocabConstructor(
            min_word_frequency=self.min_word_frequency,
            build_huffman_tree=False)
        cache = constructor.build_joint_vocabulary(token_seqs)
        build_huffman(cache)
        return cache


class SparkWord2Vec:
    """Parameter-averaging distributed Word2Vec (reference dl4j-spark-nlp
    Word2Vec). Named for parity; the workers run in one process, not on
    Spark."""

    def __init__(self, num_workers: int = 4, averaging_rounds: int = 1,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 **word2vec_kwargs):
        self.num_workers = max(1, num_workers)
        self.averaging_rounds = max(1, averaging_rounds)
        self.pipeline = TextPipeline(tokenizer_factory,
                                     word2vec_kwargs.get("min_word_frequency", 1),
                                     self.num_workers)
        self._kw = dict(word2vec_kwargs)
        self._kw.setdefault("epochs", 1)
        self.master: Optional[Word2Vec] = None

    # ------------------------------------------------------------------ training
    def fit(self, sentences: Iterable[str]) -> "SparkWord2Vec":
        token_seqs = self.pipeline.tokenize(sentences)
        cache = self.pipeline.build_vocab(token_seqs)

        self.master = Word2Vec(**self._kw)
        self.master.vocab = cache
        self.master.lookup = InMemoryLookupTable(
            cache, self.master.vector_length, seed=self.master.seed,
            use_hs=self.master.use_hs, negative=self.master.negative,
            device=self.master.device)
        self.master.lookup.reset_weights()

        shards = [token_seqs[i::self.num_workers]
                  for i in range(self.num_workers)]
        shards = [s for s in shards if s]
        for _ in range(self.averaging_rounds):
            results = []
            for widx, shard in enumerate(shards):
                worker = Word2Vec(**{**self._kw, "seed":
                                     self.master.seed + widx})
                worker.vocab = cache                      # broadcast vocab
                worker.lookup = _clone_lookup(self.master.lookup)  # broadcast
                worker.fit(shard)
                results.append(worker.lookup)
            # BSP average (reference processResults: params / count)
            lt = self.master.lookup
            lt.syn0 = _mean([r.syn0 for r in results])
            if lt.syn1 is not None:
                lt.syn1 = _mean([r.syn1 for r in results])
            if lt.syn1neg is not None:
                lt.syn1neg = _mean([r.syn1neg for r in results])
        return self

    # ------------------------------------------------------------------ queries
    def get_word_vector(self, word: str) -> Optional[np.ndarray]:
        return self.master.lookup.vector(word)

    def similarity(self, a: str, b: str) -> float:
        va, vb = self.get_word_vector(a), self.get_word_vector(b)
        if va is None or vb is None:
            return float("nan")
        na = np.linalg.norm(va) * np.linalg.norm(vb)
        return float(np.dot(va, vb) / na) if na else 0.0

    def words_nearest(self, word: str, n: int = 5) -> List[str]:
        v = self.get_word_vector(word)
        if v is None:
            return []
        lt = self.master.lookup
        syn0 = lt.syn0.cpu().numpy()
        norms = np.linalg.norm(syn0, axis=1) * (np.linalg.norm(v) or 1.0)
        sims = syn0 @ v / np.maximum(norms, 1e-12)
        order = np.argsort(-sims)
        words = [self.master.vocab.word_at(int(i)).word for i in order]
        return [w for w in words if w != word][:n]


def _clone_lookup(lt):
    """Copies of the broadcast tables: the step updates its tables in
    place, so each worker must own its own."""
    new = copy.copy(lt)
    new.syn0 = lt.syn0.clone()
    if lt.syn1 is not None:
        new.syn1 = lt.syn1.clone()
    if lt.syn1neg is not None:
        new.syn1neg = lt.syn1neg.clone()
    return new


def _mean(arrays: Sequence) -> torch.Tensor:
    out = arrays[0]
    for a in arrays[1:]:
        out = out + a
    return out / len(arrays)
