"""SequenceVectors: the generic embedding-training engine.

Counterpart of ``deeplearning4j_tpu/nlp/sequencevectors.py`` (reference
models/sequencevectors/SequenceVectors.java:50 — fit():164-293 builds vocab,
resets weights, then streams sequences through trainSequence:295 with a
pluggable learning algorithm: SkipGram/CBOW for elements, DBOW/DM for
sequences). Pair generation stays on the host with numpy's
``default_rng(seed)`` (window shrink, subsampling), so the port builds the
same pair stream as the JAX package. Each fixed-size pair batch goes to the
model's device (``device=None`` means CUDA) in one pinned copy with its
learning rate and the negatives' uniforms, which come from the engine's own
CPU ``torch.Generator`` seeded from ``seed`` (so the card and the CPU draw
the same negatives), and one step (learning.py) updates the tables in
place.

Supports element learning (skip-gram / CBOW) and sequence learning (PV-DBOW /
PV-DM) over arbitrary token sequences — Word2Vec, ParagraphVectors and DeepWalk
are facades over this engine, as in the reference.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from ..common import resolve_device
from .learning import BatchAccumulator, chunking, make_train_step, stage
from .lookup import InMemoryLookupTable
from .vocab import VocabCache, VocabConstructor, build_huffman


class SequenceVectors:
    def __init__(self, *, vector_length: int = 100, window: int = 5,
                 use_hierarchic_softmax: bool = True, negative: int = 0,
                 learning_rate: float = 0.025, min_learning_rate: float = 1e-4,
                 epochs: int = 1, iterations: int = 1,
                 min_word_frequency: int = 1, batch_size: int = 512,
                 sampling: float = 0.0, seed: int = 42,
                 elements_learning_algorithm: str = "skipgram",
                 sequence_learning_algorithm: Optional[str] = None,
                 train_elements: bool = True, train_sequences: bool = False,
                 special_tokens: Sequence[str] = (), device=None):
        if elements_learning_algorithm not in ("skipgram", "cbow"):
            raise ValueError(f"Unknown elements algorithm: {elements_learning_algorithm}")
        if sequence_learning_algorithm not in (None, "dbow", "dm"):
            raise ValueError(f"Unknown sequence algorithm: {sequence_learning_algorithm}")
        self.vector_length = vector_length
        self.window = window
        self.use_hs = use_hierarchic_softmax
        self.negative = negative
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.epochs = epochs
        self.iterations = iterations
        self.min_word_frequency = min_word_frequency
        self.batch_size = batch_size
        self.sampling = sampling
        self.seed = seed
        self.elements_algo = elements_learning_algorithm
        self.sequence_algo = sequence_learning_algorithm
        self.train_elements = train_elements
        self.train_sequences = train_sequences
        self.special_tokens = tuple(special_tokens)
        #: where the tables live and the step runs (None: CUDA)
        self.device = resolve_device(device)

        self.vocab: Optional[VocabCache] = None
        self.lookup: Optional[InMemoryLookupTable] = None
        #: training pairs (and CBOW/DM windows) the fits have applied
        self.pairs_trained = 0
        self._np_rng = np.random.default_rng(seed)
        #: the negatives' uniforms, drawn on the CPU whatever the device
        self._gen = torch.Generator().manual_seed(seed)

    # ------------------------------------------------------------------ vocab
    def build_vocab(self, sequences: Iterable[Sequence[str]],
                    labels: Optional[Iterable[Sequence[str]]] = None) -> None:
        """Build joint vocabulary; sequence labels (for DBOW/DM) become vocab
        entries too, as in the reference (labels live in the same lookup table)."""
        all_seqs: List[Sequence[str]] = [list(s) for s in sequences]
        specials = list(self.special_tokens)
        if labels is not None:
            label_lists = [list(ls) for ls in labels]
            for ls in label_lists:
                specials.extend(ls)
        constructor = VocabConstructor(
            min_word_frequency=self.min_word_frequency,
            build_huffman_tree=False, special=specials)
        cache = constructor.build_joint_vocabulary(
            all_seqs + ([[lab] for lab in specials] if specials else []))
        build_huffman(cache)
        self.vocab = cache
        self.lookup = self._new_lookup(cache)
        self.lookup.reset_weights()

    def _new_lookup(self, cache: VocabCache) -> InMemoryLookupTable:
        return InMemoryLookupTable(
            cache, self.vector_length, seed=self.seed, use_hs=self.use_hs,
            negative=self.negative, device=self.device)

    def build_vocab_from_file(self, path: str, tokenizer_factory=None) -> None:
        """Vocabulary straight from a corpus file: the count phase runs in the
        native C++ runtime with worker threads when the tokenizer allows it
        (VocabConstructor.build_from_file), mirroring the reference's parallel
        vocab construction (VocabConstructor.java:33). Defaults to this
        vectorizer's configured tokenizer (Word2Vec.tokenizer_factory) so the
        vocab is built with the same tokenization training will use."""
        if tokenizer_factory is None:
            tokenizer_factory = getattr(self, "tokenizer_factory", None)
        constructor = VocabConstructor(
            min_word_frequency=self.min_word_frequency,
            build_huffman_tree=True, special=list(self.special_tokens))
        cache = constructor.build_from_file(path, tokenizer_factory)
        self.vocab = cache
        self.lookup = self._new_lookup(cache)
        self.lookup.reset_weights()

    # ------------------------------------------------------------------ training
    def fit(self, sequences: Iterable[Sequence[str]],
            labels: Optional[List[Sequence[str]]] = None) -> None:
        seq_list = [list(s) for s in sequences]
        if self.vocab is None:
            self.build_vocab(seq_list, labels)
        cache = self.vocab
        lt = self.lookup
        max_code = max((len(vw.code) for vw in cache.vocab_words()), default=1) or 1
        # CBOW/DM consume up to 2*window context tokens (+1 label for DM)
        W = 1 if (self.elements_algo == "skipgram" and self.sequence_algo != "dm") \
            else 2 * self.window + 1
        step = make_train_step(self.use_hs, self.negative)
        acc = BatchAccumulator(self.batch_size, W, max_code, cache.num_words())

        total_words = sum(len(s) for s in seq_list) * self.epochs * self.iterations
        processed = 0
        alpha = self.learning_rate
        dev = lt.syn0.device
        cum = lt.cum_table if lt.cum_table is not None else torch.zeros(
            (1,), dtype=torch.float32, device=dev)
        # the tables the step's route leaves alone, when the model has none
        syn1, syn1neg = (
            t if t is not None else torch.zeros(
                (1, self.vector_length), dtype=torch.float32, device=dev)
            for t in (lt.syn1, lt.syn1neg))
        C, S = chunking(self.batch_size, 64)

        def run(batch):
            u = (torch.rand((C, S, self.negative), generator=self._gen)
                 .numpy() if self.negative > 0 else None)
            staged, lr, u_dev = stage(batch, dev, alpha, u)
            self.pairs_trained += int(batch.pair_mask.sum())
            step(lt.syn0, syn1, syn1neg, cum, staged, lr, u_dev)

        for _ in range(self.epochs):
            for si, seq in enumerate(seq_list):
                for _ in range(self.iterations):
                    seq_labels = (labels[si] if labels and si < len(labels) else [])
                    processed += len(seq)
                    alpha = max(
                        self.min_learning_rate,
                        self.learning_rate * (1 - processed / max(1, total_words)))
                    for batch in self._train_sequence(seq, seq_labels, acc):
                        run(batch)
        final = acc.flush()
        if final is not None:
            run(final)

    def _train_sequence(self, seq: Sequence[str], seq_labels: Sequence[str], acc):
        """Generate training pairs for one sequence (reference trainSequence:295 →
        SkipGram/CBOW.learnSequence). Dynamic window shrink + subsampling as in
        word2vec."""
        cache = self.vocab
        idxs = [cache.index_of(t) for t in seq]
        idxs = [i for i in idxs if i >= 0]
        if self.sampling > 0:
            total = cache.total_word_count
            kept = []
            for i in idxs:
                f = cache.word_at(i).count / total
                keep_p = (np.sqrt(f / self.sampling) + 1) * (self.sampling / f)
                if keep_p >= 1.0 or self._np_rng.random() < keep_p:
                    kept.append(i)
            idxs = kept
        label_idxs = [cache.index_of(l) for l in seq_labels]
        label_idxs = [i for i in label_idxs if i >= 0]

        for pos, center in enumerate(idxs):
            b = int(self._np_rng.integers(0, self.window))  # dynamic window
            lo = max(0, pos - (self.window - b))
            hi = min(len(idxs), pos + (self.window - b) + 1)
            context = [idxs[j] for j in range(lo, hi) if j != pos]
            vw = cache.word_at(center)
            if self.train_elements:
                if self.elements_algo == "skipgram":
                    # each context token predicts the center word
                    for c in context:
                        batch = acc.add([c], center, vw.points, vw.code)
                        if batch is not None:
                            yield batch
                else:  # cbow: masked mean of context predicts center
                    if context:
                        batch = acc.add(context, center, vw.points, vw.code)
                        if batch is not None:
                            yield batch
            if self.train_sequences and label_idxs:
                for lab in label_idxs:
                    if self.sequence_algo == "dbow":
                        # doc vector predicts each word (PV-DBOW)
                        batch = acc.add([lab], center, vw.points, vw.code)
                    else:
                        # PV-DM: doc vector + context mean predicts center
                        batch = acc.add(context + [lab], center, vw.points, vw.code)
                    if batch is not None:
                        yield batch

    # ------------------------------------------------------------------ vectors API
    def get_word_vector(self, word: str) -> Optional[np.ndarray]:
        return self.lookup.vector(word) if self.lookup else None

    def _normed_syn0(self) -> np.ndarray:
        syn0 = self.lookup.syn0.cpu().numpy()
        norms = np.linalg.norm(syn0, axis=1, keepdims=True)
        return syn0 / np.maximum(norms, 1e-12)

    def similarity(self, w1: str, w2: str) -> float:
        v1, v2 = self.get_word_vector(w1), self.get_word_vector(w2)
        if v1 is None or v2 is None:
            return float("nan")
        denom = np.linalg.norm(v1) * np.linalg.norm(v2)
        return float(np.dot(v1, v2) / max(denom, 1e-12))

    def words_nearest(self, word_or_vec, top_n: int = 10) -> List[str]:
        if isinstance(word_or_vec, str):
            vec = self.get_word_vector(word_or_vec)
            exclude = {word_or_vec}
        else:
            vec = np.asarray(word_or_vec)
            exclude = set()
        if vec is None:
            return []
        normed = self._normed_syn0()
        sims = normed @ (vec / max(np.linalg.norm(vec), 1e-12))
        order = np.argsort(-sims)
        out = []
        for i in order:
            w = self.vocab.word_at(int(i)).word
            if w not in exclude:
                out.append(w)
            if len(out) >= top_n:
                break
        return out
