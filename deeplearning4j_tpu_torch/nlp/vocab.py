"""Vocabulary construction + Huffman coding.

Reference: models/word2vec/wordstore/VocabConstructor.java:33 (parallel count +
min-frequency filter + Huffman tree), models/word2vec/Huffman.java,
wordstore/inmemory/AbstractCache.java (word<->index maps, counts).

Counterpart of ``deeplearning4j_tpu/nlp/vocab.py``: host code. The file
counter of :meth:`VocabConstructor.build_from_file` is the port's own host
runtime (``nativert.count_tokens_file``); a runtime that fails to build
raises, and ``None`` (text with non-ASCII bytes) hands the file to the
Python tokenizer, as in the JAX package.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Dict, Iterable, List, Optional, Sequence

MAX_CODE_LENGTH = 40  # classic word2vec bound (reference Huffman.java MAX_CODE_LENGTH)


class VocabWord:
    """reference models/word2vec/VocabWord.java — element with frequency,
    Huffman code/points, and index."""

    __slots__ = ("word", "count", "index", "code", "points", "labels")

    def __init__(self, word: str, count: float = 1.0):
        self.word = word
        self.count = count
        self.index = -1
        self.code: List[int] = []
        self.points: List[int] = []
        self.labels: List[str] = []

    def __repr__(self):
        return f"VocabWord({self.word!r}, count={self.count}, index={self.index})"


class VocabCache:
    """In-memory vocab store (reference AbstractCache/InMemoryLookupCache)."""

    def __init__(self):
        self._words: Dict[str, VocabWord] = {}
        self._index: List[VocabWord] = []
        self.total_word_count = 0.0

    # ------------------------------------------------------------------ build
    def add_token(self, word: str, count: float = 1.0) -> VocabWord:
        vw = self._words.get(word)
        if vw is None:
            vw = VocabWord(word, 0.0)
            self._words[word] = vw
        vw.count += count
        self.total_word_count += count
        return vw

    def finish(self, min_word_frequency: int = 1,
               special: Sequence[str] = ()) -> None:
        """Drop rare words and assign indices by descending frequency
        (reference VocabConstructor.buildJointVocabulary)."""
        kept = [vw for vw in self._words.values()
                if vw.count >= min_word_frequency or vw.word in special]
        kept.sort(key=lambda vw: (-vw.count, vw.word))
        self._words = {vw.word: vw for vw in kept}
        self._index = kept
        for i, vw in enumerate(kept):
            vw.index = i
        self.total_word_count = sum(vw.count for vw in kept)

    # ------------------------------------------------------------------ access
    def __contains__(self, word: str) -> bool:
        return word in self._words

    def word_for(self, word: str) -> Optional[VocabWord]:
        return self._words.get(word)

    def word_at(self, index: int) -> VocabWord:
        return self._index[index]

    def index_of(self, word: str) -> int:
        vw = self._words.get(word)
        return vw.index if vw is not None else -1

    def num_words(self) -> int:
        return len(self._index)

    def words(self) -> List[str]:
        return [vw.word for vw in self._index]

    def vocab_words(self) -> List[VocabWord]:
        return list(self._index)


def build_huffman(cache: VocabCache) -> None:
    """Assign Huffman codes+points to every vocab word (reference Huffman.java).

    points[d] is the index of the d-th inner node on the root→word path (inner
    nodes indexed into syn1); code[d] is the branch taken (0/1). Ordering matches
    the classic word2vec convention: points from root down, including the root,
    excluding the leaf.
    """
    n = cache.num_words()
    if n == 0:
        return
    # heap of (count, tiebreak, node_id); leaves are 0..n-1, inner n..2n-2
    heap: list = [(vw.count, i, i) for i, vw in enumerate(cache.vocab_words())]
    heapq.heapify(heap)
    parent: Dict[int, int] = {}
    branch: Dict[int, int] = {}
    next_id = n
    while len(heap) > 1:
        c1, _, a = heapq.heappop(heap)
        c2, _, b = heapq.heappop(heap)
        parent[a] = next_id
        parent[b] = next_id
        branch[a] = 0
        branch[b] = 1
        heapq.heappush(heap, (c1 + c2, next_id, next_id))
        next_id += 1
    root = heap[0][2] if heap else None
    for i, vw in enumerate(cache.vocab_words()):
        code: List[int] = []
        points: List[int] = []
        node = i
        while node != root and node in parent:
            code.append(branch[node])
            node = parent[node]
            points.append(node - n)  # inner-node index into syn1
        code.reverse()
        points.reverse()
        vw.code = code[:MAX_CODE_LENGTH]
        vw.points = points[:MAX_CODE_LENGTH]


class VocabConstructor:
    """Builds a VocabCache from token-sequence sources
    (reference VocabConstructor.java:33)."""

    def __init__(self, min_word_frequency: int = 1, build_huffman_tree: bool = True,
                 special: Sequence[str] = ()):
        self.min_word_frequency = min_word_frequency
        self.build_huffman_tree = build_huffman_tree
        self.special = tuple(special)

    def build_joint_vocabulary(self, sequences: Iterable[Sequence[str]]) -> VocabCache:
        cache = VocabCache()
        for seq in sequences:
            for token in seq:
                if token:
                    cache.add_token(token)
        cache.finish(self.min_word_frequency, self.special)
        if self.build_huffman_tree:
            build_huffman(cache)
        return cache

    def build_from_file(self, path: str, tokenizer_factory=None) -> VocabCache:
        """Build the vocabulary straight from a text file.

        For the default whitespace tokenizer (optionally with
        CommonPreprocessor) over ASCII corpora, counting runs in the port's
        C++ host runtime with worker threads — the analog of the reference's
        parallel VocabConstructor count phase (VocabConstructor.java:33).
        Any other tokenizer, or a file with non-ASCII bytes, goes through
        the Python pipeline, with identical results.
        """
        from .tokenization import CommonPreprocessor, DefaultTokenizerFactory

        pre = getattr(tokenizer_factory, "_pre", None)
        native_ok = tokenizer_factory is None or (
            type(tokenizer_factory) is DefaultTokenizerFactory
            and (pre is None or type(pre) is CommonPreprocessor))
        if native_ok:
            from .. import nativert
            counts = nativert.count_tokens_file(
                str(path), common_preprocess=pre is not None)
            if counts is not None:
                cache = VocabCache()
                for word, count in counts:
                    if word:
                        cache.add_token(word, float(count))
                # specials are guaranteed present (same as the callers of
                # build_joint_vocabulary, which append one occurrence each)
                for sp in self.special:
                    cache.add_token(sp)
                cache.finish(self.min_word_frequency, self.special)
                if self.build_huffman_tree:
                    build_huffman(cache)
                return cache

        if tokenizer_factory is None:
            tokenizer_factory = DefaultTokenizerFactory()
        with open(path, "r", encoding="utf-8") as f:
            seqs = (tokenizer_factory.create(line).get_tokens()
                    for line in f if line.strip())
            return self.build_joint_vocabulary(
                itertools.chain(seqs, ([sp] for sp in self.special)))
