"""Word-vector serialization.

Reference: models/embeddings/loader/WordVectorSerializer.java — text format
("word v1 v2 ... vD" per line, optional "count dim" header) and the original
word2vec binary format (header "n d\\n", then word + space + d float32 LE).

Counterpart of ``deeplearning4j_tpu/nlp/serializer.py``: the files are
byte for byte the JAX package's for the same vectors, and each package
reads the other's. :func:`read_word_vectors` places the table on
``device`` (None means CUDA).
"""
from __future__ import annotations

import numpy as np
import torch

from .lookup import InMemoryLookupTable
from .sequencevectors import SequenceVectors
from .vocab import VocabCache, build_huffman


def write_word_vectors(model: SequenceVectors, path: str,
                       binary: bool = False) -> None:
    cache, lt = model.vocab, model.lookup
    syn0 = lt.syn0.cpu().numpy()
    n, d = syn0.shape
    if binary:
        with open(path, "wb") as f:
            f.write(f"{n} {d}\n".encode())
            for i in range(n):
                word = cache.word_at(i).word
                f.write(word.encode("utf-8") + b" ")
                f.write(syn0[i].astype("<f4").tobytes())
                f.write(b"\n")
    else:
        with open(path, "w", encoding="utf-8") as f:
            f.write(f"{n} {d}\n")
            for i in range(n):
                vec = " ".join(f"{v:.6f}" for v in syn0[i])
                f.write(f"{cache.word_at(i).word} {vec}\n")


def read_word_vectors(path: str, binary: bool = False, *,
                      device=None) -> SequenceVectors:
    words: list = []
    vecs: list = []
    if binary:
        with open(path, "rb") as f:
            header = f.readline().decode()
            n, d = (int(x) for x in header.split())
            for _ in range(n):
                chars = bytearray()
                while True:
                    ch = f.read(1)
                    if ch in (b" ", b""):
                        break
                    chars.extend(ch)
                word = chars.decode("utf-8")
                vec = np.frombuffer(f.read(4 * d), dtype="<f4")
                f.read(1)  # trailing newline
                words.append(word)
                vecs.append(vec)
    else:
        with open(path, "r", encoding="utf-8") as f:
            first = f.readline().split()
            if len(first) == 2 and all(t.lstrip("-").isdigit() for t in first):
                n, d = int(first[0]), int(first[1])
            else:  # headerless: first line is already a vector row
                words.append(first[0])
                vecs.append(np.array([float(x) for x in first[1:]], np.float32))
            for line in f:
                parts = line.rstrip("\n").split(" ")
                if len(parts) < 2:
                    continue
                words.append(parts[0])
                vecs.append(np.array([float(x) for x in parts[1:]], np.float32))

    d = len(vecs[0]) if vecs else 0
    model = SequenceVectors(vector_length=d, device=device)
    cache = VocabCache()
    for i, w in enumerate(words):
        # counts descend with rank so Huffman/neg-sampling stay well-defined
        cache.add_token(w, count=float(len(words) - i))
    cache.finish(min_word_frequency=0)
    build_huffman(cache)
    model.vocab = cache
    model.lookup = InMemoryLookupTable(cache, d, device=model.device)
    # respect the file's word order (finish() sorts by count, which preserves it)
    syn0 = np.zeros((len(words), d), np.float32)
    for w, v in zip(words, vecs):
        syn0[cache.index_of(w)] = v
    model.lookup.syn0 = torch.from_numpy(syn0).to(model.device)
    return model
