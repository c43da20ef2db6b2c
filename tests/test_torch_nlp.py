"""The port's embedding engine (``deeplearning4j_tpu_torch/nlp``) held
against the JAX package's (``deeplearning4j_tpu/nlp``) on the CPU.

- Vocab and Huffman: words, counts, indices, codes and points exactly
  equal, from sequences and from a file (the host runtime's counter on
  ASCII text, the Python tokenizer on non-ASCII text).
- One step of ``make_train_step`` in each mode (HS, negatives, HS with
  negatives, CBOW with masked rows, and a batch that hits the JAX clamp and
  drop: padding rows that scatter to ``n_words`` and a ``cum_table`` whose
  last entry is 0.5, under uniforms above it): the port takes exactly the
  uniforms the JAX step draws; every table within 1e-6 of its largest
  value.
- Whole fits from the same seed, within 1e-4 relative (norm) on the
  vectors: Word2Vec HS skip-gram and CBOW, ParagraphVectors DBOW and
  ``infer_vector``, GloVe, ``SparkWord2Vec`` with 2 workers. Word2Vec with
  negatives is held step by step only: JAX draws its negatives with
  ``jax.random``.
- Word-vector files byte for byte, and each package reading the other's.
- The JAX contracts (``tests/test_nlp.py``, ``tests/test_nlp_distributed.py``)
  run on the port: their own assertions, the port's objects in place of
  the JAX ones, on the CPU.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_port  # noqa: F401  (private JAX executable cache)
from _torch_port import cpu_default, run_on_port
from test_nlp import _corpus
from test_nlp_distributed import CORPUS as SPARK_CORPUS

from deeplearning4j_tpu.nlp import learning as jlearning
from deeplearning4j_tpu.nlp import (Glove as JGlove,
                                    ParagraphVectors as JParagraphVectors,
                                    Word2Vec as JWord2Vec)
from deeplearning4j_tpu.nlp import serializer as jserializer
from deeplearning4j_tpu.nlp.distributed import SparkWord2Vec as JSpark
from deeplearning4j_tpu.nlp.iterators import (
    CollectionSentenceIterator as JCollection, LabelledDocument as JDoc,
    SimpleLabelAwareIterator as JLabelAware)
from deeplearning4j_tpu.nlp.vocab import VocabConstructor as JVocabConstructor

from deeplearning4j_tpu_torch.nlp import (Glove, ParagraphVectors, Word2Vec,
                                          learning, lookup, sequencevectors,
                                          serializer)
from deeplearning4j_tpu_torch.nlp.distributed import SparkWord2Vec
from deeplearning4j_tpu_torch.nlp.iterators import (
    CollectionSentenceIterator, LabelledDocument, SimpleLabelAwareIterator)
from deeplearning4j_tpu_torch.nlp.vocab import VocabConstructor

#: one step against JAX's, a table's largest difference over its largest
#: value (float32, the same sums in other orders)
STEP_TOL = 1e-6
#: whole fits against JAX's, ||port - jax|| / ||jax|| of the vectors
FIT_TOL = 1e-4


def _vocab_rows(cache):
    return [(vw.word, vw.count, vw.index, list(vw.code), list(vw.points))
            for vw in cache.vocab_words()]


@pytest.mark.parametrize("min_freq", [1, 2])
def test_vocab_and_huffman_equal_jax(min_freq):
    seqs = [s.split() for s in _corpus(2)] + [["rare"], ["rarer", "rare"]]
    mine = VocabConstructor(min_word_frequency=min_freq).build_joint_vocabulary(
        seqs)
    theirs = JVocabConstructor(
        min_word_frequency=min_freq).build_joint_vocabulary(seqs)
    assert _vocab_rows(mine) == _vocab_rows(theirs)
    assert mine.total_word_count == theirs.total_word_count


@pytest.mark.parametrize("text", ["ascii", "unicode"])
def test_vocab_from_file_equals_jax(tmp_path, text):
    """The host runtime's counter (ASCII) and the Python tokenizer
    (non-ASCII: the counter's None) give JAX's vocab, codes and points."""
    from deeplearning4j_tpu.nlp.tokenization import (
        CommonPreprocessor as JCommon, DefaultTokenizerFactory as JTok)
    from deeplearning4j_tpu_torch.nlp.tokenization import (
        CommonPreprocessor, DefaultTokenizerFactory)
    body = "The cat, sat. (on) the MAT!\nthe dog sat on the rug 42\n" * 7
    if text == "unicode":
        body += "café naïve café\n"
    p = tmp_path / "corpus.txt"
    p.write_text(body, encoding="utf-8")
    tf, jtf = DefaultTokenizerFactory(), JTok()
    tf.set_token_pre_processor(CommonPreprocessor())
    jtf.set_token_pre_processor(JCommon())
    for mine_tf, their_tf in ((None, None), (tf, jtf)):
        mine = VocabConstructor(special=["UNK"]).build_from_file(
            str(p), mine_tf)
        theirs = JVocabConstructor(special=["UNK"]).build_from_file(
            str(p), their_tf)
        assert _vocab_rows(mine) == _vocab_rows(theirs)


# ------------------------------------------------------------- one step
V, D, W, L = 40, 16, 3, 5
STEP_B, STEP_CHUNK = 16, 4
#: mode -> (use_hs, negatives, cbow, rows in the batch, cum_table scale)
STEP_MODES = {"hs": (True, 0, False, STEP_B, 1.0),
              "neg": (False, 5, False, STEP_B, 1.0),
              "hs_neg": (True, 3, False, STEP_B, 1.0),
              "cbow": (True, 2, True, STEP_B, 1.0),
              "clamp_and_drop": (False, 5, True, 11, 0.5)}


def _rows(rng, n, cbow):
    out = []
    for _ in range(n):
        nctx = int(rng.integers(1, W + 1)) if cbow else 1
        npts = int(rng.integers(1, L + 1))
        out.append(([int(x) for x in rng.integers(0, V, nctx)],
                    int(rng.integers(0, V)),
                    [int(x) for x in rng.integers(0, V - 1, npts)],
                    [float(x) for x in rng.integers(0, 2, npts)]))
    return out


def _fill(acc, rows):
    batch = None
    for r in rows:
        batch = acc.add(*r) or batch
    return batch or acc.flush()


@pytest.mark.parametrize("mode", sorted(STEP_MODES))
def test_train_step_matches_jax(mode):
    use_hs, neg, cbow, n_rows, scale = STEP_MODES[mode]
    rng = np.random.default_rng(5)
    rows = _rows(rng, n_rows, cbow)
    width = W if cbow else 1
    jbatch = _fill(jlearning.BatchAccumulator(STEP_B, width, L, V), rows)
    hbatch = _fill(learning.BatchAccumulator(STEP_B, width, L, V), rows)
    for a, b in zip(jbatch, hbatch):
        np.testing.assert_array_equal(np.asarray(a), b)
    tables = [rng.normal(size=s).astype(np.float32) * 0.3
              for s in ((V, D), (V - 1, D), (V, D))]
    counts = rng.integers(1, 50, V).astype(np.float64) ** 0.75
    cum = (np.cumsum(counts / counts.sum()) * scale).astype(np.float32)
    key = jax.random.PRNGKey(11)
    C, S = learning.chunking(STEP_B, STEP_CHUNK)
    u = None
    if neg:
        # the uniforms the JAX step draws: one key a chunk
        u = np.stack([np.asarray(jax.random.uniform(k, (S, neg)))
                      for k in jax.random.split(key, C)])
    jstep = jlearning.make_train_step(use_hs, neg, chunk=STEP_CHUNK,
                                      dense_update=False)
    want = [np.asarray(t) for t in jstep(
        *(jnp.asarray(t) for t in tables), jnp.asarray(cum), jbatch,
        jnp.float32(0.025), key)]
    staged, lr, u_t = learning.stage(hbatch, "cpu", 0.025, u)
    got = [t.clone() for t in map(torch.from_numpy, tables)]
    learning.make_train_step(use_hs, neg, chunk=STEP_CHUNK)(
        *got, torch.from_numpy(cum), staged, lr, u_t)
    for name, g, w, t0 in zip(("syn0", "syn1", "syn1neg"), got, want,
                              tables):
        err = float(np.abs(g.numpy() - w).max())
        assert err <= STEP_TOL * float(np.abs(w).max()), (name, err)
        if (name == "syn1" and not use_hs) or (name == "syn1neg" and not neg):
            np.testing.assert_array_equal(g.numpy(), t0)
    if mode == "clamp_and_drop":
        # the case reaches both: padding rows and negatives past the table
        assert (hbatch.pair_mask == 0).any()
        assert (hbatch.update_dest == V).any()
        assert (u > cum[-1]).any()


def test_dense_update_matches_scatter():
    """The JAX contract ``test_dense_update_path_matches_scatter`` on the
    port: the one-hot-matmul update equals the scatter route, duplicates
    accumulating and out-of-range padding rows dropped."""
    rng = np.random.default_rng(0)
    acc = learning.BatchAccumulator(batch_size=8, window_width=3,
                                    code_length=4, n_words=50)
    batch = None
    for _ in range(8):
        batch = acc.add([int(rng.integers(0, 50)) for _ in range(3)],
                        int(rng.integers(0, 50)),
                        [int(rng.integers(0, 50)) for _ in range(3)],
                        [float(rng.integers(0, 2)) for _ in range(3)]) or batch
    tables = [torch.from_numpy(np.random.default_rng(s).normal(
        size=(50, 16)).astype(np.float32)) for s in (1, 2, 3)]
    cum = torch.cumsum(torch.ones(50) / 50, 0)
    u = torch.rand((2, 4, 3), generator=torch.Generator().manual_seed(7))
    staged, lr, u_t = learning.stage(batch, "cpu", 0.025, u.numpy())
    outs = {}
    for dense in (False, True):
        step = learning.make_train_step(use_hs=True, negative=3, chunk=4,
                                        dense_update=dense)
        outs[dense] = step(*(t.clone() for t in tables), cum, staged, lr, u_t)
    for a, b in zip(outs[False], outs[True]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ whole fits
def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("algo", ["skipgram", "cbow"])
def test_word2vec_hs_fit_matches_jax(algo):
    def build(cls, it, **dev):
        b = (cls.builder().layer_size(24).window_size(4).min_word_frequency(2)
             .learning_rate(0.05).epochs(2).seed(7).batch_size(128)
             .elements_learning_algorithm(algo).iterate(it))
        return (b.device(dev["device"]) if dev else b).build()
    theirs = build(JWord2Vec, JCollection(_corpus(6)))
    theirs.fit()
    mine = build(Word2Vec, CollectionSentenceIterator(_corpus(6)),
                 device="cpu")
    mine.fit()
    assert mine.vocab.words() == theirs.vocab.words()
    assert _rel(mine.lookup.syn0, theirs.lookup.syn0) <= FIT_TOL
    assert _rel(mine.lookup.syn1, theirs.lookup.syn1) <= FIT_TOL


def test_paragraph_vectors_dbow_and_infer_match_jax():
    texts = _corpus(2)[:6] * 3

    def build(cls, doc, it, **kw):
        docs = [doc(s, [f"DOC_{i}"]) for i, s in enumerate(texts)]
        b = (cls.builder().layer_size(16).window_size(3).min_word_frequency(1)
             .learning_rate(0.05).epochs(2).seed(11).iterate(it(docs)))
        return (b.device(kw["device"]) if kw else b).build()
    theirs = build(JParagraphVectors, JDoc, JLabelAware)
    theirs.fit()
    mine = build(ParagraphVectors, LabelledDocument, SimpleLabelAwareIterator,
                 device="cpu")
    mine.fit()
    assert mine.vocab.words() == theirs.vocab.words()
    assert _rel(mine.lookup.syn0, theirs.lookup.syn0) <= FIT_TOL
    text = "the cat sat with the dog"
    assert _rel(mine.infer_vector(text), theirs.infer_vector(text)) <= FIT_TOL


def test_glove_fit_matches_jax():
    seqs = [s.split() for s in _corpus(4)]
    kw = dict(vector_length=12, window=3, min_word_frequency=1,
              learning_rate=0.1, epochs=3, seed=5, batch_size=64)
    theirs = JGlove(**kw)
    theirs.fit(seqs)
    mine = Glove(device="cpu", **kw)
    mine.fit(seqs)
    assert _rel(mine.lookup.syn0, theirs.lookup.syn0) <= FIT_TOL
    assert _rel(mine.bias, theirs.bias) <= FIT_TOL


def test_spark_word2vec_two_workers_match_jax():
    kw = dict(num_workers=2, averaging_rounds=2, vector_length=12, window=2,
              seed=3, min_word_frequency=1, use_hierarchic_softmax=True,
              batch_size=64)
    theirs = JSpark(**kw).fit(SPARK_CORPUS[:16])
    mine = SparkWord2Vec(device="cpu", **kw).fit(SPARK_CORPUS[:16])
    assert mine.master.vocab.words() == theirs.master.vocab.words()
    assert _rel(mine.master.lookup.syn0, theirs.master.lookup.syn0) <= FIT_TOL
    assert _rel(mine.master.lookup.syn1, theirs.master.lookup.syn1) <= FIT_TOL


def test_word_vector_files_equal_jax_bytes(tmp_path):
    """The text and binary files the port writes are the JAX package's
    byte for byte for the same vectors, and each package reads the
    other's."""
    theirs = (JWord2Vec.builder().layer_size(8).min_word_frequency(2)
              .epochs(1).seed(1).iterate(JCollection(_corpus(2))).build())
    theirs.fit()
    mine = Word2Vec(vector_length=8, device="cpu")
    mine.vocab = theirs.vocab
    mine.lookup = lookup.InMemoryLookupTable(theirs.vocab, 8, device="cpu")
    mine.lookup.syn0 = torch.from_numpy(np.array(theirs.lookup.syn0))
    for binary in (False, True):
        a, b = tmp_path / f"jax{binary}", tmp_path / f"port{binary}"
        jserializer.write_word_vectors(theirs, str(a), binary=binary)
        serializer.write_word_vectors(mine, str(b), binary=binary)
        assert a.read_bytes() == b.read_bytes()
        back = serializer.read_word_vectors(str(a), binary=binary,
                                            device="cpu")
        jback = jserializer.read_word_vectors(str(b), binary=binary)
        assert back.vocab.words() == jback.vocab.words()
        np.testing.assert_array_equal(back.lookup.syn0.numpy(),
                                      np.asarray(jback.lookup.syn0))


# ------------------------------------------------------- the JAX contracts
CONTRACTS = [
    ("test_nlp", "test_tokenizer_and_preprocess", {}),
    ("test_nlp", "test_vocab_and_huffman", {}),
    ("test_nlp", "test_word2vec_topic_similarity", {"mode": "hs"}),
    ("test_nlp", "test_word2vec_topic_similarity", {"mode": "neg"}),
    ("test_nlp", "test_word2vec_cbow_trains", {}),
    ("test_nlp", "test_word_vector_serialization_roundtrip", {"tmp": 1}),
    ("test_nlp", "test_paragraph_vectors_dbow_and_infer", {}),
    ("test_nlp", "test_glove_trains_and_embeds", {}),
    ("test_nlp", "test_bow_and_tfidf", {}),
    ("test_nlp", "test_label_aware_iterator_labels", {}),
    ("test_nlp", "test_word2vec_vocab_from_file_trains", {"tmp": 1}),
    ("test_nlp_distributed", "test_text_pipeline_tokenize_and_vocab", {}),
    ("test_nlp_distributed", "test_spark_word2vec_learns_cooccurrence", {}),
    ("test_nlp_distributed", "test_averaging_is_deterministic", {}),
]


@pytest.mark.parametrize(
    "module,name,kw", CONTRACTS,
    ids=[f"{m}::{n}" + (f"[{k['mode']}]" if "mode" in k else "")
         for m, n, k in CONTRACTS])
def test_jax_contract_holds_on_port(module, name, kw, monkeypatch, tmp_path):
    cpu_default(monkeypatch, sequencevectors, lookup)
    kw = dict(kw)
    if kw.pop("tmp", None):
        kw["tmp_path"] = tmp_path
    run_on_port(module, name, monkeypatch, ["deeplearning4j_tpu.nlp"], **kw)


def test_entry_points_raise_without_cuda(monkeypatch):
    """``device=None`` means CUDA: with none, every entry point raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from deeplearning4j_tpu_torch.graph import DeepWalk
    for make in (lambda: Word2Vec(), lambda: ParagraphVectors(),
                 lambda: Glove(), lambda: SparkWord2Vec().fit(["a b"]),
                 lambda: DeepWalk().fit(_two_vertices())):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def _two_vertices():
    from deeplearning4j_tpu_torch.graph import Graph
    g = Graph(2)
    g.add_edge(0, 1)
    return g
