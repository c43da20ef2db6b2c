"""The port's text pipeline held against the JAX package's on the CPU, all
exactly equal: tokenizers and preprocessors, the Japanese lattice
segmenter and its POS tags, the Korean tokenizer, stopwords and windows,
the annotator pipeline (sentences, offsets, stems, POS tags), and
bag-of-words / TF-IDF rows. Then the JAX contract
``tests/test_nlp_extras.py`` runs on the port: its own assertions, the
port's objects in place of the JAX ones."""
import random

import numpy as np
import pytest

import _torch_port  # noqa: F401  (private JAX executable cache)
from _torch_port import run_on_port

from deeplearning4j_tpu.nlp import annotators as jann
from deeplearning4j_tpu.nlp import bagofwords as jbow
from deeplearning4j_tpu.nlp import languages as jlang
from deeplearning4j_tpu.nlp import tokenization as jtok
from deeplearning4j_tpu_torch.nlp import annotators as ann
from deeplearning4j_tpu_torch.nlp import bagofwords as bow
from deeplearning4j_tpu_torch.nlp import languages as lang
from deeplearning4j_tpu_torch.nlp import tokenization as tok

TEXTS = ["The CAT, sat. (on) a MAT!? 42 times",
         "Running quickly; the dogs' owners were chasing cats/mice.",
         "a b c d e", "", "   spaced\tout\nlines  "]
JA_TEXTS = ["私はTPUで学習する", "私は東京へ行きます", "機械学習について学ぶことがたのしい",
            "日本語が分かりません", "国際関係学部学生", "新幹線で大阪へ帰りました",
            "ブロックチェーン、テスト…𝕏"]
KO_TEXTS = ["나는 학교에 간다", "서울은 크다 GPU 2024년"]


def _factories(mod):
    out = []
    for pre in (None, mod.CommonPreprocessor(), mod.LowCasePreProcessor(),
                mod.EndingPreProcessor()):
        f = mod.DefaultTokenizerFactory()
        if pre is not None:
            f.set_token_pre_processor(pre)
        out.append(f)
    out.append(mod.NGramTokenizerFactory(mod.DefaultTokenizerFactory(), 1, 3))
    return out


def test_tokenizers_equal_jax():
    for mine, theirs in zip(_factories(tok), _factories(jtok)):
        for text in TEXTS:
            assert mine.create(text).get_tokens() == \
                theirs.create(text).get_tokens()
    assert tok.DEFAULT_STOP_WORDS == jtok.DEFAULT_STOP_WORDS


def test_languages_equal_jax():
    ja, jja = lang.JapaneseTokenizerFactory(), jlang.JapaneseTokenizerFactory()
    for text in JA_TEXTS:
        assert ja.create(text).get_tokens() == jja.create(text).get_tokens()
        assert lang.ja_tokenize_with_pos(text) == \
            jlang.ja_tokenize_with_pos(text)
    rng = random.Random(3)
    pool = "".join(chr(c) for c in range(0x3041, 0x30FB)) + "漢字学習東京"
    for _ in range(40):
        chunk = "".join(rng.choice(pool) for _ in range(rng.randint(1, 30)))
        assert lang._ja_viterbi(chunk) == jlang._ja_viterbi(chunk)
    ko, jko = lang.KoreanTokenizerFactory(), jlang.KoreanTokenizerFactory()
    for text in KO_TEXTS:
        assert ko.create(text).get_tokens() == jko.create(text).get_tokens()
    assert lang.StopWords.get_stop_words() == jlang.StopWords.get_stop_words()
    words = ["a", "b", "c", "d"]
    assert list(lang.Windows.windows(words, window_size=3)) == \
        list(jlang.Windows.windows(words, window_size=3))
    from deeplearning4j_tpu.nlp.ja_lexicon import OPEN_CLASS as J_OPEN
    from deeplearning4j_tpu_torch.nlp.ja_lexicon import OPEN_CLASS
    assert OPEN_CLASS == J_OPEN


def _flat(cas):
    return [(s.text, s.begin, s.end,
             [(t.text, t.begin, t.end, t.stem, t.pos) for t in s.tokens])
            for s in cas.sentences]


def test_annotators_equal_jax():
    text = ("The quick dog runs. She quickly chased the playful cats! "
            "They were running 3.5 miles, happily. Nations' sizes vary?")
    assert _flat(ann.AnnotatorPipeline().annotate(text)) == \
        _flat(jann.AnnotatorPipeline().annotate(text))


@pytest.mark.parametrize("kind", ["BagOfWordsVectorizer", "TfidfVectorizer"])
def test_bow_and_tfidf_equal_jax(kind):
    docs = ["the cat sat on the mat", "the dog sat", "numbers one two three",
            "the the cat"]
    mine = getattr(bow, kind)(stop_words=["on"]).fit(docs)
    theirs = getattr(jbow, kind)(stop_words=["on"]).fit(docs)
    assert mine.vocab.words() == theirs.vocab.words()
    np.testing.assert_array_equal(mine.fit_transform(docs),
                                  theirs.fit_transform(docs))
    for d in ("the cat and the dog", "unknown words only"):
        np.testing.assert_array_equal(mine.transform(d), theirs.transform(d))


EXTRAS = ["test_annotator_pipeline_sentences_tokens_pos", "test_stemmer",
          "test_japanese_tokenizer_script_runs",
          "test_korean_tokenizer_particle_stripping",
          "test_stopwords_and_windows", "test_japanese_lattice_splits_particles",
          "test_japanese_conjugation_paradigm_fixtures",
          "test_japanese_open_class_dictionary_segmentation",
          "test_japanese_pos_emission", "test_japanese_segmentation_is_lossless"]


@pytest.mark.parametrize("name", EXTRAS)
def test_jax_contract_holds_on_port(name, monkeypatch):
    run_on_port("test_nlp_extras", name, monkeypatch,
                ["deeplearning4j_tpu.nlp"])
