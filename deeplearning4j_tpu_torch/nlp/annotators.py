"""Text annotation pipeline: sentence/token/stem/PoS annotators.

Reference: deeplearning4j-nlp-uima (SURVEY.md §2.5) — UIMA analysis engines
(SentenceAnnotator, TokenizerAnnotator, StemmerAnnotator, PoStagger) composed
into a pipeline over a CAS. Here the CAS is a plain ``Annotation`` document
object and annotators are composable callables — same pipeline shape without
the UIMA framework. The stemmer is a Porter-lite suffix stripper and the PoS
tagger a compact rule/lexicon tagger (the reference reaches comparable
components through bundled UIMA models).

Counterpart of ``deeplearning4j_tpu/nlp/annotators.py``: host code, the same
in the port (the port keeps its own copy; it imports nothing of the JAX
package).
"""
from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Sequence


@dataclasses.dataclass
class Token:
    text: str
    begin: int
    end: int
    stem: Optional[str] = None
    pos: Optional[str] = None


@dataclasses.dataclass
class Sentence:
    text: str
    begin: int
    end: int
    tokens: List[Token] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Annotation:
    """The document being annotated (UIMA CAS equivalent)."""

    text: str
    sentences: List[Sentence] = dataclasses.field(default_factory=list)


class Annotator:
    def process(self, cas: Annotation) -> Annotation:
        raise NotImplementedError


class SentenceAnnotator(Annotator):
    """Sentence segmentation on terminal punctuation (reference
    SentenceAnnotator wrapping the UIMA sentence detector)."""

    _BOUNDARY = re.compile(r"(?<=[.!?])\s+")

    def process(self, cas: Annotation) -> Annotation:
        pos = 0
        for part in self._BOUNDARY.split(cas.text):
            if part.strip():
                begin = cas.text.index(part, pos)
                cas.sentences.append(
                    Sentence(part, begin, begin + len(part)))
                pos = begin + len(part)
        return cas


class TokenizerAnnotator(Annotator):
    """Word tokenization inside each sentence (reference TokenizerAnnotator)."""

    _TOKEN = re.compile(r"\w+(?:'\w+)?|[^\w\s]")

    def process(self, cas: Annotation) -> Annotation:
        for s in cas.sentences:
            for m in self._TOKEN.finditer(s.text):
                s.tokens.append(Token(m.group(), s.begin + m.start(),
                                      s.begin + m.end()))
        return cas


class StemmerAnnotator(Annotator):
    """Porter-lite suffix stripping (reference StemmerAnnotator / snowball)."""

    _RULES = [("sses", "ss"), ("ies", "i"), ("ation", "ate"), ("tional", "tion"),
              ("ness", ""), ("ment", ""), ("ing", ""), ("edly", ""),
              ("ed", ""), ("ly", ""), ("s", "")]

    @classmethod
    def stem(cls, w: str) -> str:
        lw = w.lower()
        for suf, rep in cls._RULES:
            if lw.endswith(suf) and len(lw) - len(suf) >= 2:
                return lw[: len(lw) - len(suf)] + rep
        return lw

    def process(self, cas: Annotation) -> Annotation:
        for s in cas.sentences:
            for t in s.tokens:
                t.stem = self.stem(t.text)
        return cas


class PoSTaggerAnnotator(Annotator):
    """Compact rule/lexicon part-of-speech tagger (reference PoStagger)."""

    _DET = {"the", "a", "an", "this", "that", "these", "those"}
    _PRON = {"i", "you", "he", "she", "it", "we", "they", "me", "him", "her",
             "us", "them"}
    _PREP = {"in", "on", "at", "by", "for", "with", "from", "to", "of",
             "over", "under"}
    _CONJ = {"and", "or", "but", "nor", "so", "yet"}
    _AUX = {"is", "are", "was", "were", "be", "been", "am", "has", "have",
            "had", "do", "does", "did", "will", "would", "can", "could"}

    def _tag(self, w: str, prev_tag: Optional[str]) -> str:
        lw = w.lower()
        if not re.match(r"\w", w):
            return "PUNCT"
        if re.fullmatch(r"[\d.,]+", w):
            return "NUM"
        if lw in self._DET:
            return "DET"
        if lw in self._PRON:
            return "PRON"
        if lw in self._PREP:
            return "ADP"
        if lw in self._CONJ:
            return "CCONJ"
        if lw in self._AUX:
            return "AUX"
        if lw.endswith("ly"):
            return "ADV"
        if lw.endswith(("ing", "ed")) and prev_tag in ("AUX", "PRON"):
            return "VERB"
        if lw.endswith(("ous", "ful", "ive", "able", "al", "ic")):
            return "ADJ"
        if prev_tag in ("DET", "ADJ"):
            return "NOUN"
        if prev_tag in ("PRON",):
            return "VERB"
        if w[0].isupper():
            return "PROPN"
        return "NOUN"

    def process(self, cas: Annotation) -> Annotation:
        for s in cas.sentences:
            prev = None
            for t in s.tokens:
                t.pos = self._tag(t.text, prev)
                prev = t.pos
        return cas


class AnnotatorPipeline:
    """Composed analysis engine (reference UIMA AnalysisEngine aggregation)."""

    def __init__(self, annotators: Optional[Sequence[Annotator]] = None):
        self.annotators = list(annotators) if annotators else [
            SentenceAnnotator(), TokenizerAnnotator(), StemmerAnnotator(),
            PoSTaggerAnnotator()]

    def annotate(self, text: str) -> Annotation:
        cas = Annotation(text)
        for a in self.annotators:
            cas = a.process(cas)
        return cas
