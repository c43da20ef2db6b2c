"""Tokenizer SPIs (reference deeplearning4j-nlp text/tokenization/**:
TokenizerFactory, Tokenizer, TokenPreProcess impls, DefaultTokenizer,
NGramTokenizerFactory, stopwords).

Counterpart of ``deeplearning4j_tpu/nlp/tokenization.py``: host code, the
same in the port (the port keeps its own copy; it imports nothing of the JAX
package).
"""
from __future__ import annotations

import re
from typing import List, Optional

# reference resource stopwords (text/stopwords) — the standard English list
DEFAULT_STOP_WORDS = frozenset("""a an and are as at be but by for if in into is it
no not of on or such that the their then there these they this to was will with
""".split())


class TokenPreProcess:
    def pre_process(self, token: str) -> str:
        raise NotImplementedError


class CommonPreprocessor(TokenPreProcess):
    """Lowercase + strip punctuation/digits (reference CommonPreprocessor.java)."""

    _PUNCT = re.compile(r"[\d\.:,\"'\(\)\[\]|/?!;]+")

    def pre_process(self, token: str) -> str:
        return self._PUNCT.sub("", token).lower()


class LowCasePreProcessor(TokenPreProcess):
    def pre_process(self, token: str) -> str:
        return token.lower()


class EndingPreProcessor(TokenPreProcess):
    """Crude stemmer for common English endings (reference EndingPreProcessor.java)."""

    def pre_process(self, token: str) -> str:
        if token.endswith("s") and not token.endswith("ss"):
            token = token[:-1]
        if token.endswith("."):
            token = token[:-1]
        if token.endswith("ly"):
            token = token[:-2]
        if token.endswith("ing"):
            token = token[:-3]
        return token


class Tokenizer:
    def __init__(self, tokens: List[str]):
        self._tokens = tokens
        self._pos = 0

    def has_more_tokens(self) -> bool:
        return self._pos < len(self._tokens)

    def next_token(self) -> str:
        t = self._tokens[self._pos]
        self._pos += 1
        return t

    def count_tokens(self) -> int:
        return len(self._tokens)

    def get_tokens(self) -> List[str]:
        return list(self._tokens)


class TokenizerFactory:
    def __init__(self):
        self._pre: Optional[TokenPreProcess] = None

    def set_token_pre_processor(self, pre: TokenPreProcess) -> None:
        self._pre = pre

    def _apply_pre(self, tokens: List[str]) -> List[str]:
        if self._pre is None:
            return tokens
        out = [self._pre.pre_process(t) for t in tokens]
        return [t for t in out if t]

    def create(self, text: str) -> Tokenizer:
        raise NotImplementedError


class DefaultTokenizerFactory(TokenizerFactory):
    """Whitespace/word-char tokenization (reference DefaultTokenizerFactory —
    java.util.StringTokenizer semantics)."""

    def create(self, text: str) -> Tokenizer:
        return Tokenizer(self._apply_pre(text.split()))


class NGramTokenizerFactory(TokenizerFactory):
    """Emits n-grams joined by spaces (reference NGramTokenizerFactory.java)."""

    def __init__(self, base: TokenizerFactory, min_n: int, max_n: int):
        super().__init__()
        self.base = base
        self.min_n = min_n
        self.max_n = max_n

    def create(self, text: str) -> Tokenizer:
        words = self.base.create(text).get_tokens()
        out: List[str] = []
        for n in range(self.min_n, self.max_n + 1):
            for i in range(0, len(words) - n + 1):
                out.append(" ".join(words[i:i + n]))
        return Tokenizer(self._apply_pre(out))
