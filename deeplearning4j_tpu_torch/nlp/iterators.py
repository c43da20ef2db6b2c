"""Sentence/document iterator SPIs (reference text/sentenceiterator/**,
text/documentiterator/**: SentenceIterator, LabelAwareIterator,
LabelsSource, LabelledDocument).

Counterpart of ``deeplearning4j_tpu/nlp/iterators.py``: host code, the same
in the port (the port keeps its own copy; it imports nothing of the JAX
package).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Iterator, List, Optional


class SentenceIterator:
    def __iter__(self) -> Iterator[str]:
        raise NotImplementedError

    def reset(self) -> None:
        pass


class CollectionSentenceIterator(SentenceIterator):
    """Iterates an in-memory collection (reference CollectionSentenceIterator.java)."""

    def __init__(self, sentences: Iterable[str]):
        self.sentences = list(sentences)

    def __iter__(self) -> Iterator[str]:
        return iter(self.sentences)


class BasicLineIterator(SentenceIterator):
    """One sentence per line from a file (reference BasicLineIterator.java)."""

    def __init__(self, path: str):
        self.path = path

    def __iter__(self) -> Iterator[str]:
        with open(self.path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    yield line


class FileSentenceIterator(SentenceIterator):
    """All lines of all files under a directory (reference FileSentenceIterator.java)."""

    def __init__(self, directory: str):
        self.directory = directory

    def __iter__(self) -> Iterator[str]:
        for root, _, files in os.walk(self.directory):
            for fn in sorted(files):
                with open(os.path.join(root, fn), "r", encoding="utf-8",
                          errors="replace") as f:
                    for line in f:
                        line = line.strip()
                        if line:
                            yield line


@dataclasses.dataclass
class LabelledDocument:
    """reference documentiterator/LabelledDocument.java"""

    content: str
    labels: List[str]


class LabelsSource:
    """Generated or user-supplied document labels (reference LabelsSource.java)."""

    def __init__(self, template: str = "DOC_", labels: Optional[List[str]] = None):
        self.template = template
        self._labels = list(labels) if labels else []
        self._counter = 0

    def next_label(self) -> str:
        label = f"{self.template}{self._counter}"
        self._counter += 1
        self._labels.append(label)
        return label

    def get_labels(self) -> List[str]:
        return list(self._labels)


class LabelAwareIterator:
    def __iter__(self) -> Iterator[LabelledDocument]:
        raise NotImplementedError

    def reset(self) -> None:
        pass


class SimpleLabelAwareIterator(LabelAwareIterator):
    """Wraps (text, labels) pairs (reference SimpleLabelAwareIterator.java)."""

    def __init__(self, documents: Iterable[LabelledDocument]):
        self.documents = list(documents)

    def __iter__(self) -> Iterator[LabelledDocument]:
        return iter(self.documents)


class LabelAwareListSentenceIterator(LabelAwareIterator):
    """Sentences + auto-generated labels (reference sentenceiterator
    labelaware variants)."""

    def __init__(self, sentences: Iterable[str], labels_source: Optional[LabelsSource] = None):
        self.labels_source = labels_source or LabelsSource()
        self.documents = [LabelledDocument(s, [self.labels_source.next_label()])
                          for s in sentences]

    def __iter__(self) -> Iterator[LabelledDocument]:
        return iter(self.documents)
