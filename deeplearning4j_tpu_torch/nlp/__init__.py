"""The embedding engine: vocab, the skip-gram/CBOW step, SequenceVectors,
Word2Vec, ParagraphVectors, GloVe, the distributed Word2Vec, tokenizers,
languages and annotators (counterpart of ``deeplearning4j_tpu/nlp``)."""
from .glove import Glove
from .paragraph_vectors import ParagraphVectors
from .sequencevectors import SequenceVectors
from .word2vec import Word2Vec

__all__ = ["Word2Vec", "ParagraphVectors", "Glove", "SequenceVectors"]
