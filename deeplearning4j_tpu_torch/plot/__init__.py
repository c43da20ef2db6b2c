"""t-SNE embeddings: exact on the device, Barnes-Hut on the host.

Counterpart of ``deeplearning4j_tpu/plot``."""
from .tsne import BarnesHutTsne, Tsne

__all__ = ["Tsne", "BarnesHutTsne"]
