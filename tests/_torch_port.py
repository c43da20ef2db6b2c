"""Shared pieces of the PyTorch port's tests (``tests/test_torch_*.py``)."""
import numpy as np


def jax_lm(vocab=128, width=128, n_layers=2, n_heads=2, max_len=64, seed=3):
    """A small JAX ``transformer_lm`` network (128-aligned by default, so the
    JAX int8 Pallas kernel engages in interpret mode) and its params as
    numpy arrays, for ``convert.from_jax``."""
    from deeplearning4j_tpu.models.transformer import transformer_lm
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork
    net = MultiLayerNetwork(transformer_lm(
        vocab, width=width, n_layers=n_layers, n_heads=n_heads,
        max_len=max_len, seed=seed)).init()
    params = [{k: np.asarray(v) for k, v in p.items()} for p in net.params_list]
    return net, params
