"""Shared pieces of the PyTorch port's tests (``tests/test_torch_*.py``).

Importing this module gives the test process a private default for the JAX
package's executable cache: a temporary directory, removed at exit, unless
``DL4J_COMPILE_CACHE_DIR`` is already set. ``tests/conftest.py`` points the
cache at a per-test directory, but module- and session-scoped fixtures run
outside that and would otherwise write to ``~/.cache/deeplearning4j_tpu``,
where a later run in the same home warm-loads the entry (on the 8-device
CPU mesh that load fails with "Expected args to
execute_sharded_on_local_devices to have 8 shards").
"""
import atexit
import contextlib
import json
import os
import shutil
import tempfile

import numpy as np


def _private_compile_cache() -> None:
    if os.environ.get("DL4J_COMPILE_CACHE_DIR"):
        return
    path = tempfile.mkdtemp(prefix="dl4j-xcache-")
    os.environ["DL4J_COMPILE_CACHE_DIR"] = path
    atexit.register(shutil.rmtree, path, True)


_private_compile_cache()


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


def lm_conf_json(vocab=16, width=16, n_layers=1, n_heads=2, max_len=8,
                 seed=3, learning_rate=3e-4, global_fields=None,
                 layer_fields=None, top_fields=None):
    """The JSON of a small JAX ``transformer_lm`` config, with fields of the
    global conf, of every layer and of the top level replaced."""
    from deeplearning4j_tpu.models.transformer import transformer_lm
    d = json.loads(transformer_lm(vocab, width=width, n_layers=n_layers,
                                  n_heads=n_heads, max_len=max_len, seed=seed,
                                  learning_rate=learning_rate).to_json())
    d["global_conf"].update(global_fields or {})
    for layer in d["layers"]:
        layer.update(layer_fields or {})
    d.update(top_fields or {})
    return json.dumps(d)


@contextlib.contextmanager
def compile_cache_at(path):
    """Point the JAX package's executable cache at ``path`` for the block,
    so a fixture wider than one test writes nothing under the user's
    ``~/.cache`` (conftest isolates only test-scoped work)."""
    old = os.environ.get("DL4J_COMPILE_CACHE_DIR")
    os.environ["DL4J_COMPILE_CACHE_DIR"] = str(path)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("DL4J_COMPILE_CACHE_DIR", None)
        else:
            os.environ["DL4J_COMPILE_CACHE_DIR"] = old


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return np.array(tree)


class LossRecorder:
    """A listener (for either package) that appends each update's loss."""

    def __init__(self, losses):
        self.losses = losses

    def iteration_done(self, model, iteration):
        self.losses.append(float(model.score_value))


def jax_train(conf_json, batches, cache_dir):
    """Train a JAX ``MultiLayerNetwork`` built from ``conf_json`` (initialized
    from its seed) with one ``fit`` call per ``(x, y, fmask, lmask)`` batch,
    the executable cache at ``cache_dir``. Returns a dict of numpy trees: the
    initial ``params0``, the ``losses`` per fit call, ``params1`` after the
    first call, and the final ``params``, ``updater_state`` and
    ``iteration``."""
    from deeplearning4j_tpu.nn.conf.multilayer import MultiLayerConfiguration
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork
    with compile_cache_at(cache_dir):
        net = MultiLayerNetwork(
            MultiLayerConfiguration.from_json(conf_json)).init()
        out = {"params0": _np_tree(net.params_list), "losses": [],
               "iter_losses": []}
        net.set_listeners(LossRecorder(out["iter_losses"]))
        for n, (x, y, fmask, lmask) in enumerate(batches):
            net.fit(x, y, fmask=fmask, lmask=lmask)
            out["losses"].append(float(net.score_value))
            if n == 0:
                out["params1"] = _np_tree(net.params_list)
        out["params"] = _np_tree(net.params_list)
        out["updater_state"] = _np_tree(net.updater_state)
        out["iteration"] = net.iteration
    return out
