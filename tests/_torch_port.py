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


@contextlib.contextmanager
def no_executable_cache():
    """The JAX references compile without the JAX package's executable
    cache: on this kind of host its in-process reload of a program the
    module compiled before fails ("Expected args to
    execute_sharded_on_local_devices to have 8 shards", ROADMAP.md §C).
    The cache is not what the port's tests compare."""
    old = os.environ.get("DL4J_COMPILE_CACHE")
    os.environ["DL4J_COMPILE_CACHE"] = "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("DL4J_COMPILE_CACHE", None)
        else:
            os.environ["DL4J_COMPILE_CACHE"] = old


def port_module_name(name: str) -> str:
    """The port's module at a JAX module's path."""
    return name.replace("deeplearning4j_tpu", "deeplearning4j_tpu_torch", 1)


def run_on_port(test_module: str, test_name: str, monkeypatch, jax_prefixes,
                /, **kwargs):
    """Run the JAX contract test ``test_module.test_name`` on the port: the
    test's own assertions, with every name the test module takes from the
    modules under ``jax_prefixes`` (e.g. ``deeplearning4j_tpu.nlp``) bound
    to the port's same-named object, its helper functions rebound alike,
    and those JAX modules answered by the port's for an import inside the
    test body. The port's entry points default to CUDA; the caller points
    them at the CPU (``monkeypatch``). The four arguments are positional,
    so ``kwargs`` may hold the test's own ``monkeypatch``."""
    import importlib
    import sys
    import types

    mod = importlib.import_module(test_module)

    def ported(obj):
        home = getattr(obj, "__module__", None) or ""
        if not any(home == p or home.startswith(p + ".")
                   for p in jax_prefixes):
            return obj
        return getattr(importlib.import_module(port_module_name(home)),
                       obj.__name__)

    for name in list(sys.modules):
        if any(name == p or name.startswith(p + ".") for p in jax_prefixes):
            monkeypatch.setitem(sys.modules, name, importlib.import_module(
                port_module_name(name)))
    env = {}
    for k, v in vars(mod).items():
        if isinstance(v, (type, types.FunctionType)):
            env[k] = ported(v)
        elif k in ("EXCEPTION_ON_DISCONNECTED", "SELF_LOOP_ON_DISCONNECTED"):
            env[k] = v
    env = {**vars(mod), **env}
    for k, v in list(env.items()):
        if isinstance(v, types.FunctionType) and v.__module__ == mod.__name__:
            env[k] = types.FunctionType(v.__code__, env, v.__name__,
                                        v.__defaults__, v.__closure__)
    fn = env[test_name]
    return fn(**kwargs)


def cpu_default(monkeypatch, *modules):
    """Make ``device=None`` mean the CPU in the port's ``modules`` (their
    ``resolve_device``), for contract tests written without a device."""
    import torch
    from deeplearning4j_tpu_torch.common import resolve_device

    def on_cpu(device=None):
        return resolve_device("cpu" if device is None else device)
    for m in modules:
        monkeypatch.setattr(m, "resolve_device", on_cpu)
    return torch.device("cpu")
