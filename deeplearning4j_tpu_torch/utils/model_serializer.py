"""Model files: one zip with the config, the params, the layer state and the
updater state, so training resumes where it stopped.

Counterpart of ``deeplearning4j_tpu/utils/model_serializer.py``, in the same
container: the entries ``configuration.json`` (the config's JSON),
``coefficients.npz``, ``modelState.npz`` (batch norm's running statistics),
``updaterState.npz``, ``normalizer.npz`` (optional) and ``meta.json``
(``iteration``, ``epoch``, ``model_type``, ``framework``,
``format_version``). Each npz keys a leaf by its path in the tree, each
dict key or list index joined with ``/`` (``0/W``, ``0/W/m``,
``da/W/g2``), as the JAX package keys its pytree paths, so a zip written by
either package restores in the other.

numpy has no bfloat16: a bf16 leaf is written as its 16-bit patterns
(``'V2'``, as ``np.savez`` stores the JAX package's ``ml_dtypes`` bf16
arrays), and read back as bf16 only where the template leaf is bf16; any
other template raises. Restoring builds a new network on the requested
device (``None`` means CUDA) and copies every leaf in through its
``load_params``, ``load_state`` and ``load_updater_state``.
"""
from __future__ import annotations

import io
import json
import zipfile

import numpy as np
import torch

from .pytree import leaves_with_paths, tree_map_with_path

CONFIG_ENTRY = "configuration.json"
PARAMS_ENTRY = "coefficients.npz"
UPDATER_ENTRY = "updaterState.npz"
MODEL_STATE_ENTRY = "modelState.npz"
NORMALIZER_ENTRY = "normalizer.npz"
META_ENTRY = "meta.json"

#: numpy's dtype for the bit patterns of a bf16 leaf
_BF16_BITS = np.dtype("V2")


def _key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _leaf_to_numpy(leaf) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    leaf = leaf.detach().cpu()
    if leaf.dtype == torch.bfloat16:
        return leaf.view(torch.int16).numpy().view(_BF16_BITS)
    return leaf.numpy()


def _tree_to_npz_bytes(tree) -> bytes:
    """A tree of tensors (or arrays) as npz bytes under path keys."""
    arrays = {_key(path): _leaf_to_numpy(leaf)
              for path, leaf in leaves_with_paths(tree)}
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _leaf_from_npz(arr: np.ndarray, like: torch.Tensor, key: str):
    """``arr`` in the dtype of the template tensor ``like``: a numpy array,
    or a bf16 tensor for a bf16 template."""
    like_dtype = like.dtype
    if arr.dtype.kind == "V":
        if arr.dtype.itemsize != 2 or like_dtype != torch.bfloat16:
            raise ValueError(
                f"leaf {key!r} is stored as raw {arr.dtype.itemsize}-byte "
                f"values (bfloat16 bits), but the model's leaf is "
                f"{like_dtype}; refusing to reinterpret it")
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                ).view(torch.bfloat16)
    if like_dtype == torch.bfloat16:
        return torch.from_numpy(np.asarray(arr)).to(torch.bfloat16)
    return np.asarray(arr, torch.empty(0, dtype=like_dtype).numpy().dtype)


def _npz_bytes_to_tree(template, data: bytes, entry: str):
    """The tree of ``template``'s structure read from npz bytes; every
    template leaf must have its key."""
    npz = np.load(io.BytesIO(data))

    def read(path, leaf):
        key = _key(path)
        if key not in npz.files:
            raise ValueError(f"{entry} has no leaf {key!r} (it holds "
                             f"{sorted(npz.files)[:8]}...)")
        return _leaf_from_npz(npz[key], leaf, key)

    return tree_map_with_path(read, template)


def write_model(net, path: str, save_updater: bool = True,
                normalizer=None) -> None:
    """Write ``net`` (either network type) to a model zip; with
    ``save_updater`` its updater state too, with ``normalizer`` that
    normalizer's arrays."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(CONFIG_ENTRY, net.conf.to_json())
        zf.writestr(PARAMS_ENTRY, _tree_to_npz_bytes(net.params_list))
        zf.writestr(MODEL_STATE_ENTRY, _tree_to_npz_bytes(net.state_list))
        if save_updater and net.updater_state is not None:
            zf.writestr(UPDATER_ENTRY, _tree_to_npz_bytes(net.updater_state))
        if normalizer is not None:
            zf.writestr(NORMALIZER_ENTRY,
                        _tree_to_npz_bytes(normalizer.to_arrays()))
        meta = {"iteration": net.iteration, "epoch": getattr(net, "epoch", 0),
                "model_type": type(net).__name__,
                "framework": "deeplearning4j_tpu_torch", "format_version": 1}
        zf.writestr(META_ENTRY, json.dumps(meta))


def _restore(net, zf: zipfile.ZipFile, load_updater: bool):
    """Copy the zip's leaves into ``net`` (initialized from its seed) and
    set its counters from ``meta.json``."""
    net.init()
    names = zf.namelist()
    params = _npz_bytes_to_tree(net.params_list, zf.read(PARAMS_ENTRY),
                                PARAMS_ENTRY)
    states = None
    if MODEL_STATE_ENTRY in names:
        states = _npz_bytes_to_tree(net.state_list,
                                    zf.read(MODEL_STATE_ENTRY),
                                    MODEL_STATE_ENTRY)
    net.load_params(params, states)
    meta = (json.loads(zf.read(META_ENTRY).decode())
            if META_ENTRY in names else {})
    iteration = int(meta.get("iteration", 0))
    if load_updater and UPDATER_ENTRY in names:
        net.load_updater_state(
            _npz_bytes_to_tree(net.updater_state, zf.read(UPDATER_ENTRY),
                               UPDATER_ENTRY), iteration=iteration)
    net.iteration = iteration
    net.epoch = int(meta.get("epoch", 0))
    return net


def restore_multi_layer_network(path: str, load_updater: bool = True,
                                device=None):
    """A ``MultiLayerNetwork`` on ``device`` from a model zip."""
    from ..nn.conf.multilayer import MultiLayerConfiguration
    from ..nn.multilayer import MultiLayerNetwork

    with zipfile.ZipFile(path) as zf:
        conf = MultiLayerConfiguration.from_json(zf.read(CONFIG_ENTRY).decode())
        return _restore(MultiLayerNetwork(conf, device=device), zf,
                        load_updater)


def restore_computation_graph(path: str, load_updater: bool = True,
                              device=None):
    """A ``ComputationGraph`` on ``device`` from a model zip."""
    from ..nn.conf.graphconf import ComputationGraphConfiguration
    from ..nn.graph_network import ComputationGraph

    with zipfile.ZipFile(path) as zf:
        conf = ComputationGraphConfiguration.from_json(
            zf.read(CONFIG_ENTRY).decode())
        return _restore(ComputationGraph(conf, device=device), zf,
                        load_updater)


def restore_normalizer(path: str):
    """The zip's ``NormalizerStandardize``, or None when it has none."""
    from ..datasets.dataset import NormalizerStandardize

    with zipfile.ZipFile(path) as zf:
        if NORMALIZER_ENTRY not in zf.namelist():
            return None
        npz = np.load(io.BytesIO(zf.read(NORMALIZER_ENTRY)))
        return NormalizerStandardize.from_arrays({k: npz[k] for k in npz.files})


def guess_model(path: str, device=None):
    """The network a model zip holds, of the type its ``meta.json`` (or,
    without one, its config's ``"@type"``) names."""
    with zipfile.ZipFile(path) as zf:
        if META_ENTRY in zf.namelist():
            meta = json.loads(zf.read(META_ENTRY).decode())
            graph = meta.get("model_type") == "ComputationGraph"
        else:
            config = json.loads(zf.read(CONFIG_ENTRY).decode())
            graph = config.get("@type") == "ComputationGraphConfiguration"
    if graph:
        return restore_computation_graph(path, device=device)
    return restore_multi_layer_network(path, device=device)
