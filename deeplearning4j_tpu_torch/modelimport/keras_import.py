"""Keras 1.x model import: an HDF5 archive -> a port network and its weights.

Counterpart of ``deeplearning4j_tpu/modelimport/keras_import.py`` (the
reference's ``KerasModelImport.java``): the same layer set (Input,
Activation, Dropout, Dense, TimeDistributedDense, LSTM, Convolution2D,
MaxPooling2D, AveragePooling2D, Flatten, Reshape, RepeatVector, Merge,
BatchNormalization, Embedding), the same configuration the JAX importer
builds, and the same weight layouts: TH-ordered convolution kernels
``(nb_filter, stack, rows, cols)`` are transposed to HWIO, LSTM gate
arrays are matched by their ``weight_names`` suffix and fused into
``W``/``RW``/``b`` in the order (input, forget, cell, output), and batch
norm's running mean and variance become the layer's state. Imported
networks take NHWC inputs, as in the JAX package. The archive is read by
the port's own ``hdf5.H5File``; networks are built on ``device`` (``None``
means CUDA).

Keras 1's default LSTM ``inner_activation`` is ``hard_sigmoid``: such a
layer runs the plain cell in both packages, and only ``sigmoid`` gates
reach the LSTM kernels (``ops/lstm.py`` ``is_standard_cell``).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np
import torch

from ..nn.conf.builders import NeuralNetConfiguration
from ..nn.conf.inputs import InputType
from ..nn.conf.layers import (
    LSTM, ActivationLayer, BatchNormalization, ConvolutionLayer, DenseLayer,
    DropoutLayer, EmbeddingLayer, OutputLayer, RnnOutputLayer,
    SubsamplingLayer)
from ..nn.conf.vertices import ElementWiseVertex, MergeVertex
from .hdf5 import H5File

_ACTIVATIONS = {
    "linear": "identity", "hard_sigmoid": "hardsigmoid",
    "softmax": "softmax", "relu": "relu", "tanh": "tanh",
    "sigmoid": "sigmoid", "softplus": "softplus", "softsign": "softsign",
    "elu": "elu", "selu": "selu",
}

_LOSSES = {
    "categorical_crossentropy": "mcxent",
    "sparse_categorical_crossentropy": "mcxent",
    "binary_crossentropy": "xent",
    "mean_squared_error": "mse", "mse": "mse",
    "mean_absolute_error": "mae", "mae": "mae",
    "mean_absolute_percentage_error": "mape",
    "mean_squared_logarithmic_error": "msle",
    "hinge": "hinge", "squared_hinge": "squaredhinge",
    "kullback_leibler_divergence": "kld",
    "poisson": "poisson",
}

_SUPPORTED = {
    "InputLayer", "Activation", "Dropout", "Dense", "TimeDistributedDense",
    "LSTM", "Convolution2D", "MaxPooling2D", "AveragePooling2D", "Flatten",
    "Reshape", "RepeatVector", "Merge", "BatchNormalization", "Embedding",
}


class InvalidKerasConfigurationException(ValueError):
    """The reference's ``InvalidKerasConfigurationException``."""


def _act(name: Optional[str]) -> str:
    if not name:
        return "identity"
    return _ACTIVATIONS.get(name, name)


def _input_type_from_shape(shape: List[Optional[int]],
                           dim_ordering: str) -> InputType:
    """``batch_input_shape`` (leading None stripped) -> ``InputType``."""
    dims = [int(d) for d in shape if d is not None]
    if len(dims) == 3:
        if dim_ordering == "th":
            c, h, w = dims
        else:
            h, w, c = dims
        return InputType.convolutional(h, w, c)
    if len(dims) == 2:
        return InputType.recurrent(dims[1], dims[0])
    if len(dims) == 1:
        return InputType.feed_forward(dims[0])
    raise InvalidKerasConfigurationException(
        f"unsupported input shape {shape}")


def _keras_layers(model_config: dict) -> List[dict]:
    cfg = model_config["config"]
    return cfg if isinstance(cfg, list) else cfg["layers"]


class _SequentialParse:
    def __init__(self):
        self.layers: List = []
        #: Keras layer name -> our layer index (weight-bearing layers)
        self.index_of: Dict[str, int] = {}
        self.input_type: Optional[InputType] = None
        self.class_of: Dict[str, str] = {}


def _parse_sequential(model_config: dict,
                      loss: Optional[str]) -> _SequentialParse:
    out = _SequentialParse()
    klayers = _keras_layers(model_config)
    for pos, kl in enumerate(klayers):
        cls = kl["class_name"]
        cfg = kl.get("config", {})
        name = cfg.get("name", f"layer_{pos}")
        if cls not in _SUPPORTED:
            raise InvalidKerasConfigurationException(
                f"unsupported Keras layer type {cls!r} (supported: "
                f"{sorted(_SUPPORTED)})")
        out.class_of[name] = cls
        if out.input_type is None and "batch_input_shape" in cfg:
            out.input_type = _input_type_from_shape(
                cfg["batch_input_shape"][1:], cfg.get("dim_ordering", "tf"))
        elif out.input_type is None and "input_dim" in cfg \
                and cfg["input_dim"]:
            out.input_type = InputType.feed_forward(int(cfg["input_dim"]))
        lyr = _to_layer(cls, cfg, last=pos == len(klayers) - 1, loss=loss)
        if lyr is None:
            continue  # shape-only layer (Input/Flatten/Reshape)
        out.index_of[name] = len(out.layers)
        out.layers.append(lyr)
    if not out.layers:
        raise InvalidKerasConfigurationException("model has no layers")
    # Dense followed by a trailing Activation (the Keras idiom
    # Dense(linear) + Activation(softmax)) folds into one OutputLayer, so
    # the network ends in a loss-bearing layer
    if (out.layers[-1].type == ActivationLayer.TYPE
            and len(out.layers) >= 2
            and out.layers[-2].type == DenseLayer.TYPE):
        act = out.layers[-1].fields.get("activation") or "identity"
        dense = out.layers[-2]
        lloss = loss or ("mcxent" if act == "softmax" else "mse")
        merged = OutputLayer.conf(n_out=dense.fields["n_out"], activation=act,
                                  loss=lloss)
        out.layers = out.layers[:-2] + [merged]
        out.index_of = {n: (i if i < len(out.layers) - 1 else
                            len(out.layers) - 1)
                        for n, i in out.index_of.items()
                        if i < len(out.layers) + 1}
    return out


def _to_layer(cls: str, cfg: dict, *, last: bool, loss: Optional[str]):
    """One Keras layer dict -> our layer config (None for shape-only)."""
    act = _act(cfg.get("activation"))
    if cls in ("InputLayer", "Flatten", "Reshape", "RepeatVector"):
        # rank changes are the preprocessors' (inferred from InputType)
        return None
    if cls in ("Dense", "TimeDistributedDense"):
        n_out = int(cfg["output_dim"])
        if last:
            lloss = loss or ("mcxent" if act == "softmax" else "mse")
            klass = (RnnOutputLayer if cls == "TimeDistributedDense"
                     else OutputLayer)
            return klass.conf(n_out=n_out, activation=act, loss=lloss)
        return DenseLayer.conf(n_out=n_out, activation=act)
    if cls == "Activation":
        return ActivationLayer.conf(activation=act)
    if cls == "Dropout":
        return DropoutLayer.conf(dropout=1.0 - float(cfg.get("p", 0.5)))
    if cls == "Convolution2D":
        border = cfg.get("border_mode", "valid")
        sub = cfg.get("subsample", [1, 1])
        return ConvolutionLayer.conf(
            n_out=int(cfg["nb_filter"]),
            kernel_size=(int(cfg["nb_row"]), int(cfg["nb_col"])),
            stride=(int(sub[0]), int(sub[1])),
            convolution_mode="same" if border == "same" else "truncate",
            activation=act)
    if cls in ("MaxPooling2D", "AveragePooling2D"):
        pool = cfg.get("pool_size", [2, 2])
        strides = cfg.get("strides") or pool
        border = cfg.get("border_mode", "valid")
        return SubsamplingLayer.conf(
            pooling_type="max" if cls == "MaxPooling2D" else "avg",
            kernel_size=(int(pool[0]), int(pool[1])),
            stride=(int(strides[0]), int(strides[1])),
            convolution_mode="same" if border == "same" else "truncate")
    if cls == "LSTM":
        return LSTM.conf(n_out=int(cfg["output_dim"]),
                         activation=_act(cfg.get("activation", "tanh")),
                         gate_activation=_act(cfg.get("inner_activation",
                                                      "hard_sigmoid")),
                         peephole=False)
    if cls == "BatchNormalization":
        # Keras BN applies no activation: pin identity so the network's
        # default (sigmoid) does not reach it
        return BatchNormalization.conf(eps=float(cfg.get("epsilon", 1e-5)),
                                       decay=float(cfg.get("momentum", 0.99)),
                                       activation="identity")
    if cls == "Embedding":
        return EmbeddingLayer.conf(n_in=int(cfg["input_dim"]),
                                   n_out=int(cfg["output_dim"]))
    raise InvalidKerasConfigurationException(f"unhandled layer {cls}")


# ---------------------------------------------------------------- weights
def _weight_root(f: H5File) -> str:
    return "/model_weights" if f.exists("/model_weights") else "/"


def _as_list(v) -> List[str]:
    return [v] if isinstance(v, str) else list(v)


def _layer_weights(f: H5File, root: str, lname: str):
    """A layer's weight arrays and their ``weight_names`` (bare
    ``dense_1_W`` or nested ``dense_1/dense_1_W``)."""
    g = f"{root.rstrip('/')}/{lname}"
    if not f.has_attr(g, "weight_names"):
        return [], []
    names = _as_list(f.read_attr(g, "weight_names"))
    out = []
    for wn in names:
        p = f"{g}/{wn}" if f.exists(f"{g}/{wn}") else \
            f"{root.rstrip('/')}/{wn}"
        out.append(f.read_dataset(p))
    return names, out


#: Keras-1's per-gate array suffixes, in a canonical archive's order
#: (input, cell, forget, output)
_LSTM_SUFFIXES = ("W_i", "U_i", "b_i", "W_c", "U_c", "b_c",
                  "W_f", "U_f", "b_f", "W_o", "U_o", "b_o")


def _convert_lstm(ws: List[np.ndarray],
                  names: Optional[List[str]] = None) -> Dict[str, np.ndarray]:
    """Keras-1 LSTM arrays -> ``{W [in, 4H], RW [H, 4H], b [4H]}`` in the
    gate order (input, forget, cell, output). Arrays are matched by their
    ``weight_names`` suffix; by position (the canonical order) when the
    names are absent or not Keras-1 gate names."""
    if len(ws) != 12:
        raise InvalidKerasConfigurationException(
            f"expected 12 LSTM weight arrays (Keras 1 layout), got {len(ws)}")
    by_suffix = {}
    if names and len(names) == 12:
        stripped = [str(n).split("/")[-1] for n in names]
        for suf in _LSTM_SUFFIXES:
            hits = [i for i, n in enumerate(stripped)
                    if n == suf or n.endswith("_" + suf)]
            if len(hits) == 1:
                by_suffix[suf] = ws[hits[0]]
    ordered = ([by_suffix[s] for s in _LSTM_SUFFIXES]
               if len(by_suffix) == 12 else ws)
    wi, ui, bi, wc, uc, bc, wf, uf, bf, wo, uo, bo = ordered
    return {
        "W": np.concatenate([wi, wf, wc, wo], axis=1),
        "RW": np.concatenate([ui, uf, uc, uo], axis=1),
        "b": np.concatenate([bi, bf, bc, bo]),
    }


def _convert_conv(w: np.ndarray, dim_ordering: str) -> np.ndarray:
    if w.ndim == 4 and dim_ordering == "th":
        # (nb_filter, stack, rows, cols) -> (rows, cols, stack, nb_filter)
        return np.transpose(w, (2, 3, 1, 0))
    return w  # tf ordering is HWIO already


def _put(target: dict, name: str, value: np.ndarray) -> None:
    """Copy ``value`` into the tensor ``target[name]`` (shape checked)."""
    t = target[name]
    value = np.asarray(value, np.float32)
    if tuple(value.shape) != tuple(t.shape):
        raise InvalidKerasConfigurationException(
            f"weight {name}: archive shape {tuple(value.shape)} != layer "
            f"shape {tuple(t.shape)}")
    t.copy_(torch.from_numpy(np.ascontiguousarray(value)))


@torch.no_grad()
def _set_layer_params(cls: str, cfg: dict, params: dict, state: dict,
                      ws: List[np.ndarray],
                      names: Optional[List[str]] = None) -> None:
    if not ws:
        return
    if cls in ("Dense", "TimeDistributedDense", "Embedding"):
        _put(params, "W", ws[0])
        if len(ws) > 1:
            _put(params, "b", ws[1])
        elif "b" in params:
            params["b"].zero_()
    elif cls == "Convolution2D":
        # the default agrees with _input_type_from_shape's ("tf")
        _put(params, "W", _convert_conv(ws[0], cfg.get("dim_ordering", "tf")))
        if len(ws) > 1:
            _put(params, "b", ws[1])
    elif cls == "LSTM":
        for k, v in _convert_lstm(ws, names).items():
            _put(params, k, v)
    elif cls == "BatchNormalization":
        _put(params, "gamma", ws[0])
        _put(params, "beta", ws[1])
        if len(ws) > 2:
            _put(state, "mean", ws[2])
        if len(ws) > 3:
            # Keras 1 stores the running variance under running_std
            _put(state, "var", ws[3])
    else:
        raise InvalidKerasConfigurationException(
            f"no weight mapping for layer class {cls}")


# -------------------------------------------------------------- public API
class KerasModelImport:
    """Static facade, as the reference's ``KerasModelImport.java``."""

    @staticmethod
    def import_keras_sequential_model_and_weights(
            path: str, *, enforce_training_config: bool = False,
            device=None):
        """A Keras Sequential HDF5 archive -> an initialized
        ``MultiLayerNetwork`` on ``device`` with the archive's weights."""
        from ..nn.multilayer import MultiLayerNetwork

        with H5File(path) as f:
            model_config = json.loads(f.read_attr("/", "model_config"))
            if model_config.get("class_name") != "Sequential":
                raise InvalidKerasConfigurationException(
                    "not a Sequential model; use "
                    "import_keras_model_and_weights")
            loss = _training_loss(f, enforce_training_config)
            parse = _parse_sequential(model_config, loss)
            net = MultiLayerNetwork(_build_mln_conf(parse),
                                    device=device).init()
            root = _weight_root(f)
            params, states = net.params_list, net.state_list
            for kl in _keras_layers(model_config):
                cfg = kl.get("config", {})
                name = cfg.get("name")
                if name not in parse.index_of:
                    continue
                idx = parse.index_of[name]
                wnames, ws = _layer_weights(f, root, name)
                _set_layer_params(kl["class_name"], cfg, params[idx],
                                  states[idx], ws, wnames)
        net._drop_step_graphs()
        return net

    @staticmethod
    def import_keras_model_and_weights(path: str, device=None):
        """A Keras functional-API HDF5 archive -> an initialized
        ``ComputationGraph`` on ``device``. Merge -> ``MergeVertex``
        (concat) or ``ElementWiseVertex`` (sum, ave, mul, max)."""
        from ..nn.graph_network import ComputationGraph

        with H5File(path) as f:
            model_config = json.loads(f.read_attr("/", "model_config"))
            if model_config.get("class_name") == "Sequential":
                raise InvalidKerasConfigurationException(
                    "Sequential model; use "
                    "import_keras_sequential_model_and_weights")
            loss = _training_loss(f, False)
            conf, class_of, cfg_of = _build_graph_conf(model_config, loss)
            net = ComputationGraph(conf, device=device).init()
            root = _weight_root(f)
            params, states = net.params_list, net.state_list
            for name, cls in class_of.items():
                if name not in params:
                    continue
                wnames, ws = _layer_weights(f, root, name)
                _set_layer_params(cls, cfg_of[name], params[name],
                                  states.get(name, {}), ws, wnames)
        net._drop_step_graphs()
        return net

    @staticmethod
    def import_keras_model_configuration(path_or_json: str):
        """Model-config JSON (a file path or the string) -> the
        configuration only."""
        s = path_or_json
        if not s.lstrip().startswith("{"):
            with open(s) as fh:
                s = fh.read()
        model_config = json.loads(s)
        if model_config.get("class_name") == "Sequential":
            return _build_mln_conf(_parse_sequential(model_config, None))
        return _build_graph_conf(model_config, None)[0]


def _training_loss(f: H5File, enforce: bool) -> Optional[str]:
    if not f.has_attr("/", "training_config"):
        if enforce:
            raise InvalidKerasConfigurationException(
                "model has no training_config (was it compiled before "
                "saving?)")
        return None
    tc = json.loads(f.read_attr("/", "training_config"))
    kloss = tc.get("loss")
    if isinstance(kloss, dict):
        kloss = next(iter(kloss.values()), None)
    if kloss is None:
        return None
    if kloss not in _LOSSES:
        raise InvalidKerasConfigurationException(
            f"unsupported Keras loss {kloss!r}")
    return _LOSSES[kloss]


def _build_mln_conf(parse: _SequentialParse):
    lb = NeuralNetConfiguration.builder().list()
    for lyr in parse.layers:
        lb.layer(lyr)
    if parse.input_type is not None:
        lb.set_input_type(parse.input_type)
    return lb.build()


def _build_graph_conf(model_config: dict, loss: Optional[str]):
    cfg = model_config["config"]
    klayers = cfg["layers"]
    output_names = {ol[0] for ol in cfg["output_layers"]}
    gb = NeuralNetConfiguration.builder().graph_builder()
    input_types = []
    class_of: Dict[str, str] = {}
    cfg_of: Dict[str, dict] = {}
    for kl in klayers:
        cls = kl["class_name"]
        lcfg = kl.get("config", {})
        name = lcfg.get("name")
        class_of[name] = cls
        cfg_of[name] = lcfg
        inbound = [n[0] for node in kl.get("inbound_nodes", []) for n in node]
        if cls == "InputLayer":
            gb.add_inputs(name)
            input_types.append(_input_type_from_shape(
                lcfg["batch_input_shape"][1:],
                lcfg.get("dim_ordering", "tf")))
            continue
        if cls == "Merge":
            mode = lcfg.get("mode", "concat")
            if mode == "concat":
                gb.add_vertex(name, MergeVertex(), *inbound)
            elif mode in ("sum", "ave", "mul", "max"):
                op = {"sum": "add", "ave": "average", "mul": "product",
                      "max": "max"}[mode]
                gb.add_vertex(name, ElementWiseVertex(op=op), *inbound)
            else:
                raise InvalidKerasConfigurationException(
                    f"unsupported Merge mode {mode!r}")
            continue
        lyr = _to_layer(cls, lcfg, last=name in output_names, loss=loss)
        if lyr is None:
            # shape-only (Flatten/Reshape): consumers read its input
            class_of.pop(name)
            for other in klayers:
                for node in other.get("inbound_nodes", []):
                    for n in node:
                        if n[0] == name:
                            n[0] = inbound[0]
            continue
        gb.add_layer(name, lyr, *inbound)
    gb.set_outputs(*[ol[0] for ol in cfg["output_layers"]])
    if input_types:
        gb.set_input_types(*input_types)
    return gb.build(), class_of, cfg_of
