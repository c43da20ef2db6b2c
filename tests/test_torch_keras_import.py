"""The port's Keras-1 import held against the JAX ``KerasModelImport`` on the
same archives (the contracts of ``tests/test_keras_import.py``).

Each archive is written in the Keras-1 layout (``model_config`` and
``training_config`` root attributes, a ``model_weights`` group with
``layer_names`` and ``weight_names``) by the JAX ``H5File`` (libhdf5) or by
the port's own writer, and imported by both packages: the parameters and
batch-norm states bitwise equal, the outputs within 1e-6 (float32 on the
CPU, the same sums in another order), and both within the JAX contract's
tolerance of the numpy reference.
"""
import json

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (private JAX executable cache)
from deeplearning4j_tpu.modelimport.hdf5 import H5File as JH5File
from deeplearning4j_tpu.modelimport.keras_import import (
    InvalidKerasConfigurationException as JInvalid,
    KerasModelImport as JImport)
from deeplearning4j_tpu_torch.convert import to_numpy
from deeplearning4j_tpu_torch.modelimport.hdf5 import H5File
from deeplearning4j_tpu_torch.modelimport.keras_import import (
    InvalidKerasConfigurationException, KerasModelImport)

WRITERS = {"jax": JH5File, "port": H5File}
#: port output against the JAX output: float32 sums in another order
OUT_TOL = dict(rtol=1e-5, atol=1e-6)


def _write_archive(path, model_config, weights, training_config=None,
                   writer="jax"):
    """weights: {layer_name: [(weight_name, array), ...]}"""
    with WRITERS[writer](str(path), "w") as f:
        f.write_attr("/", "model_config", json.dumps(model_config))
        if training_config is not None:
            f.write_attr("/", "training_config", json.dumps(training_config))
        f.create_group("/model_weights")
        f.write_attr("/model_weights", "layer_names", list(weights))
        for lname, ws in weights.items():
            f.create_group(f"/model_weights/{lname}")
            f.write_attr(f"/model_weights/{lname}", "weight_names",
                         [wn for wn, _ in ws])
            for wn, arr in ws:
                f.write_dataset(f"/model_weights/{lname}/{wn}", arr)


def _seq(layers):
    return {"class_name": "Sequential",
            "config": [{"class_name": c, "config": cfg}
                       for c, cfg in layers]}


def _both(path, functional=False):
    """(JAX network, port network on the CPU) imported from ``path``."""
    if functional:
        return (JImport.import_keras_model_and_weights(str(path)),
                KerasModelImport.import_keras_model_and_weights(
                    str(path), device="cpu"))
    return (JImport.import_keras_sequential_model_and_weights(str(path)),
            KerasModelImport.import_keras_sequential_model_and_weights(
                str(path), device="cpu"))


def _same_params(jnet, net):
    """Params and states bitwise equal, leaf for leaf."""
    jp, jst = jnet.params_list, jnet.state_list
    pp, pst = to_numpy(net.params_list), to_numpy(net.state_list)
    keys = range(len(jp)) if isinstance(jp, list) else jp.keys()
    for k in keys:
        assert set(jp[k]) == set(pp[k]), k
        for name in jp[k]:
            np.testing.assert_array_equal(pp[k][name], np.asarray(jp[k][name]))
        for name in jst[k] if jst[k] else ():
            np.testing.assert_array_equal(pst[k][name],
                                          np.asarray(jst[k][name]))


def _softmax(z):
    e = np.exp(z - z.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_dense_sequential_forward_matches_numpy(tmp_path, writer):
    rng = np.random.default_rng(0)
    w1 = rng.normal(size=(4, 8)).astype(np.float32)
    b1 = rng.normal(size=(8,)).astype(np.float32)
    w2 = rng.normal(size=(8, 3)).astype(np.float32)
    b2 = rng.normal(size=(3,)).astype(np.float32)
    mc = _seq([
        ("Dense", {"name": "dense_1", "output_dim": 8, "activation": "relu",
                   "batch_input_shape": [None, 4]}),
        ("Dense", {"name": "dense_2", "output_dim": 3,
                   "activation": "softmax"}),
    ])
    p = tmp_path / "m.h5"
    _write_archive(p, mc, {
        "dense_1": [("dense_1_W", w1), ("dense_1_b", b1)],
        "dense_2": [("dense_2_W", w2), ("dense_2_b", b2)],
    }, training_config={"loss": "categorical_crossentropy"}, writer=writer)
    jnet, net = _both(p)
    _same_params(jnet, net)
    assert net.conf.to_json() == jnet.conf.to_json()
    x = rng.normal(size=(5, 4)).astype(np.float32)
    got = net.output(x).numpy()
    expect = _softmax(np.maximum(x @ w1 + b1, 0) @ w2 + b2)
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jnet.output(x)), **OUT_TOL)


def test_dense_plus_activation_folds_to_output_layer(tmp_path):
    rng = np.random.default_rng(1)
    w = rng.normal(size=(4, 3)).astype(np.float32)
    b = np.zeros(3, np.float32)
    mc = _seq([
        ("Dense", {"name": "dense_1", "output_dim": 3,
                   "activation": "linear", "batch_input_shape": [None, 4]}),
        ("Activation", {"name": "activation_1", "activation": "softmax"}),
    ])
    p = tmp_path / "m.h5"
    _write_archive(p, mc, {"dense_1": [("dense_1_W", w), ("dense_1_b", b)]},
                   writer="port")
    jnet, net = _both(p)
    assert net.conf.n_layers == jnet.conf.n_layers == 1
    assert net.conf.layers[0].type == "Output"
    assert type(jnet.conf.layers[0]).__name__ == "OutputLayer"
    _same_params(jnet, net)
    x = rng.normal(size=(2, 4)).astype(np.float32)
    out = net.output(x).numpy()
    np.testing.assert_allclose(out.sum(axis=1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(out, np.asarray(jnet.output(x)), **OUT_TOL)


def test_conv_th_ordering_transposed(tmp_path):
    rng = np.random.default_rng(2)
    w = rng.normal(size=(2, 1, 3, 3)).astype(np.float32)  # th layout
    b = np.zeros(2, np.float32)
    wd = rng.normal(size=(2 * 13 * 13, 5)).astype(np.float32)
    bd = np.zeros(5, np.float32)
    mc = _seq([
        ("Convolution2D", {"name": "conv_1", "nb_filter": 2, "nb_row": 3,
                           "nb_col": 3, "dim_ordering": "th",
                           "activation": "relu", "border_mode": "valid",
                           "batch_input_shape": [None, 1, 28, 28]}),
        ("MaxPooling2D", {"name": "pool_1", "pool_size": [2, 2],
                          "dim_ordering": "th"}),
        ("Flatten", {"name": "flat_1"}),
        ("Dense", {"name": "dense_1", "output_dim": 5,
                   "activation": "softmax"}),
    ])
    p = tmp_path / "m.h5"
    _write_archive(p, mc, {
        "conv_1": [("conv_1_W", w), ("conv_1_b", b)],
        "dense_1": [("dense_1_W", wd), ("dense_1_b", bd)],
    }, training_config={"loss": "categorical_crossentropy"})
    jnet, net = _both(p)
    # the kernel lands as HWIO = transpose(2, 3, 1, 0) of the th layout
    np.testing.assert_array_equal(net.params_list[0]["W"].detach().numpy(),
                                  np.transpose(w, (2, 3, 1, 0)))
    _same_params(jnet, net)
    x = rng.normal(size=(2, 28, 28, 1)).astype(np.float32)
    out = net.output(x).numpy()
    assert out.shape == (2, 5)
    # unit-normal weights over 338 inputs give logits of magnitude ~50: a
    # float32 rounding of a logit moves a probability by ~1e-5 of itself
    np.testing.assert_allclose(out, np.asarray(jnet.output(x)), rtol=1e-4,
                               atol=1e-6)


def _lstm_gates(rng, n_in, h):
    return {g: (rng.normal(size=(n_in, h)).astype(np.float32),
                rng.normal(size=(h, h)).astype(np.float32),
                rng.normal(size=(h,)).astype(np.float32))
            for g in "icfo"}


def _lstm_archive(path, gates, order, n_in, h, t, inner, wd, writer="jax"):
    ws = []
    for g in order:
        W, U, b = gates[g]
        ws += [(f"lstm_1_W_{g}", W), (f"lstm_1_U_{g}", U),
               (f"lstm_1_b_{g}", b)]
    mc = _seq([
        ("LSTM", {"name": "lstm_1", "output_dim": h, "activation": "tanh",
                  "inner_activation": inner, "return_sequences": True,
                  "batch_input_shape": [None, t, n_in]}),
        ("TimeDistributedDense", {"name": "td_1", "output_dim": 2,
                                  "activation": "softmax"}),
    ])
    _write_archive(path, mc, {
        "lstm_1": ws,
        "td_1": [("td_1_W", wd), ("td_1_b", np.zeros(2, np.float32))],
    }, training_config={"loss": "categorical_crossentropy"}, writer=writer)


@pytest.mark.parametrize("inner", ["sigmoid", "hard_sigmoid"])
def test_lstm_weight_fusion(tmp_path, inner):
    """Gates fused in the order (i, f, c, o); the output against JAX's with
    sigmoid gates (the kernels' standard cell) and with Keras 1's default
    hard_sigmoid gates (the plain cell in both packages)."""
    rng = np.random.default_rng(3)
    n_in, h = 6, 4
    gates = _lstm_gates(rng, n_in, h)
    wd = rng.normal(size=(h, 2)).astype(np.float32)
    p = tmp_path / "m.h5"
    _lstm_archive(p, gates, "icfo", n_in, h, 7, inner, wd, writer="port")
    jnet, net = _both(p)
    expect_W = np.concatenate([gates[g][0] for g in "ifco"], axis=1)
    expect_RW = np.concatenate([gates[g][1] for g in "ifco"], axis=1)
    W, RW = (net.params_list[0][k].detach().numpy() for k in ("W", "RW"))
    np.testing.assert_array_equal(W, expect_W)
    np.testing.assert_array_equal(RW, expect_RW)
    _same_params(jnet, net)
    layer = net.layers[0]
    assert layer.gate_activation == ("sigmoid" if inner == "sigmoid"
                                     else "hardsigmoid")
    assert not layer.peephole
    x = rng.normal(size=(2, 7, n_in)).astype(np.float32)
    out = net.output(x).numpy()
    assert out.shape == (2, 7, 2) and np.all(np.isfinite(out))
    np.testing.assert_allclose(out, np.asarray(jnet.output(x)), **OUT_TOL)


def test_batchnorm_state_mapping(tmp_path):
    rng = np.random.default_rng(4)
    gamma = rng.normal(size=(4,)).astype(np.float32)
    beta = rng.normal(size=(4,)).astype(np.float32)
    mean = rng.normal(size=(4,)).astype(np.float32)
    var = np.abs(rng.normal(size=(4,))).astype(np.float32)
    wd = rng.normal(size=(4, 2)).astype(np.float32)
    mc = _seq([
        ("BatchNormalization", {"name": "bn_1", "epsilon": 1e-3,
                                "momentum": 0.95,
                                "batch_input_shape": [None, 4]}),
        ("Dense", {"name": "dense_1", "output_dim": 2,
                   "activation": "softmax"}),
    ])
    p = tmp_path / "m.h5"
    _write_archive(p, mc, {
        "bn_1": [("bn_1_gamma", gamma), ("bn_1_beta", beta),
                 ("bn_1_running_mean", mean), ("bn_1_running_std", var)],
        "dense_1": [("dense_1_W", wd), ("dense_1_b", np.zeros(2, np.float32))],
    }, training_config={"loss": "categorical_crossentropy"}, writer="port")
    jnet, net = _both(p)
    np.testing.assert_array_equal(
        net.params_list[0]["gamma"].detach().numpy(), gamma)
    np.testing.assert_array_equal(net.state_list[0]["mean"].numpy(), mean)
    np.testing.assert_array_equal(net.state_list[0]["var"].numpy(), var)
    _same_params(jnet, net)
    # inference uses the imported running statistics
    x = rng.normal(size=(3, 4)).astype(np.float32)
    out = net.feed_forward(x)[0].numpy()
    expect = gamma * (x - mean) / np.sqrt(var + 1e-3) + beta
    np.testing.assert_allclose(out, expect, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out, np.asarray(jnet.feed_forward(x)[0]),
                               **OUT_TOL)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_functional_merge_model(tmp_path, writer):
    rng = np.random.default_rng(5)
    wa = rng.normal(size=(3, 4)).astype(np.float32)
    wb = rng.normal(size=(5, 4)).astype(np.float32)
    wo = rng.normal(size=(8, 2)).astype(np.float32)
    mc = {"class_name": "Model", "config": {
        "name": "model_1",
        "layers": [
            {"class_name": "InputLayer", "config": {
                "name": "in_a", "batch_input_shape": [None, 3]},
             "inbound_nodes": []},
            {"class_name": "InputLayer", "config": {
                "name": "in_b", "batch_input_shape": [None, 5]},
             "inbound_nodes": []},
            {"class_name": "Dense", "config": {
                "name": "da", "output_dim": 4, "activation": "relu"},
             "inbound_nodes": [[["in_a", 0, 0]]]},
            {"class_name": "Dense", "config": {
                "name": "db", "output_dim": 4, "activation": "relu"},
             "inbound_nodes": [[["in_b", 0, 0]]]},
            {"class_name": "Merge", "config": {
                "name": "merge_1", "mode": "concat"},
             "inbound_nodes": [[["da", 0, 0], ["db", 0, 0]]]},
            {"class_name": "Dense", "config": {
                "name": "out", "output_dim": 2, "activation": "softmax"},
             "inbound_nodes": [[["merge_1", 0, 0]]]},
        ],
        "input_layers": [["in_a", 0, 0], ["in_b", 0, 0]],
        "output_layers": [["out", 0, 0]],
    }}
    p = tmp_path / "m.h5"
    _write_archive(p, mc, {
        "da": [("da_W", wa), ("da_b", np.zeros(4, np.float32))],
        "db": [("db_W", wb), ("db_b", np.zeros(4, np.float32))],
        "out": [("out_W", wo), ("out_b", np.zeros(2, np.float32))],
    }, training_config={"loss": "categorical_crossentropy"}, writer=writer)
    jnet, net = _both(p, functional=True)
    _same_params(jnet, net)
    assert net.conf.to_json() == jnet.conf.to_json()
    xa = rng.normal(size=(6, 3)).astype(np.float32)
    xb = rng.normal(size=(6, 5)).astype(np.float32)
    out = net.output(xa, xb)[0].numpy()
    z = np.concatenate([np.maximum(xa @ wa, 0), np.maximum(xb @ wb, 0)],
                       axis=1) @ wo
    np.testing.assert_allclose(out, _softmax(z), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(out, np.asarray(jnet.output(xa, xb)[0]),
                               **OUT_TOL)


def test_config_only_import_and_unsupported_layer():
    mc = _seq([("Dense", {"name": "d", "output_dim": 3,
                          "activation": "softmax",
                          "batch_input_shape": [None, 4]})])
    conf = KerasModelImport.import_keras_model_configuration(json.dumps(mc))
    jconf = JImport.import_keras_model_configuration(json.dumps(mc))
    assert conf.n_layers == jconf.n_layers == 1
    assert conf.to_json() == jconf.to_json()
    bad = _seq([("LocallyConnected2D", {"name": "x"})])
    with pytest.raises(InvalidKerasConfigurationException) as got:
        KerasModelImport.import_keras_model_configuration(json.dumps(bad))
    with pytest.raises(JInvalid) as want:
        JImport.import_keras_model_configuration(json.dumps(bad))
    assert str(got.value) == str(want.value)


def test_attr_overwrite_and_uint_dataset(tmp_path):
    p = tmp_path / "o.h5"
    with H5File(str(p), "w") as f:
        f.write_attr("/", "model_config", "old")
        f.write_attr("/", "model_config", "new")  # must overwrite
        f.write_dataset("/labels", np.arange(4, dtype=np.uint32))
    for reader in (H5File, JH5File):
        with reader(str(p)) as f:
            assert f.read_attr("/", "model_config") == "new"
            out = f.read_dataset("/labels")
            assert out.dtype == np.uint32
            np.testing.assert_array_equal(out, [0, 1, 2, 3])


def test_lstm_weight_fusion_scrambled_weight_names(tmp_path):
    """Gate arrays are matched by their weight_names suffix, not by list
    position: an archive listing the 12 LSTM arrays out of the canonical
    order imports the same parameters, in both packages."""
    rng = np.random.default_rng(13)
    n_in, h = 5, 3
    gates = _lstm_gates(rng, n_in, h)
    wd = rng.normal(size=(h, 2)).astype(np.float32)
    p1, p2 = tmp_path / "canon.h5", tmp_path / "scrambled.h5"
    _lstm_archive(p1, gates, "icfo", n_in, h, 4, "sigmoid", wd)
    _lstm_archive(p2, gates, "ofci", n_in, h, 4, "sigmoid", wd)
    jnet1, net1 = _both(p1)
    jnet2, net2 = _both(p2)
    for k in ("W", "RW", "b"):
        np.testing.assert_array_equal(net1.params_list[0][k].detach().numpy(),
                                      net2.params_list[0][k].detach().numpy())
    _same_params(jnet1, net1)
    _same_params(jnet2, net2)


def test_import_defaults_to_cuda(tmp_path, monkeypatch):
    """Without ``device`` the import builds on CUDA, and raises without it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mc = _seq([("Dense", {"name": "d", "output_dim": 3,
                          "activation": "softmax",
                          "batch_input_shape": [None, 4]})])
    p = tmp_path / "m.h5"
    _write_archive(p, mc, {"d": [("d_W", np.ones((4, 3), np.float32)),
                                 ("d_b", np.zeros(3, np.float32))]},
                   writer="port")
    with pytest.raises(RuntimeError, match="CUDA"):
        KerasModelImport.import_keras_sequential_model_and_weights(str(p))
