"""The port's Keras gateway (``keras_server/__init__.py``: the HDF5 minibatch
iterator, ``DeepLearning4jEntryPoint``, the JSON-lines ``Server`` and
``call``) on the contracts of ``tests/test_keras_server.py``, its fit held
against the JAX entry point's on the same archive and batches, and
``load_model_file`` / ``ModelRegistry.load`` serving a Keras archive."""
import json

import numpy as np
import pytest

import _torch_port  # noqa: F401  (private JAX executable cache)
from deeplearning4j_tpu.keras_server import (
    DeepLearning4jEntryPoint as JEntryPoint)
from deeplearning4j_tpu_torch.keras_server import (
    DeepLearning4jEntryPoint, HDF5MiniBatchDataSetIterator, ModelRegistry,
    Server, call)
from deeplearning4j_tpu_torch.keras_server.registry import load_model_file
from deeplearning4j_tpu_torch.modelimport.hdf5 import H5File


def _model_archive(path):
    rng = np.random.default_rng(0)
    mc = {"class_name": "Sequential", "config": [
        {"class_name": "Dense", "config": {
            "name": "dense_1", "output_dim": 8, "activation": "relu",
            "batch_input_shape": [None, 4]}},
        {"class_name": "Dense", "config": {
            "name": "dense_2", "output_dim": 3, "activation": "softmax"}},
    ]}
    with H5File(str(path), "w") as f:
        f.write_attr("/", "model_config", json.dumps(mc))
        f.write_attr("/", "training_config",
                     json.dumps({"loss": "categorical_crossentropy"}))
        f.create_group("/model_weights")
        f.write_attr("/model_weights", "layer_names", ["dense_1", "dense_2"])
        for lname, shape in [("dense_1", (4, 8)), ("dense_2", (8, 3))]:
            f.create_group(f"/model_weights/{lname}")
            f.write_attr(f"/model_weights/{lname}", "weight_names",
                         [f"{lname}_W", f"{lname}_b"])
            f.write_dataset(f"/model_weights/{lname}/{lname}_W",
                            rng.normal(0, 0.3, shape).astype(np.float32))
            f.write_dataset(f"/model_weights/{lname}/{lname}_b",
                            np.zeros(shape[1], np.float32))


def _batches(tmp_path):
    """Separable 3-class data in 4-D, 4 batches of 32."""
    rng = np.random.default_rng(1)
    xdir, ydir = tmp_path / "x", tmp_path / "y"
    xdir.mkdir(), ydir.mkdir()
    for b in range(4):
        labels = rng.integers(0, 3, 32)
        x = rng.normal(0, 0.3, (32, 4)).astype(np.float32)
        x[np.arange(32), labels] += 2.0
        y = np.eye(3, dtype=np.float32)[labels]
        with H5File(str(xdir / f"{b}.h5"), "w") as f:
            f.write_dataset("/data", x)
        with H5File(str(ydir / f"{b}.h5"), "w") as f:
            f.write_dataset("/data", y)
    return str(xdir), str(ydir)


def test_minibatch_iterator_orders_numerically(tmp_path):
    d = tmp_path / "b"
    d.mkdir()
    for i in [10, 2, 0]:
        with H5File(str(d / f"{i}.h5"), "w") as f:
            f.write_dataset("/data", np.full((2, 2), i, np.float32))
    it = HDF5MiniBatchDataSetIterator(str(d))
    assert len(it) == 3
    assert [int(a[0, 0]) for a in it] == [0, 2, 10]
    with pytest.raises(FileNotFoundError):
        HDF5MiniBatchDataSetIterator(str(tmp_path))


def test_entry_point_fit_and_evaluate_match_jax(tmp_path):
    """The port's fit and evaluate reach the contract's accuracy, with the
    same score and accuracy as the JAX entry point on the same archive and
    batches (float32 training on the CPU in both)."""
    model = tmp_path / "model.h5"
    _model_archive(model)
    xdir, ydir = _batches(tmp_path)
    ep = DeepLearning4jEntryPoint(device="cpu")
    r = ep.fit(str(model), nb_epoch=12, train_features_directory=xdir,
               train_labels_directory=ydir)
    assert r["batches"] == 4 and r["epochs"] == 12
    ev = ep.evaluate(str(model), xdir, ydir)
    assert ev["accuracy"] > 0.8 and ev["examples"] == 128
    jep = JEntryPoint()
    jr = jep.fit(str(model), nb_epoch=12, train_features_directory=xdir,
                 train_labels_directory=ydir)
    assert r["score"] == pytest.approx(jr["score"], rel=1e-4)
    assert ev == jep.evaluate(str(model), xdir, ydir)
    x = np.random.default_rng(2).normal(size=(5, 4)).tolist()
    np.testing.assert_allclose(
        ep.predict(str(model), x)["predictions"],
        jep.predict(str(model), x)["predictions"], rtol=1e-4, atol=1e-5)


def test_gateway_over_tcp(tmp_path):
    model = tmp_path / "model.h5"
    _model_archive(model)
    xdir, ydir = _batches(tmp_path)
    srv = Server(device="cpu").start()
    try:
        r = call("127.0.0.1", srv.port, "fit", model_file_path=str(model),
                 nb_epoch=3, train_features_directory=xdir,
                 train_labels_directory=ydir)
        assert r["epochs"] == 3
        p = call("127.0.0.1", srv.port, "predict",
                 model_file_path=str(model),
                 features=[[2.0, 0.0, 0.0, 0.0]])
        assert len(p["predictions"][0]) == 3
        with pytest.raises(RuntimeError):
            call("127.0.0.1", srv.port, "fit", model_file_path="/nope.h5",
                 nb_epoch=1, train_features_directory=xdir,
                 train_labels_directory=ydir)
        with pytest.raises(RuntimeError, match="unknown method"):
            call("127.0.0.1", srv.port, "shutdown")
    finally:
        srv.stop()


def test_server_refuses_public_bind_without_token():
    with pytest.raises(ValueError, match="auth_token"):
        Server(host="0.0.0.0")


def test_server_token_auth_enforced(tmp_path):
    srv = Server(host="127.0.0.1", auth_token="s3cret", device="cpu").start()
    try:
        with pytest.raises(RuntimeError, match="auth token"):
            call("127.0.0.1", srv.port, "predict",
                 model_file_path="x", features=[])
        with pytest.raises(RuntimeError, match="auth token"):
            call("127.0.0.1", srv.port, "predict", token="wrong",
                 model_file_path="x", features=[])
        # the right token reaches the method, which then fails on the
        # missing file: auth passed, not silently rejected
        with pytest.raises(RuntimeError) as ei:
            call("127.0.0.1", srv.port, "predict", token="s3cret",
                 model_file_path="/nonexistent.h5", features=[[1.0]])
        assert "auth token" not in str(ei.value)
    finally:
        srv.stop()


def test_load_model_file_serves_keras_archives(tmp_path):
    """``load_model_file`` reads a Keras archive (no HDF5 library), and a
    registry pin of it answers as the network does."""
    model = tmp_path / "model.h5"
    _model_archive(model)
    net = load_model_file(str(model), device="cpu")
    x = np.random.default_rng(3).normal(size=(6, 4)).astype(np.float32)
    mv = ModelRegistry().load("keras", str(model), device="cpu")
    np.testing.assert_array_equal(np.asarray(mv.predict_fn(x)),
                                  net.output(x).numpy())
    assert type(net).__name__ == "MultiLayerNetwork"
