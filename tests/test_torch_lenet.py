"""The port's LeNet-5 (``lenet_mnist``) on ``MultiLayerNetwork`` held
against the JAX package on the CPU, with MNIST, the iterators and
evaluation.

Weights cross by ``convert.from_jax``. Tolerances (float32, sums in another
order): ``output`` atol 1e-5; three Nesterov ``fit`` steps, losses within
1e-5 relative and params within atol 1e-5; the flat ``params()`` vector
exactly; ``predict``, the accuracy and the confusion matrix exactly, and
``score_examples`` within atol 1e-5, on the synthetic digits. The
synthetic MNIST arrays and every iterator's batch order are bitwise the
JAX package's.
"""
import gzip
import struct

import numpy as np
import pytest

from _torch_port import compile_cache_at, jax_train
from deeplearning4j_tpu.datasets import dataset as jds
from deeplearning4j_tpu.datasets import iterators as jit
from deeplearning4j_tpu.datasets import mnist as jmnist
from deeplearning4j_tpu.eval import evaluation as jeval
from deeplearning4j_tpu.eval import regression as jreg
from deeplearning4j_tpu.eval import roc as jroc
from deeplearning4j_tpu.models.lenet import lenet_mnist as jax_lenet
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch import eval as teval
from deeplearning4j_tpu_torch.convert import from_jax
from deeplearning4j_tpu_torch.datasets import dataset as tds
from deeplearning4j_tpu_torch.datasets import iterators as tit
from deeplearning4j_tpu_torch.datasets import mnist as tmnist
from deeplearning4j_tpu_torch.models import lenet_mnist
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

ATOL = 1e-5
REL = 1e-5


@pytest.fixture
def no_real_mnist(monkeypatch, tmp_path):
    """Neither package finds IDX files: both serve the synthetic digits."""
    monkeypatch.setattr(jmnist, "_SEARCH_DIRS", [])
    monkeypatch.delenv("MNIST_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert tmnist.search_dirs() == [str(tmp_path / ".cache" / "mnist")]


@pytest.fixture(scope="module")
def lenet(tmp_path_factory):
    """A JAX LeNet, its port (JAX weights), and synthetic digits: 64 for
    training, 200 for testing."""
    cache = tmp_path_factory.mktemp("xcache")
    train = tmnist.synthetic_mnist(64, seed=123)
    test = tmnist.synthetic_mnist(200, seed=321)

    def xy(data):
        images, labels = data
        return (images.reshape(len(images), -1).astype(np.float32) / 255.0,
                np.eye(10, dtype=np.float32)[labels])

    with compile_cache_at(cache):
        jnet = JNet(jax_lenet()).init()
    params = [{k: np.asarray(v) for k, v in p.items()}
              for p in jnet.params_list]
    tnet = from_jax(jnet.conf.to_json(), params, device="cpu")
    return {"jnet": jnet, "tnet": tnet, "cache": cache, "train": xy(train),
            "test": xy(test)}


def test_lenet_output_matches_jax(lenet):
    x, _ = lenet["test"]
    with compile_cache_at(lenet["cache"]):
        ref = np.asarray(lenet["jnet"].output(x[:32]))
    out = lenet["tnet"].output(x[:32])
    assert out.shape == (32, 10)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)
    # the layer outputs keep the JAX layouts: NHWC after each conv and pool
    shapes = [tuple(a.shape) for a in lenet["tnet"].feed_forward(x[:2])]
    assert shapes == [(2, 24, 24, 20), (2, 12, 12, 20), (2, 8, 8, 50),
                      (2, 4, 4, 50), (2, 500), (2, 10)]


def test_lenet_fit_matches_jax(lenet, tmp_path):
    """Three Nesterov steps from the same weights: each loss and the final
    params."""
    x, y = lenet["train"]
    batches = [(x[i * 16:(i + 1) * 16], y[i * 16:(i + 1) * 16], None, None)
               for i in range(3)]
    ref = jax_train(jax_lenet().to_json(), batches, tmp_path)
    net = from_jax(jax_lenet().to_json(), ref["params0"], device="cpu")
    losses = []
    for bx, by, _, _ in batches:
        net.fit(bx, by)
        losses.append(net.score_value)
    np.testing.assert_allclose(losses, ref["losses"], rtol=REL, atol=0)
    assert losses[-1] < losses[0]
    for got, want in zip(net.params_list, ref["params"]):
        for k in want:
            np.testing.assert_allclose(got[k].detach().numpy(), want[k],
                                       rtol=0, atol=ATOL)
    assert net.iteration == ref["iteration"] == 3


def test_lenet_fit_iterator_matches_jax(lenet, no_real_mnist, tmp_path):
    """One epoch of ``fit_iterator`` over shuffled MNIST batches (the JAX
    package runs its K-step dispatch there, the port single steps)."""
    with compile_cache_at(tmp_path):
        jnet = JNet(jax_lenet()).init()
        params0 = [{k: np.asarray(v) for k, v in p.items()}
                   for p in jnet.params_list]
        jnet.fit_iterator(jmnist.MnistDataSetIterator(32, num_examples=96))
        want = [{k: np.asarray(v) for k, v in p.items()}
                for p in jnet.params_list]
    net = from_jax(jax_lenet().to_json(), params0, device="cpu")
    net.fit_iterator(tmnist.MnistDataSetIterator(32, num_examples=96))
    assert net.iteration == jnet.iteration == 3 and net.epoch == 1
    for got, w in zip(net.params_list, want):
        for k in w:
            np.testing.assert_allclose(got[k].detach().numpy(), w[k],
                                       rtol=0, atol=ATOL)


def test_lenet_params_vector_matches_jax(lenet):
    jnet, tnet = lenet["jnet"], lenet["tnet"]
    with compile_cache_at(lenet["cache"]):
        flat = np.asarray(jnet.params())
    assert tnet.num_params() == jnet.num_params() == 431080 == flat.size
    np.testing.assert_array_equal(tnet.params().numpy(), flat)
    # set_params round-trips a vector, and the forward follows it
    net = tnet.clone()
    other = (flat * 0.5 + 0.01).astype(np.float32)
    net.set_params(other)
    np.testing.assert_array_equal(net.params().numpy(), other)
    with compile_cache_at(lenet["cache"]):
        jclone = jnet.clone()
        jclone.set_params(other)
        x, _ = lenet["test"]
        ref = np.asarray(jclone.output(x[:8]))
    np.testing.assert_allclose(net.output(x[:8]).numpy(), ref, rtol=0,
                               atol=ATOL)
    with pytest.raises(ValueError):
        net.set_params(other[:-1])


def test_lenet_predict_score_examples_evaluate_match_jax(lenet):
    jnet, tnet = lenet["jnet"], lenet["tnet"]
    x, y = lenet["test"]
    with compile_cache_at(lenet["cache"]):
        jpred = jnet.predict(x)
        jscores = jnet.score_examples(x, y)
        jscores_reg = jnet.score_examples(x[:4], y[:4],
                                          add_regularization=True)
        jev = jnet.evaluate(x, y)
        jscore = jnet.score(x, y)
        jf1 = jnet.f1_score(x, y)
    np.testing.assert_array_equal(tnet.predict(x), jpred)
    scores = tnet.score_examples(x, y)
    assert scores.shape == (200,)
    np.testing.assert_allclose(scores, np.asarray(jscores), rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        tnet.score_examples(x[:4], y[:4], add_regularization=True),
        np.asarray(jscores_reg), rtol=0, atol=ATOL)
    ev = tnet.evaluate(x, y)
    assert ev.accuracy() == jev.accuracy()
    np.testing.assert_array_equal(ev.confusion.matrix, jev.confusion.matrix)
    assert ev.stats() == jev.stats()
    np.testing.assert_allclose(tnet.score(x, y), jscore, rtol=REL)
    assert tnet.f1_score(tds.DataSet(x, y)) == jf1
    # a DataSet's score_examples and the iterator form of evaluate
    np.testing.assert_allclose(tnet.score_examples(tds.DataSet(x, y)),
                               scores, rtol=0, atol=0)
    ev_it = tnet.evaluate(tit.ArrayDataSetIterator(x, y, 64, drop_last=False))
    np.testing.assert_array_equal(ev_it.confusion.matrix, ev.confusion.matrix)


def test_lenet_gradient_and_score_matches_jax(lenet):
    x, y = lenet["train"]
    with compile_cache_at(lenet["cache"]):
        jgrads, jscore = lenet["jnet"].gradient_and_score(x[:16], y[:16])
    grads, score = lenet["tnet"].gradient_and_score(x[:16], y[:16])
    np.testing.assert_allclose(score, jscore, rtol=REL)
    for g, jg in zip(grads, jgrads):
        assert sorted(g) == sorted(jg)
        for k in g:
            np.testing.assert_allclose(g[k].numpy(), np.asarray(jg[k]),
                                       rtol=0, atol=ATOL)


def test_lenet_regression_and_roc_evaluations_match_jax(lenet):
    x, y = lenet["test"]
    jit_ = jit.ArrayDataSetIterator(x, y, 50)
    tit_ = tit.ArrayDataSetIterator(x, y, 50)
    with compile_cache_at(lenet["cache"]):
        jr = lenet["jnet"].evaluate_regression(jit_)
        jroc_mc = lenet["jnet"].evaluate_roc_multiclass(jit_, 10)
        jroc_all = lenet["jnet"].evaluate_roc(jit_, 10)
    r = lenet["tnet"].evaluate_regression(tit_)
    roc_mc = lenet["tnet"].evaluate_roc_multiclass(tit_, 10)
    roc_all = lenet["tnet"].evaluate_roc(tit_, 10)
    for c in range(10):
        np.testing.assert_allclose(r.mean_squared_error(c),
                                   jr.mean_squared_error(c), rtol=1e-5)
        np.testing.assert_allclose(r.correlation_r2(c), jr.correlation_r2(c),
                                   rtol=1e-4)
    # thresholded counts: equal unless an output sits within float32 noise
    # of a threshold
    np.testing.assert_allclose(roc_mc.calculate_average_auc(),
                               jroc_mc.calculate_average_auc(), atol=1e-3)
    np.testing.assert_allclose(roc_all.calculate_auc(),
                               jroc_all.calculate_auc(), atol=1e-3)


def test_lenet_on_the_synthetic_digits_learns(no_real_mnist):
    """The port alone: a few dozen steps of ``fit_iterator`` from its own
    seeded init lift the test accuracy well above chance."""
    net = MultiLayerNetwork(lenet_mnist(learning_rate=0.05),
                            device="cpu").init()
    net.fit_iterator(tmnist.MnistDataSetIterator(32, num_examples=640))
    ev = net.evaluate(tmnist.MnistDataSetIterator(100, train=False,
                                                  num_examples=200))
    assert ev.num_examples == 200 and ev.accuracy() > 0.5


# ---------------------------------------------------------------- MNIST
@pytest.mark.parametrize("train", [True, False])
def test_synthetic_mnist_is_bitwise_jax(no_real_mnist, train):
    ours = tmnist.MnistDataSetIterator(128, train=train, num_examples=300)
    theirs = jmnist.MnistDataSetIterator(128, train=train, num_examples=300)
    assert ours.synthetic and theirs.synthetic
    np.testing.assert_array_equal(ours.features, theirs.features)
    np.testing.assert_array_equal(ours.labels, theirs.labels)
    for _ in range(2):  # two epochs: each its own shuffle
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.features, b.features)
            np.testing.assert_array_equal(a.labels, b.labels)


def _write_idx(path, arr, gz):
    header = struct.pack(">i", 0x0800 | arr.ndim) + b"".join(
        struct.pack(">i", d) for d in arr.shape)
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(header + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("gz", [False, True])
def test_idx_files_are_read_as_jax_reads_them(monkeypatch, tmp_path, gz):
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (7, 28, 28))
    labels = rng.integers(0, 10, 7)
    sfx = ".gz" if gz else ""
    _write_idx(tmp_path / f"t10k-images-idx3-ubyte{sfx}", images, gz)
    _write_idx(tmp_path / f"t10k-labels-idx1-ubyte{sfx}", labels, gz)
    got = tmnist.read_idx(tmp_path / f"t10k-images-idx3-ubyte{sfx}")
    np.testing.assert_array_equal(got, images)
    np.testing.assert_array_equal(
        got, jmnist._read_idx(tmp_path / f"t10k-images-idx3-ubyte{sfx}"))
    monkeypatch.setenv("MNIST_DIR", str(tmp_path))
    it = tmnist.MnistDataSetIterator(4, train=False, shuffle=False)
    assert not it.synthetic and it.features.shape == (7, 784)
    np.testing.assert_array_equal(it.labels.argmax(1), labels)
    np.testing.assert_array_equal(
        it.features, images.reshape(7, -1).astype(np.float32) / 255.0)
    flat = tmnist.MnistDataSetIterator(4, train=False, flatten=False)
    assert flat.features.shape == (7, 28, 28, 1)


# ---------------------------------------------------------------- iterators
def _data(n=23, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3)).astype(np.float32),
            rng.standard_normal((n, 2)).astype(np.float32))


def _same_batches(ours, theirs):
    got, want = list(ours), list(theirs)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.labels, b.labels)
    return got


@pytest.mark.parametrize("shuffle,drop_last", [(False, True), (True, True),
                                               (True, False)])
def test_array_iterator_order_is_jax(shuffle, drop_last):
    x, y = _data()
    ours = tit.ArrayDataSetIterator(x, y, 5, shuffle=shuffle, seed=4,
                                    drop_last=drop_last)
    theirs = jit.ArrayDataSetIterator(x, y, 5, shuffle=shuffle, seed=4,
                                      drop_last=drop_last)
    for _ in range(3):
        got = _same_batches(ours, theirs)
    assert len(got) == (4 if drop_last else 5)
    assert ours.total_examples() == 23 and ours.batch_size() == 5


def test_sampling_multiple_epochs_list_existing_iterators_are_jax():
    x, y = _data()
    ours = tit.SamplingDataSetIterator(tds.DataSet(x, y), 4, 3, seed=2)
    theirs = jit.SamplingDataSetIterator(jds.DataSet(x, y), 4, 3, seed=2)
    for _ in range(2):
        _same_batches(ours, theirs)
    assert ours.total_examples() == 12
    _same_batches(
        tit.MultipleEpochsIterator(2, tit.ArrayDataSetIterator(x, y, 6, True)),
        jit.MultipleEpochsIterator(2, jit.ArrayDataSetIterator(x, y, 6, True)))
    dss = [tds.DataSet(x[i:i + 5], y[i:i + 5]) for i in range(0, 20, 5)]
    jdss = [jds.DataSet(x[i:i + 5], y[i:i + 5]) for i in range(0, 20, 5)]
    lst = tit.ListDataSetIterator(dss)
    _same_batches(lst, jit.ListDataSetIterator(jdss))
    assert lst.batch_size() == 5 and lst.total_examples() == 20
    ex = tit.ExistingDataSetIterator(d for d in dss)
    _same_batches(ex, jit.ExistingDataSetIterator(d for d in jdss))


def test_async_iterator_keeps_order_and_stops():
    x, y = _data(40)
    base = tit.ArrayDataSetIterator(x, y, 4, shuffle=True, seed=9)
    ours = tit.AsyncDataSetIterator(base, queue_size=2)
    theirs = jit.AsyncDataSetIterator(
        jit.ArrayDataSetIterator(x, y, 4, shuffle=True, seed=9), queue_size=2)
    for _ in range(2):
        ours.reset()
        theirs.reset()
        _same_batches(ours, theirs)
    # a consumer that leaves early stops the producer
    for _ in ours:
        break
    ours.close()
    assert not ours._pf.thread.is_alive()

    def broken():
        yield tds.DataSet(x[:2], y[:2])
        raise RuntimeError("source failed")

    it = iter(tit.AsyncDataSetIterator(broken()))
    assert next(it).num_examples() == 2  # the batch before the error
    with pytest.raises(RuntimeError, match="source failed"):
        next(it)


def test_dataset_methods_are_jax():
    x, y = _data()
    m = (np.arange(23) % 3 > 0).astype(np.float32)
    ours, theirs = tds.DataSet(x, y, m, m), jds.DataSet(x, y, m, m)
    assert ours.num_examples() == 23
    for a, b in zip(ours.split_test_and_train(15),
                    theirs.split_test_and_train(15)):
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.labels_mask, b.labels_mask)
    ours.shuffle(5)
    theirs.shuffle(5)
    np.testing.assert_array_equal(ours.features, theirs.features)
    np.testing.assert_array_equal(ours.features_mask, theirs.features_mask)
    assert [d.num_examples() for d in ours.batch_by(10)] == [10, 10, 3]


# ---------------------------------------------------------------- eval
def test_evaluation_classes_match_jax():
    rng = np.random.default_rng(2)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (3, 5))]
    p = rng.random((3, 5, 4)).astype(np.float32)
    mask = (rng.random((3, 5)) > 0.3).astype(np.float32)
    ours, theirs = teval.Evaluation(top_n=2, labels=list("abcd")), \
        jeval.Evaluation(top_n=2, labels=list("abcd"))
    ours.eval(y, p, mask=mask)
    theirs.eval(y, p, mask=mask)
    ours.eval(y[0], p[0])
    theirs.eval(y[0], p[0])
    assert ours.stats() == theirs.stats()
    assert ours.top_n_accuracy() == theirs.top_n_accuracy()
    np.testing.assert_array_equal(ours.confusion.matrix,
                                  theirs.confusion.matrix)
    merged = teval.Evaluation().merge(ours)
    assert merged.accuracy() == ours.accuracy()
    r, jr = teval.RegressionEvaluation(), jreg.RegressionEvaluation()
    r.eval(y, p, mask=mask)
    jr.eval(y, p, mask=mask)
    assert r.stats() == jr.stats()
    b, jb = teval.ROC(10), jroc.ROC(10)
    b.eval(y[0][:, :2], p[0][:, :2])
    jb.eval(y[0][:, :2], p[0][:, :2])
    assert b.get_roc_curve() == jb.get_roc_curve()
    assert b.calculate_auc() == jb.calculate_auc()
    mc, jmc = teval.ROCMultiClass(10), jroc.ROCMultiClass(10)
    mc.eval(y[0], p[0])
    jmc.eval(y[0], p[0])
    assert mc.calculate_average_auc() == jmc.calculate_average_auc()
