"""The port's host runtime (``nativert/``: its own copy of
``dl4j_runtime.cpp``, built at first use) held bitwise against its plain
Python routes and against the JAX package's ``nativert`` on the same
inputs: IDX and CIFAR parsing, the async loader, the strict and lenient
CSV reader, the DLTS stats codec, the ingest decoder and the token counter;
a failed build raises; and the consumers (MNIST's IDX reader, the broker's
native decode) read through it."""
import gzip
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from deeplearning4j_tpu import nativert as jnrt
from deeplearning4j_tpu.ui.stats import StatsReport
from deeplearning4j_tpu_torch import nativert

REPO = Path(__file__).resolve().parents[1]


def _write_idx(path, arr):
    arr = np.asarray(arr, np.uint8)
    with open(path, "wb") as f:
        f.write(struct.pack(">i", 0x0800 | arr.ndim))
        for d in arr.shape:
            f.write(struct.pack(">i", d))
        f.write(arr.tobytes())


def _same(a, b):
    """Bitwise equal arrays (NaNs included)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
    assert a.tobytes() == b.tobytes()


def test_build_names_its_compiler():
    lib = nativert.get_runtime()
    assert nativert.native_available()
    assert lib.dl4j_runtime_version() == nativert.RUNTIME_VERSION
    info = nativert.build_info
    assert os.path.basename(info["compiler"]) in ("g++", "c++", "clang++") \
        or info["compiler"] == os.environ.get("CXX")
    assert info["seconds"] >= 0 and Path(info["library"]).exists()


def test_failed_build_raises_with_compiler_output(tmp_path):
    """CXX=/bin/false in a fresh build directory: the first use raises,
    naming the command; nothing falls back to Python."""
    code = ("import sys; from pathlib import Path; "
            "from deeplearning4j_tpu_torch import nativert; "
            f"nativert.BUILD_DIR = Path({str(tmp_path)!r}); "
            "\ntry:\n    nativert.read_idx('x')\n"
            "except RuntimeError as e:\n    print('RAISED', e); sys.exit(0)\n"
            "sys.exit(1)")
    env = dict(os.environ, CXX="/bin/false", PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "RAISED building the host runtime failed: /bin/false" in r.stdout
    assert not list(tmp_path.glob("*.so"))


def test_idx_native_python_and_jax(tmp_path):
    arr = np.random.default_rng(0).integers(0, 256, (7, 5, 4)).astype(np.uint8)
    p = str(tmp_path / "t.idx")
    _write_idx(p, arr)
    for got in (nativert.read_idx(p), nativert.read_idx_py(p),
                jnrt.read_idx(p)):
        _same(got, arr)
    bad = tmp_path / "bad.idx"
    bad.write_bytes(b"\x00\x01\x02")
    assert jnrt.read_idx(str(bad)) is None
    for fn in (nativert.read_idx, nativert.read_idx_py):
        with pytest.raises(ValueError, match="IDX"):
            fn(str(bad))
    short = tmp_path / "short.idx"
    short.write_bytes(struct.pack(">iii", 0x0802, 4, 4) + bytes(15))
    for fn in (nativert.read_idx, nativert.read_idx_py):
        with pytest.raises(ValueError):
            fn(str(short))


def test_mnist_read_idx_matches_the_runtime_plain_and_gz(tmp_path):
    """``datasets.mnist`` parses plain and ``.gz`` IDX files with numpy,
    bitwise what the host runtime's ``read_idx`` gives."""
    from deeplearning4j_tpu_torch.datasets import mnist

    arr = np.random.default_rng(1).integers(0, 256, (3, 28, 28)).astype(
        np.uint8)
    plain, gz = tmp_path / "img-idx3-ubyte", tmp_path / "img-idx3-ubyte.gz"
    _write_idx(plain, arr)
    gz.write_bytes(gzip.compress(plain.read_bytes()))
    _same(mnist.read_idx(plain), arr)
    _same(mnist.read_idx(gz), arr)
    _same(mnist.read_idx(plain), nativert.read_idx(str(plain)))


def _loader_epoch(ld):
    return [(x.copy(), y.copy()) for x, y in ld]


@pytest.mark.parametrize("normalize", [True, False])
def test_loader_ordered_batches_match_python_and_jax(normalize):
    n, feat, ncls, batch = 14, 6, 3, 4
    rng = np.random.default_rng(2)
    feats = rng.integers(0, 256, (n, feat)).astype(np.uint8)
    labels = (np.arange(n) % ncls).astype(np.uint8)
    ld = nativert.AsyncNativeLoader.from_arrays(
        feats, labels, ncls, batch, shuffle=False, normalize=normalize)
    jld = jnrt.AsyncNativeLoader.from_arrays(
        feats, labels, ncls, batch, shuffle=False, normalize=normalize)
    got = _loader_epoch(ld)
    py = list(nativert.loader_batches_py(feats, labels, ncls, batch,
                                         shuffle=False, normalize=normalize))
    assert len(got) == len(py) == len(ld) == n // batch
    for (x, y), (px, py_), (jx, jy) in zip(got, py, _loader_epoch(jld)):
        _same(x, px), _same(y, py_), _same(x, jx), _same(y, jy)
    assert ld.next() is None  # the epoch is spent; reset restarts it
    ld.reset()
    assert len(_loader_epoch(ld)) == 3
    ld.close()
    jld.close()


def test_loader_shuffle_is_the_python_permutation():
    """The port's loader shuffles with its own Fisher-Yates over
    splitmix64: the Python route's batches bitwise, epoch after epoch
    (``reset`` moves to seed + epoch); each epoch holds every example once,
    as the JAX loader's does (whose order is std::shuffle's)."""
    n, feat, batch, seed = 64, 2, 8, 7
    feats = np.repeat(np.arange(n, dtype=np.uint8)[:, None], feat, axis=1)
    labels = (np.arange(n) % 10).astype(np.uint8)
    ld = nativert.AsyncNativeLoader.from_arrays(
        feats, labels, 10, batch, shuffle=True, seed=seed, normalize=False)
    jld = jnrt.AsyncNativeLoader.from_arrays(
        feats, labels, 10, batch, shuffle=True, seed=seed, normalize=False)
    for epoch in range(2):
        got = _loader_epoch(ld)
        py = list(nativert.loader_batches_py(feats, labels, 10, batch,
                                             seed=seed, normalize=False,
                                             epoch=epoch))
        for (x, y), (px, py_) in zip(got, py):
            _same(x, px), _same(y, py_)
        seen = sorted(int(r[0]) for x, _ in got for r in x)
        jseen = sorted(int(r[0]) for x, _ in _loader_epoch(jld) for r in x)
        assert seen == jseen == list(range(n))
        ld.reset()
        jld.reset()
    perm = nativert.shuffle_order_py(1000, 3)
    assert sorted(perm.tolist()) == list(range(1000))
    assert perm.tolist() != list(range(1000))
    ld.close()
    jld.close()


def test_mnist_and_cifar_loaders_match_python_and_jax(tmp_path):
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (20, 28, 28)).astype(np.uint8)
    lbls = rng.integers(0, 10, 20).astype(np.uint8)
    _write_idx(tmp_path / "img.idx", imgs)
    _write_idx(tmp_path / "lbl.idx", lbls)
    args = (str(tmp_path / "img.idx"), str(tmp_path / "lbl.idx"))
    ld = nativert.AsyncNativeLoader.mnist(*args, batch=5, seed=4)
    assert ld.num_examples == 20 and ld.feature_size == 784
    py = nativert.loader_batches_py(
        nativert.read_idx_py(args[0]), nativert.read_idx_py(args[1]), 10, 5,
        seed=4)
    for (x, y), (px, py_) in zip(_loader_epoch(ld), py):
        _same(x, px), _same(y, py_)
    ld.close()
    jld = jnrt.AsyncNativeLoader.mnist(*args, batch=5, shuffle=False)
    ld = nativert.AsyncNativeLoader.mnist(*args, batch=5, shuffle=False)
    for (x, y), (jx, jy) in zip(_loader_epoch(ld), _loader_epoch(jld)):
        _same(x, jx), _same(y, jy)
    ld.close()
    jld.close()
    # CIFAR-10 binary: [label u8][3072 pixels u8] a record, two files
    paths = []
    for i in range(2):
        recs = np.concatenate([rng.integers(0, 10, (5, 1)),
                               rng.integers(0, 256, (5, 3072))],
                              axis=1).astype(np.uint8)
        paths.append(str(tmp_path / f"data_batch_{i}.bin"))
        recs.tofile(paths[-1])
    feats, labs = nativert.read_cifar_py(paths)
    ld = nativert.AsyncNativeLoader.cifar(paths, batch=3, seed=9)
    assert ld.num_examples == 10 and ld.feature_size == 3072
    for (x, y), (px, py_) in zip(
            _loader_epoch(ld),
            nativert.loader_batches_py(feats, labs, 10, 3, seed=9)):
        _same(x, px), _same(y, py_)
    jld = jnrt.AsyncNativeLoader.cifar(paths, batch=3, shuffle=False)
    ld2 = nativert.AsyncNativeLoader.cifar(paths, batch=3, shuffle=False)
    for (x, y), (jx, jy) in zip(_loader_epoch(ld2), _loader_epoch(jld)):
        _same(x, jx), _same(y, jy)
    for loader in (ld, ld2, jld):
        loader.close()


def test_loader_use_after_close_raises():
    ld = nativert.AsyncNativeLoader.from_arrays(
        np.zeros((4, 2), np.uint8), np.zeros(4, np.uint8), 2, 2,
        shuffle=False)
    ld.close()
    with pytest.raises(ValueError, match="closed"):
        ld.next()
    with pytest.raises(ValueError, match="closed"):
        ld.reset()
    with pytest.raises(ValueError, match="creation failed"):
        nativert.AsyncNativeLoader.from_arrays(
            np.zeros((4, 2), np.uint8), np.zeros(4, np.uint8), 2, 8)


#: fields the strict parse takes, and ones it refuses
CSV_CASES = {
    "numeric": "1.5,2,3\n4,5e-1,6\n\n-0.0, 7 ,1e38\r\n.5,+3,0x1p3\n",
    "header": "# header\n1.5,2,3\n4,5.25,6\n7,8,9\n",
    "iris": "".join(f"{0.1 * i:.1f},{3.3 + i % 7 * 0.1:.1f},1.4,0.2,{i % 3}\n"
                    for i in range(50)),
    "na": "1,2,3\n4,NA,6\n",
    "empty_field": "1,2\n3,\n",
    "trailing_delim": "1,2,\n4,5,6\n",
    "whitespace_field": "1, \n2,3\n",
    "ragged": "1,2,3\n4,5\n6,7,8,9\n",
    "prefix": "5abc,1\ninf,nan\n",
}


@pytest.mark.parametrize("case", sorted(CSV_CASES))
@pytest.mark.parametrize("strict", [True, False])
def test_csv_native_python_and_jax(tmp_path, case, strict):
    p = str(tmp_path / f"{case}.csv")
    with open(p, "w", newline="") as f:
        f.write(CSV_CASES[case])
    skip = 1 if case == "header" else 0
    got = nativert.read_csv_numeric(p, skip_lines=skip, strict=strict)
    py = nativert.read_csv_numeric_py(p, skip_lines=skip, strict=strict)
    want = jnrt.read_csv_numeric(p, skip_lines=skip, strict=strict)
    if want is None:
        assert got is None and py is None
    else:
        _same(got, want)
        _same(py, want)
    if case == "numeric":
        np.testing.assert_array_equal(
            got, np.float32([[1.5, 2, 3], [4, 0.5, 6], [-0.0, 7, 1e38],
                             [0.5, 3, 8]]))


def test_stats_codec_matches_python_and_jax(monkeypatch):
    sections = [{"layer0_W": (0.5, [1, 2, 3, 4], (-1.0, 1.0)),
                 "layer1_W": (0.25, [], (0.0, 0.0))},
                {"layer0_W": (0.01, [4, 3, 2, 1], (-0.1, 0.1))},
                {"layer0_b": (0.001, [7], (0.0, 0.002))}]
    args = ("sess-1", "worker-0", 1234567890123, 42, 0.125, 3.5, 1000.25,
            1 << 30, 2 << 30, sections)
    native = nativert.encode_stats_native(*args)
    assert native == nativert.encode_stats_py(*args)
    r = StatsReport("sess-1", "worker-0", 1234567890123)
    r.iteration, r.score = 42, 0.125
    r.iteration_time_ms, r.samples_per_sec = 3.5, 1000.25
    r.mem_rss_bytes, r.device_mem_bytes = 1 << 30, 2 << 30
    r.param_stats, r.gradient_stats, r.update_stats = (dict(s)
                                                       for s in sections)
    assert native == r.encode()
    monkeypatch.setenv("DL4J_TPU_DISABLE_NATIVE", "1")
    assert native == r.encode()  # the JAX Python encoder
    d = StatsReport.decode(native)
    assert d.param_stats["layer0_W"] == (0.5, [1, 2, 3, 4], (-1.0, 1.0))


@pytest.mark.parametrize("codec", ["f32", "bf16", "u8"])
def test_decode_records_native_python_and_jax(codec):
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 256, 4 * 257).astype(np.uint8).tobytes()
    got = nativert.decode_records(raw, codec)
    _same(got, nativert.decode_records_py(raw, codec))
    _same(got, jnrt.decode_records(raw, codec))
    if codec != "u8":
        for fn in (nativert.decode_records, nativert.decode_records_py):
            with pytest.raises(ValueError, match="ragged"):
                fn(raw[:-1], codec)
    dec = nativert.IngestDecoder(capacity=3)
    recs = [raw[i * 8:i * 8 + 8 * (i + 1)] for i in range(6)]
    outs = []
    for i, rec in enumerate(recs):
        dec.submit(rec, codec)
        if i >= 2:
            outs.append(dec.next())
    while (o := dec.next()) is not None:
        outs.append(o)
    for rec, out in zip(recs, outs):
        _same(out, nativert.decode_records_py(rec, codec))
    dec.close()
    with pytest.raises(ValueError, match="closed"):
        dec.submit(raw, codec)


@pytest.mark.parametrize("common", [False, True])
def test_token_counts_native_python_and_jax(tmp_path, common):
    p = tmp_path / "corpus.txt"
    p.write_bytes(b"The quick brown fox, jumps over the lazy dog!\n"
                  b"the quick RED fox; and the dog sleeps. 42 a\x1cb\n" * 50)
    got = nativert.count_tokens_file(str(p), common_preprocess=common,
                                     nthreads=3)
    assert got == nativert.count_tokens_py(str(p), common)
    assert got == jnrt.count_tokens_file(str(p), common_preprocess=common,
                                         nthreads=3)
    counts = [c for _, c in got]
    assert counts == sorted(counts, reverse=True)
    bad = tmp_path / "latin.txt"
    bad.write_bytes("caf\xc3\xa9 au lait".encode("latin-1"))
    assert nativert.count_tokens_file(str(bad)) is None
    assert nativert.count_tokens_py(str(bad)) is None
    with pytest.raises(OSError):
        nativert.count_tokens_file(str(tmp_path / "missing.txt"))


def test_broker_native_decode_is_the_wire_decode():
    """A consumer made with ``native_decode=True`` (the JAX signature)
    gives bitwise what ``wire.unpack_arrays`` gives, and the runtime's
    ``decode_records`` gives the same float32 arrays (raw and bf16 coded)
    from the frame's bytes."""
    from deeplearning4j_tpu_torch.streaming import wire
    from deeplearning4j_tpu_torch.streaming.broker import (
        BrokerProducer, LoopbackBroker, ReconnectingConsumer)

    rng = np.random.default_rng(6)
    arrays = {"x": rng.normal(size=(4, 5)).astype(np.float32),
              "ids": np.arange(6, dtype=np.int64).reshape(2, 3),
              "f64": rng.normal(size=3)}
    broker = LoopbackBroker().start()
    try:
        prod = BrokerProducer(broker.address)
        for codec in ("none", "bf16"):
            prod.publish("t", arrays, codec=codec)
        prod.close()
        native = ReconnectingConsumer(broker.address, "t", group="n",
                                      native_decode=True)
        plain = ReconnectingConsumer(broker.address, "t", group="p")
        for codec in ("none", "bf16"):
            meta, got = native.get(timeout=5.0)
            _, want = plain.get(timeout=5.0)
            for k in arrays:
                _same(got[k], want[k])
            metas, payload = wire.pack_arrays(arrays, codec)
            ref = wire.unpack_arrays(metas, b"".join(bytes(v)
                                                     for v in payload))
            _same(got["x"], ref["x"])
            _same(nativert.decode_records(bytes(payload[0]),
                                          "f32" if codec == "none" else
                                          "bf16").reshape(4, 5), ref["x"])
            native.task_done()
            plain.task_done()
        native.close()
        plain.close()
    finally:
        broker.stop()
