"""The JAX package's public names, found in the port with their behaviour:
the package and subpackage re-exports, the generic config registry of
``nn/conf/serde.py`` (a custom config round-trips between the packages
through JSON and YAML), ``MultiLayerConfiguration.n_layers``,
``DecodeEngine.drain``, and every public name of the modules this slice
ports (model import, the gateway, the host runtime, DataVec)."""
import dataclasses
import importlib
import inspect
import time

import pytest

import _torch_port  # noqa: F401  (private JAX executable cache)

#: JAX module -> its port; every public name of the JAX module is checked
MODULES = {
    "deeplearning4j_tpu": "deeplearning4j_tpu_torch",
    "deeplearning4j_tpu.ops": "deeplearning4j_tpu_torch.ops",
    "deeplearning4j_tpu.parallel": "deeplearning4j_tpu_torch.parallel",
    "deeplearning4j_tpu.nn.conf.serde":
        "deeplearning4j_tpu_torch.nn.conf.serde",
    "deeplearning4j_tpu.modelimport.hdf5":
        "deeplearning4j_tpu_torch.modelimport.hdf5",
    "deeplearning4j_tpu.modelimport.keras_import":
        "deeplearning4j_tpu_torch.modelimport.keras_import",
    "deeplearning4j_tpu.nativert": "deeplearning4j_tpu_torch.nativert",
    "deeplearning4j_tpu.datavec": "deeplearning4j_tpu_torch.datavec",
    "deeplearning4j_tpu.datavec.records":
        "deeplearning4j_tpu_torch.datavec.records",
    "deeplearning4j_tpu.datavec.iterators":
        "deeplearning4j_tpu_torch.datavec.iterators",
}
#: names the JAX modules hold that are not theirs to export: imported
#: typing helpers and modules, and the libhdf5 binding's ctypes plumbing,
#: which a port that reads HDF5 without the library has no use for
NOT_API = {"annotations", "Any", "Dict", "List", "Optional", "Sequence",
           "Type", "Union", "Iterable", "Iterator", "Path", "ctypes", "json",
           "np", "jnp", "jax", "os", "re", "struct", "subprocess",
           "threading", "functools", "dataclasses", "enum", "csv", "io",
           "DataSet", "DataSetIterator", "RecordReader", "H5File",
           "NeuralNetConfiguration", "InputType", "ElementWiseVertex",
           "MergeVertex", "ActivationLayer", "BatchNormalization",
           "ConvolutionLayer", "DenseLayer", "DropoutLayer", "EmbeddingLayer",
           "LSTM", "OutputLayer", "RnnOutputLayer", "SubsamplingLayer"}
#: the libhdf5 binding: handles, constants and the loader of the library
HDF5_BINDING = {"hid_t", "herr_t", "hsize_t", "htri_t", "H5F_ACC_RDONLY",
                "H5F_ACC_TRUNC", "H5P_DEFAULT", "H5S_ALL", "H5S_SCALAR",
                "H5_INDEX_NAME", "H5_ITER_INC", "H5T_DIR_ASCEND",
                "H5T_VARIABLE", "H5T_INTEGER", "H5T_FLOAT", "H5T_STRING",
                "H5T_SGN_NONE"}


def _public(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
    # submodules become attributes once imported anywhere in the process
    return sorted(n for n in set(names) - NOT_API
                  if not inspect.ismodule(getattr(mod, n, None)))


@pytest.mark.parametrize("jax_name", sorted(MODULES))
def test_port_has_every_public_name(jax_name):
    jmod = importlib.import_module(jax_name)
    port = importlib.import_module(MODULES[jax_name])
    skip = HDF5_BINDING if jax_name.endswith("hdf5") else set()
    missing = [n for n in _public(jmod)
               if n not in skip and not hasattr(port, n)]
    assert not missing, f"{MODULES[jax_name]} lacks {missing}"


def test_package_reexports_build_a_network():
    import deeplearning4j_tpu as jpkg
    import deeplearning4j_tpu_torch as pkg

    assert pkg.__version__ == jpkg.__version__
    conf = (pkg.NeuralNetConfiguration.builder().seed(3).list()
            .layer(pkg.nn.conf.layers.DenseLayer.conf(n_in=4, n_out=3))
            .layer(pkg.nn.conf.layers.OutputLayer.conf(n_in=3, n_out=2))
            .build())
    assert isinstance(conf, pkg.MultiLayerConfiguration)
    assert conf.n_layers == 2
    net = pkg.MultiLayerNetwork(conf, device="cpu").init()
    assert net.output([[0.0] * 4]).shape == (1, 2)
    from deeplearning4j_tpu_torch.ops import (
        ACTIVATIONS, LOSSES, get_activation, get_loss)
    assert get_activation("relu") is ACTIVATIONS["relu"]
    assert "mcxent" in LOSSES and callable(get_loss("mcxent"))
    with pytest.raises(ValueError):
        get_loss("no_such_loss")
    from deeplearning4j_tpu_torch.parallel import ElasticTrainer
    from deeplearning4j_tpu_torch.parallel.elastic import ElasticTrainer as E
    assert ElasticTrainer is E


def _register(serde):
    @serde.register_config("C4Custom")
    @dataclasses.dataclass
    class C4Custom:
        width: int = 3
        rate: float = 0.5
        tags: list = dataclasses.field(default_factory=list)
        inner: object = None
        hidden: int = dataclasses.field(default=7, metadata={"serde": False})

    @serde.register_config()
    @dataclasses.dataclass
    class C4Inner:
        name: str = "x"

    return C4Custom, C4Inner


@pytest.fixture(scope="module")
def custom():
    from deeplearning4j_tpu.nn.conf import serde as jserde
    from deeplearning4j_tpu_torch.nn.conf import serde
    return (jserde, *_register(jserde)), (serde, *_register(serde))


def test_custom_config_round_trips_across_packages(custom):
    (jserde, JC, JI), (serde, C, I) = custom
    mine = C(width=5, rate=0.25, tags=["a", 1], inner=I("deep"))
    theirs = JC(width=5, rate=0.25, tags=["a", 1], inner=JI("deep"))
    assert serde.to_json(mine) == jserde.to_json(theirs)
    assert serde.to_yaml(mine) == jserde.to_yaml(theirs)
    assert serde.TYPE_KEY == jserde.TYPE_KEY == "@type"
    assert serde.registered_name(I) == "C4Inner"
    assert serde.lookup("C4Custom") is C
    back = serde.from_yaml(jserde.to_yaml(theirs))
    assert back == mine and back.hidden == 7
    assert jserde.from_json(serde.to_json(mine)) == theirs
    assert serde.from_dict(serde.to_dict([mine, {"k": mine}])) == \
        [mine, {"k": mine}]
    with pytest.raises(KeyError, match="Unknown config type"):
        serde.lookup("NoSuchConfig")
    with pytest.raises(ValueError, match="already registered"):
        serde.register_config("C4Custom")(I)
    with pytest.raises(TypeError):
        serde.to_dict(object())


def test_serde_reads_and_writes_the_network_configurations():
    """The generic functions carry the port's configurations in the JAX
    schema: the JAX ``serde.to_json`` of a configuration reads back here
    as that configuration."""
    from deeplearning4j_tpu.models import lenet_mnist as jlenet
    from deeplearning4j_tpu.nn.conf import serde as jserde
    from deeplearning4j_tpu_torch.models import lenet_mnist, resnet18
    from deeplearning4j_tpu_torch.nn.conf import serde

    conf = lenet_mnist()
    assert serde.to_json(conf) == conf.to_json()
    back = serde.from_json(jserde.to_json(jlenet()))
    assert back.to_json() == conf.to_json()
    graph = resnet18(n_classes=10, image_size=32)
    assert serde.from_yaml(serde.to_yaml(graph)).to_json() == graph.to_json()


def test_decode_engine_drain():
    from deeplearning4j_tpu_torch.keras_server.decode import DecodeEngine
    from deeplearning4j_tpu_torch.models import transformer_lm
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    net = MultiLayerNetwork(transformer_lm(16, width=8, n_layers=1,
                                           n_heads=2, max_len=32),
                            device="cpu").init()
    eng = DecodeEngine(net, device="cpu", max_context=32)
    try:
        eng.drain(timeout_s=1.0)  # nothing queued: returns at once
        sessions = [eng.submit([1, 2, 3], 6) for _ in range(3)]
        t0 = time.monotonic()
        eng.drain(timeout_s=60.0)
        assert time.monotonic() - t0 < 60.0
        assert eng.idle() and all(s.done for s in sessions)
        eng.submit([1, 2], 30)
        with pytest.raises(TimeoutError, match="drain"):
            eng.drain(timeout_s=0.0)
    finally:
        eng.close()
