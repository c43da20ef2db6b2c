"""The port's partition-rule engine held against the JAX one
(``deeplearning4j_tpu/parallel/partition.py``, the JAX
``test_partition_engine.py``).

The resolved specs of the ``dp``, ``dp_tp`` and ``zero3`` rule sets equal
JAX's leaf for leaf, on the same model's params and updater state (weights
crossed by ``convert.from_jax``) and the same mesh shape: a JAX
``PartitionSpec`` and the port's compare as tuples of axis names. The rule
engine reads only a mesh's axis sizes, so the port runs here against a
stand-in with the shape; the JAX one runs on the conftest's 8 CPU devices.
The edge cases are the JAX suite's: paths, top names, first match, scalar
and tiny leaves, the hard error, rank polymorphism, demotion, the
Megatron rules, byte accounting.
"""
import types

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

from _torch_port import compile_cache_at
from deeplearning4j_tpu.parallel import partition as jpart
from deeplearning4j_tpu_torch.convert import from_jax
from deeplearning4j_tpu_torch.parallel import partition
from deeplearning4j_tpu_torch.parallel.partition import (
    Col, FirstDivisible, PartitionRuleError, PartitionSpec as P, Row,
    dp_tp_rules, match_partition_rules, model_top_names, named_tree_map,
    per_device_bytes, rules_for, zero3_rules)

MESHES = ({"data": 8}, {"data": 4}, {"data": 4, "model": 2},
          {"data": 2, "sp": 4})


def _stand_in(shape):
    """The port's view of a mesh of ``shape`` (the rule engine reads only
    the axis sizes)."""
    return types.SimpleNamespace(shape=dict(shape))


def _jax_mesh(shape):
    n = int(np.prod(list(shape.values())))
    return JMesh(np.array(jax.devices()[:n]).reshape(list(shape.values())),
                 tuple(shape))


def _models():
    """``(name, JAX network, port network)`` pairs: a dense stack, the
    transformer LM, the MoE LM (3-D expert leaves) and ResNet-18 (a
    graph), all under Adam or Nesterov updater state."""
    from deeplearning4j_tpu.models import (
        moe_transformer_lm, resnet18, transformer_lm)
    from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu.nn.graph_network import ComputationGraph
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork

    dense = (NeuralNetConfiguration.builder().seed(1).updater("adam").list()
             .layer(DenseLayer(n_in=6, n_out=16, activation="tanh"))
             .layer(OutputLayer(n_in=16, n_out=3, loss="mcxent",
                                activation="softmax")).build())
    confs = (("dense", dense, MultiLayerNetwork),
             ("lm", transformer_lm(16, width=32, n_layers=1, n_heads=4,
                                   max_len=8), MultiLayerNetwork),
             ("moe", moe_transformer_lm(16, width=32, n_layers=1, n_heads=4,
                                        n_experts=4, max_len=8),
              MultiLayerNetwork),
             ("resnet18", resnet18(n_classes=10, image_size=32),
              ComputationGraph))
    out = []
    for name, conf, cls in confs:
        jnet = cls(conf).init()
        params = jax.tree_util.tree_map(np.asarray, jnet.params_list)
        tnet = from_jax(conf.to_json(), params, device="cpu")
        out.append((name, jnet, tnet))
    return out


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    with compile_cache_at(tmp_path_factory.mktemp("xcache")):
        return _models()


def _same_specs(jspecs, tspecs):
    """Leaf for leaf, by path."""
    is_spec = lambda s: isinstance(s, jax.sharding.PartitionSpec)  # noqa
    want = {jpart._path_str(kp, "/"): tuple(s) for kp, s in
            jax.tree_util.tree_flatten_with_path(jspecs, is_leaf=is_spec)[0]}
    got = {}
    named_tree_map(lambda path, s: got.setdefault(path, tuple(s)), tspecs)
    assert got == want and got
    return list(got.values())


@pytest.mark.parametrize("rule_set", ["dp", "dp_tp", "zero3"])
@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_rule_sets_resolve_as_jax(models, rule_set, shape):
    split = 0
    for name, jnet, tnet in models:
        for jtree, ttree in ((jnet.params_list, tnet.params_list),
                             (jnet.updater_state, tnet.updater_state)):
            jspecs = jpart.match_partition_rules(
                jpart.rules_for(rule_set), jtree, mesh=_jax_mesh(shape),
                conf=jnet.conf)
            tspecs = match_partition_rules(
                rules_for(rule_set), ttree, mesh=_stand_in(shape),
                conf=tnet.conf)
            split += sum(s != () for s in _same_specs(jspecs, tspecs))
    # a rule set that names a mesh axis splits something on that mesh
    if rule_set == "zero3" or (rule_set == "dp_tp" and "model" in shape):
        assert split > 0
    if rule_set == "dp":
        assert split == 0


def test_model_top_names_match_jax(models):
    for _, jnet, tnet in models:
        assert (model_top_names(tnet.params_list, tnet.conf)
                == jpart.model_top_names(jnet.params_list, jnet.conf))


def test_per_device_bytes_zero3_is_a_share_of_dp(models):
    shape = {"data": 4}
    for name, jnet, tnet in models:
        specs = match_partition_rules(zero3_rules(), tnet.params_list,
                                      mesh=_stand_in(shape), conf=tnet.conf)
        whole = per_device_bytes(tnet.params_list, P(), _stand_in(shape))
        assert whole == partition.tree_nbytes(tnet.params_list)
        got = per_device_bytes(tnet.params_list, specs, _stand_in(shape))
        jspecs = jpart.match_partition_rules(
            jpart.zero3_rules(), jnet.params_list, mesh=_jax_mesh(shape),
            conf=jnet.conf)
        assert got == jpart.per_device_bytes(jnet.params_list, jspecs,
                                             _jax_mesh(shape))
        # about 1/4: only tiny and indivisible leaves stay whole
        assert whole / 4 <= got <= whole / 4 * 1.1, name


# --------------------------------------------------------------- tree walk
def test_named_tree_map_joins_paths():
    tree = {"a": {"W": np.zeros((2, 2))}, "b": [np.zeros(3), np.zeros(2)]}
    seen = {}
    named_tree_map(lambda p, leaf: seen.setdefault(p, leaf.shape), tree)
    assert sorted(seen) == ["a/W", "b/0", "b/1"]


def test_named_tree_map_top_names_rewrite():
    tree = [{"W": np.zeros((2, 2))}, {"W": np.zeros((2, 2))}]
    paths = []
    named_tree_map(lambda p, _l: paths.append(p), tree,
                   top_names={"0": "0.DenseLayer", "1": "1.OutputLayer"})
    assert sorted(paths) == ["0.DenseLayer/W", "1.OutputLayer/W"]


def test_model_top_names_from_list_conf():
    from deeplearning4j_tpu_torch.nn.conf.builders import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        DenseLayer, OutputLayer)
    conf = (NeuralNetConfiguration.builder().list()
            .layer(DenseLayer.conf(n_in=4, n_out=8))
            .layer(OutputLayer.conf(n_in=8, n_out=2)).build())
    assert model_top_names([{}, {}], conf) == {"0": "0.DenseLayer",
                                               "1": "1.OutputLayer"}


# ------------------------------------------------------------ rule matching
def test_rule_precedence_first_match_wins():
    mesh = _stand_in({"data": 8})
    tree = {"layer": {"W": np.zeros((8, 4)), "V": np.zeros((8, 4))}}
    rules = [(r"/W(/|$)", FirstDivisible("data")), (r".*", P())]
    specs = match_partition_rules(rules, tree, mesh=mesh)
    assert specs["layer"]["W"] == P("data")
    assert specs["layer"]["V"] == P()
    flipped = match_partition_rules(list(reversed(rules)), tree, mesh=mesh)
    assert flipped["layer"]["W"] == P()


def test_scalar_and_tiny_leaves_fall_through():
    mesh = _stand_in({"data": 8})
    tree = {"l": {"s": np.float32(3.0), "one": np.zeros((1,)),
                  "tiny": np.zeros((3,)), "big": np.zeros((8,))}}
    specs = match_partition_rules([(r".*", FirstDivisible("data"))], tree,
                                  mesh=mesh)
    assert specs["l"]["s"] == P()
    assert specs["l"]["one"] == P()
    assert specs["l"]["tiny"] == P()
    assert specs["l"]["big"] == P("data")


def test_unmatched_nonscalar_leaf_is_a_hard_error():
    with pytest.raises(PartitionRuleError, match="no partition rule"):
        match_partition_rules([(r"/W(/|$)", P())],
                              {"layer": {"Q": np.zeros((8, 8))}})
    specs = match_partition_rules([], {"layer": {"s": np.float32(0)}})
    assert specs["layer"]["s"] == P()


def test_rule_values_are_rank_polymorphic():
    mesh = _stand_in({"data": 4, "model": 2})
    tree = {"l": {"dense": np.zeros((8, 16)),
                  "conv": np.zeros((3, 3, 8, 16)),
                  "experts": np.zeros((4, 8, 6)),
                  "bias": np.zeros((16,))}}
    col = match_partition_rules([(r".*", Col("model"))], tree, mesh=mesh)
    assert col["l"]["dense"] == P(None, "model")
    assert col["l"]["conv"] == P(None, None, None, "model")
    assert col["l"]["experts"] == P(None, None, "model")
    assert col["l"]["bias"] == P("model")
    row = match_partition_rules([(r".*", Row("model"))], tree, mesh=mesh)
    assert row["l"]["dense"] == P("model", None)
    assert row["l"]["conv"] == P(None, None, "model", None)
    assert row["l"]["bias"] == P()
    z = match_partition_rules([(r".*", FirstDivisible("data"))], tree,
                              mesh=mesh)
    assert z["l"]["dense"] == P("data")
    assert z["l"]["experts"] == P("data")
    assert z["l"]["conv"] == P(None, None, "data")


def test_indivisible_dims_demote_to_replicated():
    mesh = _stand_in({"data": 4, "model": 2})
    tree = {"l": {"odd": np.zeros((8, 15)), "skinny": np.zeros((5, 3))}}
    specs = match_partition_rules([(r".*", Col("model"))], tree, mesh=mesh)
    assert specs["l"]["odd"] == P()
    assert specs["l"]["skinny"] == P()
    specs = match_partition_rules([(r".*", P("data"))], tree, mesh=mesh)
    assert specs["l"]["odd"] == P("data")
    assert specs["l"]["skinny"] == P()


def test_dp_tp_rules_megatron_semantics():
    mesh = _stand_in({"data": 4, "model": 2})
    blk = {"Wqkv": np.zeros((32, 96)), "Wo": np.zeros((32, 32)),
           "W1": np.zeros((32, 64)), "W2": np.zeros((64, 32)),
           "b1": np.zeros((64,)), "b2": np.zeros((32,)),
           "Wg": np.zeros((32, 8)), "g1": np.zeros((32,))}
    tree = {"blk": blk, "opt": {"Wqkv": {"m": np.zeros((32, 96))}}}
    specs = match_partition_rules(dp_tp_rules(), tree, mesh=mesh)
    assert specs["blk"]["Wqkv"] == P(None, "model")
    assert specs["blk"]["Wo"] == P("model", None)
    assert specs["blk"]["W1"] == P(None, "model")
    assert specs["blk"]["W2"] == P("model", None)
    assert specs["blk"]["b1"] == P("model")
    assert specs["blk"]["b2"] == P()
    assert specs["blk"]["Wg"] == P()
    assert specs["blk"]["g1"] == P()
    assert specs["opt"]["Wqkv"]["m"] == P(None, "model")


def test_rules_for_unknown_name():
    with pytest.raises(ValueError, match="unknown rule set"):
        rules_for("fsdp2")


# ---------------------------------------------------- byte accounting
def test_per_device_bytes_and_counter_zero3():
    mesh = _stand_in({"data": 8})
    tree = {"l": {"W": np.zeros((16, 4), np.float32),
                  "b": np.zeros((3,), np.float32)}}
    specs = match_partition_rules(zero3_rules(), tree, mesh=mesh)
    assert per_device_bytes(tree, specs, mesh) == 32 + 12
    assert per_device_bytes(tree, P(), mesh) == partition.tree_nbytes(tree)
    assert partition.record_param_bytes("ut_zero3", tree, specs, mesh) == 44
    assert partition.stats()["sharded_param_bytes_per_device"][
        "ut_zero3"] == 44


def test_spec_counter_records_resolved_specs():
    def counts():
        return {k[1]: v for k, v in partition.stats()[
            "sharding_spec_total"].items() if k[0] == "ut_counter"}
    before = counts()
    partition.record_specs("ut_counter", [P("data"), P()],
                           {"x": P(None, "model")})
    after = counts()
    for label in ("P(data)", "P()", "P(None,model)"):
        assert after.get(label, 0) - before.get(label, 0) == 1


# ---------------------------------------------------- placement and seam
def test_device_put_keeps_this_ranks_block():
    import torch

    mesh = types.SimpleNamespace(
        shape={"data": 4}, axis_size=lambda *a: 4, index=lambda *a: 2)
    w = torch.arange(32.0).reshape(8, 4)
    b = torch.arange(3.0)
    placed = partition.device_put({"W": w, "b": b}, mesh,
                                  {"W": P("data"), "b": P()})
    assert torch.equal(placed["W"], w[4:6])
    assert placed["b"] is b
    placed = partition.device_put({"W": w}, mesh, {"W": P(None, "data")})
    assert torch.equal(placed["W"], w[:, 2:3])
    # a spec that splits two dims: this rank's block along each, in the
    # mesh's row-major order (rank (1, 0) of {"data": 2, "model": 2})
    mesh2 = types.SimpleNamespace(
        shape={"data": 2, "model": 2},
        axis_size=lambda *a: int(np.prod([{"data": 2, "model": 2}[x]
                                          for x in a])),
        index=lambda *a: {("data",): 1, ("model",): 0}[a])
    placed = partition.device_put({"W": w}, mesh2, {"W": P("data", "model")})
    assert torch.equal(placed["W"], w[4:8, 0:2])


def test_batch_spec_splits_only_divisible_batches():
    mesh = _stand_in({"data": 4})
    assert partition.batch_spec(mesh, 8) == P("data")
    assert partition.batch_spec(mesh, 10) == P()
    assert partition.batch_spec(_stand_in({"data": 1}), 8) == P()


def test_compile_step_rejects_unknown_strategy():
    from deeplearning4j_tpu_torch.parallel.compile_seam import compile_step
    with pytest.raises(ValueError, match="unknown compile strategy"):
        compile_step("ut.bad", None, mesh=None, rule_set="dp",
                     strategy="pmap")


def test_hybrid_mesh_single_slice_and_validation():
    from deeplearning4j_tpu_torch.parallel.mesh import build_hybrid_mesh
    mesh = build_hybrid_mesh({"data": 1, "model": 1}, {"data": 1})
    assert mesh.axis_names == ("data", "model")
    assert mesh.group("data") is None  # a group of one, no process group
    with pytest.raises(ValueError, match="not present"):
        build_hybrid_mesh({"data": 1}, {"expert": 2})
    with pytest.raises(ValueError, match="Mesh needs 4 ranks"):
        build_hybrid_mesh({"data": 2}, {"data": 2})


# ------------------------------------------------ specs that split two dims
TWO_DIM_CASES = (
    ({"data": 2, "model": 4}, P("data", "model")),
    ({"data": 4, "model": 2}, P("model", "data")),
    ({"data": 2, "model": 2, "sp": 2}, P(("data", "sp"), "model")),
    ({"data": 2, "model": 2, "sp": 2}, P(None, "model", "data")),
)


@pytest.mark.parametrize("shape,spec", TWO_DIM_CASES,
                         ids=[f"{s}-{p}" for s, p in TWO_DIM_CASES])
def test_two_dim_spec_places_as_jax(shape, spec):
    """A spec that splits two dims places each device's block bitwise as
    JAX's ``NamedSharding`` does on the 8 CPU devices, on a device mesh of
    repeated CPU slots and on each rank of a process-group mesh; the
    per-device bytes and the shard factor equal JAX's, and every slot's
    ``whole`` reassembles the leaf."""
    import torch
    from jax.sharding import NamedSharding, PartitionSpec as JP
    from deeplearning4j_tpu_torch.parallel.mesh import build_mesh

    rng = np.random.default_rng(7)
    leaf = rng.normal(size=(8, 8, 4)).astype(np.float32)
    jmesh = _jax_mesh(shape)
    jspec = JP(*spec)
    placed = jax.device_put(leaf, NamedSharding(jmesh, jspec))
    jblocks = {d: np.asarray(s.data) for s in placed.addressable_shards
               for d in [s.device]}
    order = list(jmesh.devices.reshape(-1))  # row-major slots

    dmesh = build_mesh(shape, devices=["cpu"] * len(order))
    mleaf = partition.device_put({"W": torch.from_numpy(leaf)}, dmesh,
                                 {"W": spec})["W"]
    for slot, dev in enumerate(order):
        np.testing.assert_array_equal(mleaf.shards[slot].numpy(),
                                      jblocks[dev])
        np.testing.assert_array_equal(mleaf.whole(slot).numpy(), leaf)
        # the rank of a process-group mesh at the same coordinates
        coords = dmesh.coords(slot)
        rank = types.SimpleNamespace(
            shape=dict(shape),
            axis_size=lambda *a: int(np.prod([shape[x] for x in a])),
            index=lambda *a, c=coords: int(np.ravel_multi_index(
                [c[x] for x in a], [shape[x] for x in a])))
        got = partition.local_shard(torch.from_numpy(leaf), spec, rank)
        np.testing.assert_array_equal(got.numpy(), jblocks[dev])
    tree = {"W": leaf, "b": np.zeros(16, np.float32)}
    specs = {"W": spec, "b": P()}
    jspecs = {"W": jspec, "b": JP()}
    assert per_device_bytes(
        {"W": torch.from_numpy(leaf), "b": torch.zeros(16)}, specs,
        _stand_in(shape)) == jpart.per_device_bytes(tree, jspecs, jmesh)
    assert partition.shard_factor(_stand_in(shape), spec) == \
        jpart.shard_factor(jmesh, jspec)
    assert partition.slot_bytes({"W": mleaf}, 0) == \
        jblocks[order[0]].nbytes


def test_one_dim_placements_name_a_two_dim_spec():
    """The one placement that holds a leaf split on one dim, ``dp_tp``
    (whose JAX counterpart takes only its rule set's specs), refuses a
    two-dim spec by name; the ZeRO placement and the restore onto a
    sharding take it, a split for each dim (C6; held on four ranks by
    ``test_torch_whole_view.py``)."""
    from deeplearning4j_tpu_torch.parallel.compile_seam import _splits
    assert partition.sharded_dim(P(None, "data", "model")) == (1, "data")
    assert partition.split_dims(P(("data", "sp"), None, "model")) == [
        (0, ("data", "sp")), (2, ("model",))]
    with pytest.raises(ValueError, match="dp_tp placement.*splits 2"):
        partition.one_split(P("data", "model"), "the dp_tp placement")
    assert partition.one_split(P(None, "model"), "x") == (1, ("model",))
    assert _splits(P("data", "model")) == ((0, ("data",)), (1, ("model",)))
    assert _splits(P()) is None
