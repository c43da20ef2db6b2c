"""The port's expert parallelism (``parallel/moe.py`` and
``ParallelWrapper.expert_parallel``) held against the JAX package's
``parallel/moe.py`` and ``ParallelWrapper`` and against dense
single-device ``fit``.

The port runs SPMD on gloo CPU groups of 2 and 4 ranks
(``tests/_torch_dist.py``), each started once for the module; the JAX
references run in this process on the conftest's 8 virtual CPU devices
(``{"expert": n}`` and ``{"data": n}`` over the first n). Router noise is
off everywhere (the two packages draw from different RNGs). Stated
tolerances, JAX's own (``tests/test_parallel_spep.py``,
``tests/test_moe.py``):
- the dispatch's output within atol 2e-5, rtol 2e-4 of JAX's, its aux term
  (the mean of the ranks' shares) within rtol 1e-5, its gradients within
  atol 5e-5, rtol 1e-4; the tokens a tight capacity drops identical;
- ``fit`` within atol 5e-5, rtol 1e-4 of JAX's expert-parallel fit and of
  single-device fit at ``capacity_factor = n_experts`` (nothing drops).

As in ``test_torch_pipeline.py``, the runs held against JAX train with SGD
at 0.1 (Adam's sign-like first steps move a weight whose gradient is
within rounding of 0 by the full rate either way); the MoE LM's own Adam
config is held against the port's single-device fit.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist
from _torch_port import compile_cache_at, no_executable_cache
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterators import (
    ListDataSetIterator as JList)
from deeplearning4j_tpu.models import moe_transformer_lm as jmoe_lm
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.parallel.mesh import build_mesh as jbuild_mesh
from deeplearning4j_tpu.parallel.wrapper import ParallelWrapper as JPW

VOCAB, WIDTH, HEADS, T, B = 8, 32, 4, 16, 8
ATOL, RTOL = 5e-5, 1e-4
FWD_ATOL, FWD_RTOL = 2e-5, 2e-4
#: (ranks, capacity factor) of the standalone dispatch's cases: roomy, and
#: tight enough to drop tokens
FFN_CASES = ((4, 8.0), (4, 0.5), (2, 8.0), (2, 0.75))
F_, E_, H_ = 8, 8, 16


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return np.asarray(tree)


def _lm_batches(n=3, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, VOCAB, size=(B, T + 1))
        out.append((np.eye(VOCAB, dtype=np.float32)[ids[:, :-1]],
                    np.eye(VOCAB, dtype=np.float32)[ids[:, 1:]]))
    return out


def _sgd(text, lr=0.1):
    """A config's JSON with every layer on SGD at ``lr``."""
    d = json.loads(text)
    d["global_conf"].update(updater="sgd", learning_rate=lr)
    layers = (d["layers"] if "layers" in d else
              [v["layer"] for v in d["vertices"].values()
               if isinstance(v, dict) and v.get("layer")])
    for layer in layers:
        layer.update(updater="sgd", learning_rate=lr, bias_learning_rate=lr)
    return json.dumps(d)


def _moe_json(n_layers=2, n_experts=8, sgd=True):
    text = jmoe_lm(VOCAB, width=WIDTH, n_layers=n_layers, n_heads=HEADS,
                   n_experts=n_experts, max_len=T,
                   learning_rate=0.01).to_json()
    return _sgd(text) if sgd else text


def _jconf(text):
    from deeplearning4j_tpu.nn.conf.multilayer import (
        MultiLayerConfiguration as JConf)
    return JConf.from_json(text)


def _graph_json():
    from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf.layers import (
        EmbeddingLayer, RnnOutputLayer)
    from deeplearning4j_tpu.nn.conf.layers.moe import MoETransformerBlock
    conf = (NeuralNetConfiguration.builder().seed(5).learning_rate(0.1)
            .updater("sgd").graph_builder()
            .add_inputs("ids")
            .add_layer("emb", EmbeddingLayer(n_in=VOCAB, n_out=WIDTH), "ids")
            .add_layer("moe", MoETransformerBlock(
                n_in=WIDTH, n_out=WIDTH, n_heads=HEADS, n_experts=8,
                causal=True), "emb")
            .add_layer("out", RnnOutputLayer(n_in=WIDTH, n_out=VOCAB,
                                             loss="mcxent",
                                             activation="softmax"), "moe")
            .set_outputs("out").build())
    return conf.to_json()


def _graph_conf(text):
    from deeplearning4j_tpu.nn.conf.graphconf import (
        ComputationGraphConfiguration)
    return ComputationGraphConfiguration.from_json(text)


def _close(got, want, atol=ATOL, rtol=RTOL):
    if isinstance(want, dict):
        for k in want:
            _close(got[k], want[k], atol, rtol)
        return
    if isinstance(want, (list, tuple)):
        for g, w in zip(got, want):
            _close(g, w, atol, rtol)
        return
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def _jax_fit(net, batches, **knobs):
    if not knobs:
        for x, y in batches:
            net.fit(x, y)
        return _np(net.params_list)
    b = JPW.builder(net).prefetch_buffer(0)
    for k, v in knobs.items():
        b = getattr(b, k)(*v)
    b.build().fit(JList([JDataSet(x, y) for x, y in batches]))
    return _np(net.params_list)


def _job(**kw):
    return kw


_FFN_CONF = {"@type": "MoE", "n_in": F_, "n_out": F_, "n_experts": E_,
             "expert_hidden": H_, "activation": "identity"}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from deeplearning4j_tpu.nn.conf.inputs import InputType
    from deeplearning4j_tpu.nn.conf.layers.moe import MoELayer
    from deeplearning4j_tpu.parallel.moe import (
        ExpertParallelMoE, expert_parallel_ffn)

    ref = {"ffn": {}}
    jobs = {2: [], 4: []}
    with compile_cache_at(tmp_path_factory.mktemp("xcache")), \
            no_executable_cache():
        layer = MoELayer(n_in=F_, n_out=F_, n_experts=E_, expert_hidden=H_,
                         activation="identity")
        params = layer.init_params(jax.random.PRNGKey(0),
                                   InputType.recurrent(F_, 4))
        x = np.random.default_rng(1).normal(size=(8, 4, F_)).astype(
            np.float32)
        for n, cf in FFN_CASES:
            mesh = jbuild_mesh({"expert": n})

            def f(p, xx, mesh=mesh, cf=cf):
                return expert_parallel_ffn(layer, p, xx, mesh, "expert", cf,
                                           train=True)

            y, aux = jax.jit(f)(params, jnp.asarray(x))
            grads = jax.grad(lambda p: jnp.sum(f(p, jnp.asarray(x))[0] ** 2)
                             + f(p, jnp.asarray(x))[1])(params)
            ref["ffn"][(n, cf)] = {"y": np.asarray(y), "aux": float(aux),
                                   "grads": _np(grads)}
            jobs[n].append((f"ffn_{cf}", _job(
                job="moe_ffn", layer_conf=_FFN_CONF, params=_np(params), x=x,
                axes={"expert": n}, axis="expert", capacity_factor=cf)))
        dense, _ = layer.apply(params, {}, jnp.asarray(x))
        ref["dense"] = np.asarray(dense)
        # the activation after the combine (JAX test_expert_parallel_
        # applies_activation)
        tanh = MoELayer(n_in=F_, n_out=F_, n_experts=4, expert_hidden=H_,
                        activation="tanh")
        tp = tanh.init_params(jax.random.PRNGKey(9),
                              InputType.recurrent(F_, 4))
        xt = np.random.default_rng(9).normal(size=(4, 4, F_)).astype(
            np.float32)
        ref["tanh"] = np.asarray(ExpertParallelMoE(
            tanh, jbuild_mesh({"expert": 4}), capacity_factor=8.0)(tp, xt))
        jobs[4].append(("tanh", _job(
            job="moe_ffn", layer_conf=dict(_FFN_CONF, n_experts=4,
                                           activation="tanh"),
            params=_np(tp), x=xt, axes={"expert": 4}, axis="expert",
            capacity_factor=8.0, whole=True)))
        # fit: roomy (equal to dense) and tight capacity, 4 ranks
        batches = _lm_batches()
        text = _moe_json()
        p0 = _np(JNet(_jconf(text)).init().params_list)
        ref["single"] = _jax_fit(JNet(_jconf(text)).init(), batches)
        for cf in (8.0, 1.0):
            ref[f"ep_{cf}"] = _jax_fit(
                JNet(_jconf(text)).init(), batches, workers=(4,),
                expert_parallel=("data", cf))
            jobs[4].append((f"ep_{cf}", _job(
                job="wrapper", conf_json=text, params=p0, batches=batches,
                axes={"data": 4}, knobs=[("expert_parallel", ("data", cf))])))
        jobs[4].append(("single", _job(job="wrapper", conf_json=text,
                                       params=p0, batches=batches,
                                       single=True)))
        # the same on 2 ranks (4 experts a rank)
        ref["ep2"] = _jax_fit(JNet(_jconf(text)).init(), batches,
                              workers=(2,), expert_parallel=("data", 8.0))
        jobs[2].append(("ep2", _job(
            job="wrapper", conf_json=text, params=p0, batches=batches,
            axes={"data": 2}, knobs=[("expert_parallel", ("data", 8.0))])))
        # the LM's own Adam config against the port's single-device fit
        adam = _moe_json(sgd=False)
        ap0 = _np(JNet(_jconf(adam)).init().params_list)
        jobs[4] += [("adam", _job(
            job="wrapper", conf_json=adam, params=ap0, batches=batches,
            axes={"data": 4}, knobs=[("expert_parallel", ("data", 8.0))])),
            ("adam_single", _job(job="wrapper", conf_json=adam, params=ap0,
                                 batches=batches, single=True))]
        # a ComputationGraph (JAX test_expert_parallel_computation_graph)
        from deeplearning4j_tpu.nn.graph_network import (
            ComputationGraph as JGraph)
        gtext = _graph_json()
        gb = batches[:2]
        jg = JGraph(_graph_conf(gtext)).init()
        gp0 = _np(jg.params_list)
        JPW.builder(jg).workers(4).prefetch_buffer(0).expert_parallel(
            "data", 8.0).build().fit(JList([JDataSet(a, b) for a, b in gb]))
        ref["graph"] = _np(jg.params_list)
        single = JGraph(_graph_conf(gtext)).init()
        for a, b in gb:
            single.fit([a], [b])
        ref["graph_single"] = _np(single.params_list)
        jobs[4].append(("graph", _job(
            job="wrapper", conf_json=gtext, params=gp0,
            batches=[([a], [b]) for a, b in gb], axes={"data": 4},
            knobs=[("expert_parallel", ("data", 8.0))])))
        # composed with Ulysses on {data: 2, sp: 2} (JAX test_seq_and_
        # expert_parallel_compose)
        stext = _moe_json(n_layers=1, n_experts=4)
        sb = batches[:2]
        sp0 = _np(JNet(_jconf(stext)).init().params_list)
        ref["sp_single"] = _jax_fit(JNet(_jconf(stext)).init(), sb)
        ref["sp"] = _jax_fit(
            JNet(_jconf(stext)).init(), sb,
            mesh=(jbuild_mesh({"data": 2, "sp": 2}),),
            sequence_parallel=("sp",), expert_parallel=("data", 4.0))
        jobs[4].append(("sp", _job(
            job="wrapper", conf_json=stext, params=sp0, batches=sb,
            axes={"data": 2, "sp": 2},
            knobs=[("sequence_parallel", ("sp",)),
                   ("expert_parallel", ("data", 4.0))])))
        for what in ("indivisible_experts", "experts_without_moe",
                     "expert_axis"):
            jobs[4].append((what, _job(job="raises", what=what)))
    ranks = {w: _torch_dist.run(w, j) for w, j in jobs.items()}
    return ref, ranks


@pytest.mark.parametrize("n,cf", FFN_CASES)
def test_expert_parallel_ffn_equals_jax(run, n, cf):
    ref, ranks = run
    want = ref["ffn"][(n, cf)]
    got = [r[f"ffn_{cf}"] for r in ranks[n]]
    y = np.concatenate([g["y"] for g in got])
    np.testing.assert_allclose(y, want["y"], atol=FWD_ATOL, rtol=FWD_RTOL)
    # the ranks' aux shares average to JAX's global term
    np.testing.assert_allclose(np.mean([g["aux"] for g in got]), want["aux"],
                               rtol=1e-5)
    _close(got[0]["grads"], want["grads"])


@pytest.mark.parametrize("n,cf", FFN_CASES)
def test_capacity_drops_the_same_tokens(run, n, cf):
    """A dropped token's output is exactly 0 (and a kept one's is not, in
    both packages): the drop sets are identical, each rank's count of
    dropped tokens is what it reports, and at the roomy capacity nothing
    drops and the dispatch equals the dense layer."""
    ref, ranks = run
    want = ref["ffn"][(n, cf)]
    got = [r[f"ffn_{cf}"] for r in ranks[n]]
    kept = np.concatenate([np.abs(g["y"].reshape(-1, F_)).sum(axis=1) > 0
                           for g in got])
    jax_kept = np.abs(want["y"].reshape(-1, F_)).sum(axis=1) > 0
    np.testing.assert_array_equal(kept, jax_kept)
    for g in got:
        rows = g["y"].reshape(-1, F_)
        assert g["tokens"] == {
            "tokens": len(rows),
            "dropped": int((np.abs(rows).sum(axis=1) == 0).sum())}
    if cf >= E_:
        assert kept.all()
        np.testing.assert_allclose(want["y"], ref["dense"], atol=FWD_ATOL,
                                   rtol=FWD_RTOL)
    else:
        assert 0 < kept.sum() < kept.size


def test_expert_parallel_moe_applies_activation(run):
    ref, ranks = run
    for r in ranks[4]:
        np.testing.assert_allclose(r["tanh"]["y"], ref["tanh"],
                                   atol=FWD_ATOL, rtol=FWD_RTOL)


@pytest.mark.parametrize("cf", (8.0, 1.0))
def test_expert_parallel_fit_equals_jax(run, cf):
    """4 ranks, 2 experts a rank: JAX's expert-parallel fit; at the roomy
    capacity also single-device fit (the port's and JAX's); at the tight
    one the drops make it another function, and JAX's is the reference."""
    ref, ranks = run
    for r in ranks[4]:
        got = r[f"ep_{cf}"]
        _close(got["params"], ref[f"ep_{cf}"])
        if cf >= 8:
            _close(got["params"], ref["single"])
            _close(got["params"], ranks[4][0]["single"]["params"])
            np.testing.assert_allclose(got["scores"],
                                       ranks[4][0]["single"]["scores"],
                                       rtol=1e-5)
        assert got["collectives"]["all_to_all/moe_dispatch"] > 0
        assert got["iteration"] == 3
    assert not np.allclose(ranks[4][0]["ep_1.0"]["params"][1]["W1"],
                           ranks[4][0]["single"]["params"][1]["W1"],
                           atol=1e-6, rtol=0)


def test_expert_parallel_two_ranks(run):
    ref, ranks = run
    for r in ranks[2]:
        _close(r["ep2"]["params"], ref["ep2"])
        _close(r["ep2"]["params"], ref["single"])


def test_expert_parallel_adam_equals_single_device(run):
    _, ranks = run
    for r in ranks[4]:
        _close(r["adam"]["params"], ranks[4][0]["adam_single"]["params"])


def test_expert_parallel_computation_graph(run):
    ref, ranks = run
    for r in ranks[4]:
        got = r["graph"]
        _close(got["params"], ref["graph"])
        _close(got["params"], ref["graph_single"])
        assert got["collectives"]["all_to_all/moe_dispatch"] > 0


def test_expert_parallel_composes_with_ulysses(run):
    ref, ranks = run
    for r in ranks[4]:
        got = r["sp"]
        _close(got["params"], ref["sp"])
        _close(got["params"], ref["sp_single"])
        assert got["collectives"]["all_to_all/moe_dispatch"] > 0


@pytest.mark.parametrize("what", ("indivisible_experts",
                                  "experts_without_moe"))
def test_refusals_carry_jax_messages(run, what):
    from deeplearning4j_tpu.models import transformer_lm
    _, ranks = run
    if what == "indivisible_experts":
        net = JNet(jmoe_lm(VOCAB, width=WIDTH, n_layers=1, n_heads=HEADS,
                           n_experts=6, max_len=16)).init()
    else:
        net = JNet(transformer_lm(8, width=32, n_layers=1, n_heads=4,
                                  max_len=16)).init()
    with pytest.raises(ValueError) as want:
        JPW.builder(net).workers(4).expert_parallel("data").build()
    for r in ranks[4]:
        assert r[what] == {"type": "ValueError", "msg": str(want.value)}


def test_expert_axis_must_be_the_data_axis(run):
    _, ranks = run
    for r in ranks[4]:
        assert r["expert_axis"]["type"] == "ValueError"
        assert "use 'data'" in r["expert_axis"]["msg"]


def test_group_of_one_runs_the_dispatch():
    """``data: 1`` without a process group: the dispatch runs (capacity
    packing on one rank, no exchange) and equals the dense path when
    nothing drops; the eval forward publishes no aux."""
    import torch

    from deeplearning4j_tpu_torch.convert import from_jax
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper, context
    from deeplearning4j_tpu_torch.parallel.mesh import build_mesh

    text = _moe_json(n_layers=1)
    p0 = _np(JNet(_jconf(text)).init().params_list)
    batches = _lm_batches(2)
    a = from_jax(text, p0, device="cpu")
    for x, y in batches:
        a.fit(x, y)
    b = from_jax(text, p0, device="cpu")
    pw = ParallelWrapper.builder(b).prefetch_buffer(0).expert_parallel(
        "data", 8.0).build()
    assert pw.expert_axis == "data"
    pw.fit(ListDataSetIterator([DataSet(x, y) for x, y in batches]))
    for da, db in zip(a.params_list, b.params_list):
        for k in da:
            np.testing.assert_allclose(db[k].detach().numpy(),
                                       da[k].detach().numpy(), atol=2e-6)
    layer = b.layers[1]
    with context.parallel_context(build_mesh({"data": 1}),
                                  expert_axis="data", capacity_factor=8.0):
        assert layer.ep_context() is not None
        out, state = layer.apply_with_state(
            b.params_list[1], layer.state(),
            torch.randn(2, T, WIDTH), train=False)
    assert float(state["aux_loss"]) == 0.0 and out.shape == (2, T, WIDTH)
