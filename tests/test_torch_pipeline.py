"""The port's GPipe pipeline and ``PipelineTrainer`` held against the JAX
``parallel/pipeline.py`` and ``parallel/pipeline_trainer.py`` and against
single-device ``fit``.

The port runs SPMD, one stage a rank: gloo CPU groups of 2 and 4 ranks
(``tests/_torch_dist.py``), each started once for the module. The JAX
references run in this process on the conftest's 8 virtual CPU devices
(``build_mesh({"stage": S})`` over the first S). Weights cross only through
``convert.from_jax``. Stated tolerances, JAX's own
(``tests/test_pipeline_trainer.py``):
- the executor's output within atol 2e-5, rtol 1e-4 of JAX's and of
  ``reference_forward``; its gradients within atol 5e-5, rtol 1e-4 of the
  sequential blocks' autograd and, in one case, of JAX's autodiff;
- ``PipelineTrainer.fit`` within atol 5e-5, rtol 1e-4 of JAX's trainer and
  of single-device fit (the port's and JAX's).

The runs held against JAX train with SGD at 0.1 (``_conf_json``): Adam's
first steps are sign-like, ``g / (|g| + eps)``, so a gradient entry within
rounding of 0 moves its weight by up to the full rate either way, and the
port's single-device ``fit`` of the LM's own Adam config is already past
the bound on 2 of its 52k weights after 3 steps against JAX's. The Adam
config runs through the pipeline too, held against the port's
single-device ``fit``.
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
from deeplearning4j_tpu.models import transformer_lm as jtransformer_lm
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.parallel.mesh import build_mesh as jbuild_mesh
from deeplearning4j_tpu.parallel.pipeline_trainer import (
    PipelineTrainer as JTrainer)

VOCAB, WIDTH, HEADS, T, B = 8, 32, 4, 16, 8
ATOL, RTOL = 5e-5, 1e-4
FWD_ATOL = 2e-5
#: (stages, blocks a stage) of the executor's cases
EXEC_CASES = ((2, 1), (2, 2), (4, 1), (4, 2))
#: (stages, microbatches, layers) of the trainer's cases
FIT_CASES = ((2, 4, 4), (4, 4, 4), (2, 2, 2))
#: the executor's case whose gradients are also held against JAX's
#: autodiff (a JAX gradient through the interpret-mode flash kernels and
#: the shard_map compiles for about 25 s on the CPU; every case is held
#: against the sequential blocks' autograd)
JAX_GRAD_CASE = (4, 1)


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


def _conf(n_layers=4, checkpointing=False):
    c = jtransformer_lm(VOCAB, width=WIDTH, n_layers=n_layers,
                        n_heads=HEADS, max_len=T, learning_rate=0.01)
    c.global_conf.gradient_checkpointing = checkpointing
    return c


def _conf_json(n_layers=4, checkpointing=False, reg=False, updater="sgd",
               lr=0.1):
    """The LM's JSON with every layer's updater and rates replaced (and,
    with ``reg``, l1 and l2 on every layer)."""
    d = json.loads(_conf(n_layers, checkpointing).to_json())
    d["global_conf"].update(updater=updater, learning_rate=lr,
                            use_regularization=reg)
    for layer in d["layers"]:
        layer.update(updater=updater, learning_rate=lr, bias_learning_rate=lr)
        if reg:
            layer.update(l2=1e-2, l1=1e-3)
    return json.dumps(d)


def _jconf(text):
    from deeplearning4j_tpu.nn.conf.multilayer import (
        MultiLayerConfiguration as JConf)
    return JConf.from_json(text)


def _block():
    from deeplearning4j_tpu.nn.conf.layers import TransformerBlock
    return TransformerBlock(n_in=WIDTH, n_out=WIDTH, n_heads=HEADS,
                            causal=True, activation="identity")


_BLOCK_CONF = {"@type": "TransformerBlock", "n_in": WIDTH, "n_out": WIDTH,
               "n_heads": HEADS, "causal": True, "activation": "identity"}


def _jax_fit_single(conf, batches):
    net = JNet(conf).init()
    for x, y in batches:
        net.fit(x, y)
    return net


def _close(got, want, atol=ATOL, rtol=RTOL):
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_allclose(g[k], np.asarray(w[k]), atol=atol,
                                       rtol=rtol, err_msg=k)


def _job(**kw):
    return kw


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX references, then the port's scenarios on 2 and 4 ranks."""
    from deeplearning4j_tpu.nn.conf.inputs import InputType
    from deeplearning4j_tpu.parallel.pipeline import (
        PipelineParallel, stack_block_params)

    ref = {"exec": {}, "fit": {}}
    jobs = {2: [], 4: []}
    with compile_cache_at(tmp_path_factory.mktemp("xcache")), \
            no_executable_cache():
        block = _block()
        x = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                         (B, T, WIDTH), jnp.float32))
        for S, per in EXEC_CASES:
            n = S * per
            params = [block.init_params(k, InputType.recurrent(WIDTH, T))
                      for k in jax.random.split(jax.random.PRNGKey(n), n)]
            stacked = stack_block_params(params)
            pipe = PipelineParallel(
                jbuild_mesh({"stage": S}),
                lambda p, h: block.apply(p, {}, h, train=True, rng=None)[0],
                n_blocks=n, n_microbatches=4)

            ref["exec"][(S, per)] = {"out": np.asarray(pipe(stacked, x))}
            if (S, per) == JAX_GRAD_CASE:
                def loss(st, xx, pipe=pipe):
                    return jnp.sum(pipe(st, xx) ** 2)

                gst, gx = jax.grad(loss, argnums=(0, 1))(stacked,
                                                         jnp.asarray(x))
                ref["exec"][(S, per)].update(grads=_np(gst),
                                             gx=np.asarray(gx))
            jobs[S].append((f"exec_{per}", _job(
                job="pipeline_parallel", block_conf=_BLOCK_CONF,
                stacked=_np(stacked), x=x, axes={"stage": S})))
        batches = _lm_batches()
        for S, M, L in FIT_CASES:
            text = _conf_json(L)
            p0 = _np(JNet(_jconf(text)).init().params_list)
            jnet = JNet(_jconf(text)).init()
            JTrainer(jnet, mesh=jbuild_mesh({"stage": S}),
                     n_microbatches=M).fit(
                JList([JDataSet(a, b) for a, b in batches]))
            ref["fit"][(S, M, L)] = {
                "pipe": _np(jnet.params_list),
                "score": float(jnet.score_value),
                "single": _np(_jax_fit_single(_jconf(text), batches)
                              .params_list)}
            jobs[S].append((f"fit_{M}_{L}", _job(
                job="pipeline", conf_json=text, params=p0,
                batches=batches, axes={"stage": S}, n_micro=M,
                hold_check=True)))
            jobs[S].append((f"single_{M}_{L}", _job(
                job="wrapper", conf_json=text, params=p0,
                batches=batches, single=True)))
        # the LM's own Adam config against the port's single-device fit
        adam = _conf(4).to_json()
        ap0 = _np(JNet(_conf(4)).init().params_list)
        jobs[4] += [("adam", _job(job="pipeline", conf_json=adam, params=ap0,
                                  batches=batches, axes={"stage": 4},
                                  hold_check=True, hold_updater=True)),
                    ("adam_single", _job(job="wrapper", conf_json=adam,
                                         params=ap0, batches=batches,
                                         single=True))]
        # gradient checkpointing (JAX test_pipeline_with_gradient_
        # checkpointing: 2 blocks, 2 stages, 2 microbatches)
        gtext = _conf_json(2, checkpointing=True)
        gb = batches[:2]
        gp0 = _np(JNet(_jconf(gtext)).init().params_list)
        jnet = JNet(_jconf(gtext)).init()
        JTrainer(jnet, mesh=jbuild_mesh({"stage": 2}),
                 n_microbatches=2).fit(JList([JDataSet(a, b) for a, b in gb]))
        ref["remat"] = {"pipe": _np(jnet.params_list),
                        "single": _np(_jax_fit_single(_jconf(gtext), gb)
                                      .params_list)}
        jobs[2].append(("remat", _job(
            job="pipeline", conf_json=_conf_json(2), params=gp0,
            batches=gb, axes={"stage": 2}, n_micro=2, checkpointing=True)))
        # a regularized stack over several epochs: the regularization of
        # the blocks on their stages, of the rest on the last
        rj = _conf_json(4, reg=True)
        rp0 = _np(JNet(_jconf(rj)).init().params_list)
        jr = JNet(_jconf(rj)).init()
        JTrainer(jr, mesh=jbuild_mesh({"stage": 4}), n_microbatches=2).fit(
            JList([JDataSet(a, b) for a, b in batches[:2]]), epochs=2)
        ref["reg"] = {"pipe": _np(jr.params_list),
                      "score": float(jr.score_value)}
        jobs[4].append(("reg", _job(
            job="pipeline", conf_json=rj, params=rp0, batches=batches[:2],
            axes={"stage": 4}, n_micro=2, epochs=2)))
        jobs[2].append(("indivisible", _job(job="raises",
                                            what="pipeline_indivisible")))
        # a sharded CheckpointListener inside the fit (the Adam config on
        # 2 stages: the blocks' moments are per stage too)
        ref["ck_dir"] = str(tmp_path_factory.mktemp("ck"))
        jobs[2].append(("ck", _job(
            job="checkpoint", conf_json=adam, params=ap0, batches=batches,
            directory=ref["ck_dir"], axes={"stage": 2}, n_micro=2)))
    ranks = {w: _torch_dist.run(w, j) for w, j in jobs.items()}
    return ref, ranks


def test_find_block_run_equals_jax():
    from deeplearning4j_tpu.models import moe_transformer_lm
    from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu.parallel.pipeline_trainer import (
        find_block_run as jfind)
    from deeplearning4j_tpu_torch.nn.conf.multilayer import (
        MultiLayerConfiguration)
    from deeplearning4j_tpu_torch.parallel.pipeline_trainer import (
        find_block_run)

    dense = (NeuralNetConfiguration.builder().seed(1).list()
             .layer(DenseLayer(n_in=4, n_out=8, activation="tanh"))
             .layer(DenseLayer(n_in=8, n_out=8, activation="tanh"))
             .layer(DenseLayer(n_in=8, n_out=8, activation="tanh"))
             .layer(DenseLayer(n_in=8, n_out=8, activation="relu"))
             .layer(OutputLayer(n_in=8, n_out=3, loss="mcxent",
                                activation="softmax")).build())
    confs = [_conf(4), _conf(1), _conf(7),
             moe_transformer_lm(VOCAB, width=WIDTH, n_layers=3,
                                n_heads=HEADS, max_len=T), dense]
    for conf in confs:
        port = MultiLayerConfiguration.from_json(conf.to_json())
        assert find_block_run(port.layers) == jfind(conf.layers)
    assert find_block_run(
        MultiLayerConfiguration.from_json(_conf(4).to_json()).layers) == (1, 5)


@pytest.mark.parametrize("S,per", EXEC_CASES)
def test_pipeline_parallel_equals_jax_and_reference(run, S, per):
    ref, ranks = run
    want = ref["exec"][(S, per)]
    outs = [r[f"exec_{per}"] for r in ranks[S]]
    last = outs[-1]
    assert last["is_last"] and not any(o["is_last"] for o in outs[:-1])
    np.testing.assert_allclose(last["out"], want["out"], atol=FWD_ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(last["out"], last["ref"], atol=FWD_ATOL,
                               rtol=RTOL)
    # only the last stage's buffer is real: the others hold zeros
    assert all(o["zeros"] for o in outs[:-1])


@pytest.mark.parametrize("S,per", EXEC_CASES)
def test_pipeline_gradients_equal_sequential_and_jax(run, S, per):
    """The reverse pipeline: the stacked params' and the input's gradients
    of ``sum(out ** 2)``, summed over the stages, equal the sequential
    blocks' autograd and (``JAX_GRAD_CASE``) JAX's autodiff through its
    ppermutes."""
    ref, ranks = run
    got = ranks[S][0][f"exec_{per}"]
    wants = [(got["ref_grads"], got["ref_gx"])]
    if (S, per) == JAX_GRAD_CASE:
        want = ref["exec"][(S, per)]
        wants.append((want["grads"], want["gx"]))
    for grads, gx in wants:
        for k in grads:
            np.testing.assert_allclose(got["grads"][k], grads[k], atol=ATOL,
                                       rtol=RTOL, err_msg=k)
        np.testing.assert_allclose(got["gx"], gx, atol=ATOL, rtol=RTOL)
    st = got["stats"]
    assert st["route"] == "p2p"  # gloo on CPU tensors
    assert st["ticks"] == S + 4 - 1 and st["stage_runs"] == 4


@pytest.mark.parametrize("S,M,L", FIT_CASES)
def test_pipeline_fit_equals_jax_and_single_device(run, S, M, L):
    ref, ranks = run
    want = ref["fit"][(S, M, L)]
    single = ranks[S][0][f"single_{M}_{L}"]
    for r in ranks[S]:
        got = r[f"fit_{M}_{L}"]
        _close(got["params"], want["pipe"])
        _close(got["params"], want["single"])
        _close(got["params"], single["params"])
        assert got["iteration"] == 3
        assert got["last_batch_size"] == B
        np.testing.assert_allclose(got["scores"], single["scores"],
                                   rtol=1e-5)
        np.testing.assert_allclose(got["scores"][-1], want["score"],
                                   rtol=1e-5)
        assert got["stats"]["route"] == "p2p"
        assert got["stats"]["steps"] == 3
        assert got["stats"]["ticks"] == 3 * (S + M - 1)


@pytest.mark.parametrize("S,M,L", FIT_CASES)
def test_pipeline_memory_is_per_stage(run, S, M, L):
    """Between steps a stage holds only its own blocks' params (and their
    updater state): the other blocks' tensors have no storage, and the
    held bytes are 1/S of the run's. ``fit`` ends with every leaf whole."""
    _, ranks = run
    per = L // S
    for stage, r in enumerate(ranks[S]):
        got = r[f"fit_{M}_{L}"]
        assert got["own"] == [1 + stage * per + j for j in range(per)]
        whole = sum(np.asarray(v).nbytes for i in range(1, 1 + L)
                    for v in got["params"][i].values())
        for h in got["holds"]:
            assert h["held"] * S == whole
            for b, storage in enumerate(h["storage"]):
                assert (storage > 0) == (b // per == stage)
        for i in range(len(got["params"])):
            for k, v in got["params"][i].items():
                np.testing.assert_array_equal(
                    v, ranks[S][0][f"fit_{M}_{L}"]["params"][i][k])


def test_pipeline_updater_state_is_per_stage(run):
    """The Adam run on 4 stages: between steps a stage holds its own
    blocks' params and moments only; after fit every moment is whole and
    the same on every rank."""
    _, ranks = run
    for stage, r in enumerate(ranks[4]):
        got = r["adam"]
        for h in got["holds"]:
            assert [s > 0 for s in h["storage"]] == [
                b == stage for b in range(4)]
        for i in range(len(got["updater"])):
            for k, slots in got["updater"][i].items():
                assert set(slots) == {"m", "v"}
                for slot, v in slots.items():
                    np.testing.assert_array_equal(
                        v, ranks[4][0]["adam"]["updater"][i][k][slot])


def test_sharded_checkpoint_saves_each_block_from_its_stage(run):
    """A ``CheckpointListener(sharded=True)`` inside a 2-stage fit: each
    block's params and moments are written by the stage that owns it and
    by no other, with no gather (the listener sees the other stage's
    blocks without storage), and the last checkpoint restores bitwise to
    the whole state every rank ends the fit with."""
    import os

    from torch.distributed.checkpoint import FileSystemReader

    from deeplearning4j_tpu_torch.optimize.listeners import (
        CheckpointListener)
    from deeplearning4j_tpu_torch.utils.sharded_checkpoint import (
        restore_sharded)

    ref, ranks = run
    got = [r["ck"] for r in ranks[2]]
    assert all(g["min_storage"] == 0 for g in got)
    last = CheckpointListener.last_checkpoint(ref["ck_dir"])
    assert last == os.path.join(ref["ck_dir"], "checkpoint_iter_3")
    md = FileSystemReader(os.path.join(last, "state")).read_metadata()
    files = {}
    for index, info in md.storage_data.items():
        files.setdefault(index.fqn, set()).add(info.relative_path)
    for i in range(1, 5):  # blocks 1, 2 on stage 0; 3, 4 on stage 1
        owner = (i - 1) // 2
        for k in ("params/{}/Wqkv", "updater/{}/Wqkv/m"):
            assert files[k.format(i)] == {f"__{owner}_0.distcp"}
    back = restore_sharded(last, device="cpu")
    assert back.iteration == got[0]["iteration"] == 3
    for g in got:
        for a, b in zip(back.params_list, g["params"]):
            for k in b:
                np.testing.assert_array_equal(a[k].detach().numpy(), b[k])
        for a, b in zip(back.updater_state, g["updater"]):
            for k in b:
                for slot in b[k]:
                    np.testing.assert_array_equal(
                        a[k][slot].detach().numpy(), b[k][slot])


def test_listeners_reading_whole_state_refused(tmp_path):
    """A zip checkpoint and the param log inside a pipelined fit (the name
    is kept from when the fit refused them): on ``{stage: 1}`` the one
    stage owns every block, so they read the network as it is and need no
    view; the last zip is bitwise the state the fit leaves. The two-stage
    whole view is ``test_torch_whole_view.py``'s."""
    from deeplearning4j_tpu_torch.convert import from_jax, to_numpy
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CheckpointListener, ParamAndGradientIterationListener)
    from deeplearning4j_tpu_torch.parallel.mesh import build_mesh
    from deeplearning4j_tpu_torch.parallel.pipeline_trainer import (
        PipelineTrainer)
    from deeplearning4j_tpu_torch.utils.model_serializer import (
        restore_multi_layer_network)

    conf = _conf(2)
    p0 = _np(JNet(conf).init().params_list)
    batches = _lm_batches(2)
    net = from_jax(conf.to_json(), p0, device="cpu")
    log = ParamAndGradientIterationListener(print_mean_magnitudes=False)
    net.set_listeners(CheckpointListener(str(tmp_path), every_n_iterations=1,
                                         every_n_epochs=None), log)
    trainer = PipelineTrainer(net, mesh=build_mesh({"stage": 1}),
                              n_microbatches=2)
    trainer.fit(ListDataSetIterator([DataSet(x, y) for x, y in batches]))
    assert net.iteration == 2 and len(log.rows) == 2
    assert trainer.held_parts() == frozenset()
    assert trainer.stats()["whole_views"] == 0
    back = restore_multi_layer_network(
        str(tmp_path / "checkpoint_iter_2.zip"), device="cpu")
    for a, b in zip(to_numpy(back.params_list), to_numpy(net.params_list)):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    for a, b in zip(to_numpy(back.updater_state),
                    to_numpy(net.updater_state)):
        for k in b:
            for slot in b[k]:
                np.testing.assert_array_equal(a[k][slot], b[k][slot])


def test_pipeline_adam_equals_single_device(run):
    """The LM's own config (Adam at 0.01) through 4 stages: the port's
    single-device fit on the same batches."""
    _, ranks = run
    for r in ranks[4]:
        _close(r["adam"]["params"], ranks[4][0]["adam_single"]["params"])
        np.testing.assert_allclose(r["adam"]["scores"],
                                   ranks[4][0]["adam_single"]["scores"],
                                   rtol=1e-5)


def test_pipeline_with_gradient_checkpointing(run):
    ref, ranks = run
    for r in ranks[2]:
        _close(r["remat"]["params"], ref["remat"]["pipe"])
        _close(r["remat"]["params"], ref["remat"]["single"])


def test_pipeline_regularized_epochs_equal_jax(run):
    ref, ranks = run
    for r in ranks[4]:
        _close(r["reg"]["params"], ref["reg"]["pipe"])
        np.testing.assert_allclose(r["reg"]["scores"][-1],
                                   ref["reg"]["score"], rtol=1e-5)
        assert r["reg"]["iteration"] == 4


def _refusal_pairs():
    """(port network, JAX network) for each refusal a group of one raises
    at construction."""
    from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu.models import moe_transformer_lm
    from deeplearning4j_tpu.nn.conf.multilayer import (
        MultiLayerConfiguration as JConf)
    from deeplearning4j_tpu.nn.conf.preprocessors import (
        RnnToFeedForwardPreProcessor)
    from deeplearning4j_tpu_torch.nn.conf.multilayer import (
        MultiLayerConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    mixed = (NeuralNetConfiguration.builder().seed(1).learning_rate(0.1)
             .list()
             .layer(DenseLayer(n_in=4, n_out=8, activation="tanh"))
             .layer(DenseLayer(n_in=8, n_out=3, activation="tanh"))
             .layer(OutputLayer(n_in=3, n_out=3, loss="mcxent",
                                activation="softmax")).build())
    dropout = json.loads(_conf(2).to_json())
    for layer in dropout["layers"][1:3]:
        layer["dropout"] = 0.9
    moe = moe_transformer_lm(VOCAB, width=WIDTH, n_layers=2, n_heads=HEADS,
                             max_len=T)
    pre = _conf(2)
    pre.preprocessors["2"] = RnnToFeedForwardPreProcessor()
    out = []
    for text in (mixed.to_json(), json.dumps(dropout), moe.to_json(),
                 pre.to_json()):
        out.append((MultiLayerNetwork(MultiLayerConfiguration.from_json(
            text), device="cpu").init(), JNet(JConf.from_json(text)).init()))
    return out


@pytest.mark.parametrize("case", range(4))
def test_refusals_carry_jax_messages(case):
    """No homogeneous run, dropout in the blocks, a block that publishes
    state (the MoE block's aux_loss), a preprocessor inside the run: the
    port refuses each with JAX's message."""
    from deeplearning4j_tpu_torch.parallel.mesh import build_mesh
    from deeplearning4j_tpu_torch.parallel.pipeline_trainer import (
        PipelineTrainer)

    net, jnet = _refusal_pairs()[case]
    with pytest.raises(ValueError) as want:
        JTrainer(jnet, mesh=jbuild_mesh({"stage": 1}))
    with pytest.raises(ValueError) as got:
        PipelineTrainer(net, mesh=build_mesh({"stage": 1}))
    assert str(got.value) == str(want.value)


def test_refusal_indivisible_stages(run):
    _, ranks = run
    conf = _conf(3)
    with pytest.raises(ValueError) as want:
        JTrainer(JNet(conf).init(), mesh=jbuild_mesh({"stage": 2}))
    for r in ranks[2]:
        assert r["indivisible"] == {"type": "ValueError",
                                    "msg": str(want.value)}


def test_masked_batch_refused_after_earlier_batches():
    """A masked batch raises JAX's message once every earlier batch has
    trained (the prefetcher's producer raises it in order)."""
    from deeplearning4j_tpu_torch.convert import from_jax
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel.mesh import build_mesh
    from deeplearning4j_tpu_torch.parallel.pipeline_trainer import (
        PipelineTrainer)

    conf = _conf(2)
    net = from_jax(conf.to_json(), _np(JNet(conf).init().params_list),
                   device="cpu")
    (x, y), = _lm_batches(1)
    data = [DataSet(x, y), DataSet(x, y, features_mask=np.ones((B, T),
                                                               np.float32))]
    trainer = PipelineTrainer(net, mesh=build_mesh({"stage": 1}),
                              n_microbatches=2)
    with pytest.raises(ValueError, match="does not support masked batches"):
        trainer.fit(ListDataSetIterator(data))
    assert net.iteration == 1
    # the blocks are whole again after the failed fit
    assert all(p.untyped_storage().size() > 0
               for d in net.params_list for p in d.values())


def test_group_of_one_equals_fit():
    """``stage: 1`` without a process group: the schedule's M ticks on one
    rank, the step equal to the network's own to float rounding."""
    from deeplearning4j_tpu_torch.convert import from_jax
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel.mesh import build_mesh
    from deeplearning4j_tpu_torch.parallel.pipeline_trainer import (
        PipelineTrainer)

    conf = _conf(2)
    p0 = _np(JNet(conf).init().params_list)
    batches = _lm_batches(2)
    a = from_jax(conf.to_json(), p0, device="cpu")
    for x, y in batches:
        a.fit(x, y)
    b = from_jax(conf.to_json(), p0, device="cpu")
    trainer = PipelineTrainer(b, mesh=build_mesh({"stage": 1}),
                              n_microbatches=4)
    trainer.fit(ListDataSetIterator([DataSet(x, y) for x, y in batches]))
    for da, db in zip(a.params_list, b.params_list):
        for k in da:
            np.testing.assert_allclose(db[k].detach().numpy(),
                                       da[k].detach().numpy(), atol=2e-6)
    assert trainer.stats()["route"] == "none"
    assert trainer.stats()["ticks"] == 2 * 4
    assert b.iteration == 2
