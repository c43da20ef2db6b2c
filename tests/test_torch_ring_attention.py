"""The port's ring and Ulysses attention, and sequence-parallel training,
held against the plain attention and single-device ``fit`` (the JAX
``test_ring_attention.py`` and ``test_parallel_spep.py``).

The port runs SPMD on four gloo ranks on the CPU (``tests/_torch_dist.py``,
started once for the module); the JAX references run here. Stated
tolerances, the JAX suite's:
- ring and Ulysses outputs within rtol 2e-4, atol 2e-5 of
  ``attention_reference`` (the port's, itself within 1e-6 of the JAX one),
  and the gradients of ``sum(out ** 2)`` within rtol 5e-4, atol 5e-5;
- ``sequence_parallel`` training of a ``transformer_lm`` (and of a graph
  with a ``TransformerBlock``) on a ``{"data": 2, "sp": 2}`` mesh within
  atol 5e-5, rtol 1e-4 of the port's single-device fit and of the JAX
  single-device fit.
On the CPU the Ulysses core runs the flash kernels' plain versions; on
the card it launches ``flash_fwd`` and the backward pair (``chip_smoke.py``
counts them).
"""
import numpy as np
import pytest

import _torch_dist
from _torch_port import compile_cache_at

WORLD = 4
ATT_RTOL, ATT_ATOL = 2e-4, 2e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5
FIT_ATOL, FIT_RTOL = 5e-5, 1e-4
VOCAB, WIDTH, HEADS, T, B = 8, 32, 4, 16, 8
SHAPE = (2, 64, 8, 16)
GRAD_SHAPE = (1, 32, 4, 8)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def _lm_batches(n=3, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, VOCAB, size=(B, T + 1))
        out.append((np.eye(VOCAB, dtype=np.float32)[ids[:, :-1]],
                    np.eye(VOCAB, dtype=np.float32)[ids[:, 1:]]))
    return out


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return np.asarray(tree)


def _graph_conf():
    from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf.layers import (
        EmbeddingLayer, RnnOutputLayer, TransformerBlock)
    return (NeuralNetConfiguration.builder().seed(2).learning_rate(0.01)
            .updater("adam").graph_builder().add_inputs("ids")
            .add_layer("emb", EmbeddingLayer(n_in=VOCAB, n_out=WIDTH), "ids")
            .add_layer("blk", TransformerBlock(n_in=WIDTH, n_out=WIDTH,
                                               n_heads=HEADS, causal=True),
                       "emb")
            .add_layer("out", RnnOutputLayer(n_in=WIDTH, n_out=VOCAB,
                                             loss="mcxent",
                                             activation="softmax"), "blk")
            .set_outputs("out").build())


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from deeplearning4j_tpu.models import transformer_lm
    from deeplearning4j_tpu.nn.graph_network import ComputationGraph
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork

    ref, jobs = {}, []
    for mode in ("ring", "ulysses"):
        for causal in (False, True):
            jobs.append((f"{mode}_{causal}", dict(
                job="attention", shapes=SHAPE, mode=mode, causal=causal,
                axes={"sp": WORLD})))
        jobs.append((f"{mode}_grad", dict(
            job="attention", shapes=GRAD_SHAPE, mode=mode, causal=True,
            axes={"sp": WORLD}, seed=3)))
    batches = _lm_batches()
    with compile_cache_at(tmp_path_factory.mktemp("xcache")):
        conf = transformer_lm(VOCAB, width=WIDTH, n_layers=2, n_heads=HEADS,
                              max_len=T, learning_rate=0.01)
        jnet = MultiLayerNetwork(conf).init()
        p0 = _np(jnet.params_list)
        for x, y in batches:
            jnet.fit(x, y)
        ref["lm"] = _np(jnet.params_list)
        gconf = _graph_conf()
        jg = ComputationGraph(gconf).init()
        g0 = _np(jg.params_list)
        for x, y in batches[:2]:
            jg.fit([x], [y])
        ref["graph"] = _np(jg.params_list)
    base = dict(job="wrapper", conf_json=conf.to_json(), params=p0,
                batches=batches, axes={"data": 2, "sp": 2})
    jobs += [("lm_single", dict(base, single=True))]
    for mode in ("ulysses", "ring"):
        jobs.append((f"lm_{mode}", dict(
            base, knobs=[("sequence_parallel", ("sp", mode))])))
    # ZeRO over the data axis with the sequence axis beside it
    jobs.append(("lm_zero3_ulysses", dict(
        base, knobs=[("sequence_parallel", ("sp", "ulysses")),
                     ("sharding", ("zero3",))])))
    gbase = dict(job="wrapper", conf_json=gconf.to_json(), params=g0,
                 batches=[([x], [y]) for x, y in batches[:2]],
                 axes={"data": 2, "sp": 2})
    jobs += [("graph_single", dict(gbase, single=True)),
             ("graph_ulysses", dict(gbase, knobs=[("sequence_parallel",
                                                   ("sp",))]))]
    for what in ("ulysses_heads", "local_sgd_sp", "sp_length", "sp_heads"):
        jobs.append((f"raises_{what}", dict(job="raises", what=what)))
    return ref, _torch_dist.run(WORLD, jobs)


def _plain(shape, seed, causal):
    """The port's reference attention of the job's inputs, its gradients of
    ``sum(out ** 2)`` too."""
    import torch

    from deeplearning4j_tpu_torch.parallel.ring_attention import (
        attention_reference)
    q, k, v = (torch.tensor(a, requires_grad=True)
               for a in _qkv(shape, seed))
    out = attention_reference(q, k, v, causal)
    (out ** 2).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (q, k, v)]


@pytest.mark.parametrize("causal", [False, True])
def test_port_reference_equals_jax_reference(causal):
    import jax.numpy as jnp

    from deeplearning4j_tpu.parallel.ring_attention import (
        attention_reference as jax_reference)
    q, k, v = _qkv(SHAPE, 0)
    want = np.asarray(jax_reference(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal))
    got, _ = _plain(SHAPE, 0, causal)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_matches_reference(run, mode, causal):
    _, ranks = run
    want, _ = _plain(SHAPE, 0, causal)
    for r in ranks:
        np.testing.assert_allclose(r[f"{mode}_{causal}"]["out"], want,
                                   rtol=ATT_RTOL, atol=ATT_ATOL)


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_attention_gradients_match(run, mode):
    _, ranks = run
    want_out, want = _plain(GRAD_SHAPE, 3, True)
    for r in ranks:
        got = r[f"{mode}_grad"]
        np.testing.assert_allclose(got["out"], want_out, rtol=ATT_RTOL,
                                   atol=ATT_ATOL)
        for a, b in zip(got["grads"], want):
            np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [np.asarray(tree)]


def _close(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        np.testing.assert_allclose(x, y, atol=FIT_ATOL, rtol=FIT_RTOL)


@pytest.mark.parametrize("mode", ["ulysses", "ring", "zero3_ulysses"])
def test_sequence_parallel_fit_equals_single_device(run, mode):
    ref, ranks = run
    for r in ranks:
        assert r[f"lm_{mode}"]["checksum"] == ranks[0][f"lm_{mode}"][
            "checksum"]
        _close(r[f"lm_{mode}"]["params"], ranks[0][f"lm_{mode}"]["params"])
    got = ranks[0][f"lm_{mode}"]
    _close(got["params"], ranks[0]["lm_single"]["params"])
    _close(got["params"], ref["lm"])
    # the score is the global batch's loss
    np.testing.assert_allclose(got["scores"], ranks[0]["lm_single"]["scores"],
                               rtol=1e-5)
    assert got["stats"]["steps_sync_ksteps"] == 3


def test_sequence_parallel_computation_graph(run):
    ref, ranks = run
    got = ranks[0]["graph_ulysses"]
    _close(got["params"], ranks[0]["graph_single"]["params"])
    _close(got["params"], ref["graph"])


def test_sequence_parallel_refusals(run):
    _, ranks = run
    r = ranks[0]
    assert r["raises_ulysses_heads"]["type"] == "ValueError"
    assert "not divisible" in r["raises_ulysses_heads"]["msg"]
    assert r["raises_local_sgd_sp"]["type"] == "ValueError"
    assert "averaging_frequency" in r["raises_local_sgd_sp"]["msg"]
    msg = r["raises_sp_length"]["msg"]
    assert r["raises_sp_length"]["type"] == "ValueError"
    assert "'sp'" in msg and "18" in msg and "4" in msg
    assert "not divisible" in r["raises_sp_heads"]["msg"]
    assert "[6]" in r["raises_sp_heads"]["msg"]


def test_sequence_parallel_needs_attention_and_refuses_lstm():
    from deeplearning4j_tpu_torch.nn.conf.builders import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        LSTM, DenseLayer, OutputLayer, RnnOutputLayer, SelfAttentionLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper, build_mesh

    mesh = build_mesh({"data": 1, "sp": 1})
    dense = MultiLayerNetwork(
        NeuralNetConfiguration.builder().list()
        .layer(DenseLayer.conf(n_in=4, n_out=4))
        .layer(OutputLayer.conf(n_in=4, n_out=2)).build(), device="cpu")
    with pytest.raises(ValueError, match="no attention layers"):
        ParallelWrapper.builder(dense).mesh(mesh).sequence_parallel(
            "sp").build()
    # the time axis is split: a recurrence would run on its block alone
    mixed = MultiLayerNetwork(
        NeuralNetConfiguration.builder().list()
        .layer(SelfAttentionLayer.conf(n_in=4, n_out=4, n_heads=2))
        .layer(LSTM.conf(n_in=4, n_out=4))
        .layer(RnnOutputLayer.conf(n_in=4, n_out=2)).build(), device="cpu")
    with pytest.raises(ValueError, match="recurrent layer"):
        ParallelWrapper.builder(mixed).mesh(mesh).sequence_parallel(
            "sp").build()
