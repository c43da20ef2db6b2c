"""The port's K-step fused dispatch (``nn/ksteps.py``), its batch grouping
(``utils/batching.py``) and its prefetcher (``datasets/prefetch.py``),
held against the JAX package and against the port's own single steps on
the CPU.

On the CPU a K-step group is a plain loop of the network's single step, so
``fit_iterator(ksteps=3)`` and ``fit(epochs=5)`` give params bitwise equal
to single steps, and prefetch depths 0 and 2 agree bitwise. Against the JAX
``fit_iterator(ksteps=3)`` / ``fit(epochs=5)`` from the same params
(``convert.from_jax``), for ``lenet_mnist()`` at B = 8 and the two-input
merge graph of ``tests/test_torch_graph.py``: each iteration's loss within
1e-5 relative, params within atol 1e-5 + rtol 1e-5 a leaf (float32, sums
in another order; the JAX steps run its plain XLA path on the CPU).
The captured step on the card is held against single steps by the
``cuda`` tests of ``tests/test_torch_cuda_kernels.py``.
"""
import threading

import numpy as np
import pytest
import torch

from _torch_port import compile_cache_at
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models.lenet import lenet_mnist as jax_lenet
from deeplearning4j_tpu.nn.graph_network import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.graph_network import MultiDataSet as JMDS
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch.convert import from_jax, to_numpy
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.datasets.prefetch import (
    DevicePrefetcher, stage_to_device)
from deeplearning4j_tpu_torch.nn.graph_network import MultiDataSet
from deeplearning4j_tpu_torch.nn.ksteps import copy_into
from deeplearning4j_tpu_torch.utils.batching import k_step_groups
from test_torch_graph import _merge_graph

ATOL = RTOL = 1e-5
B = 8


# ------------------------------------------------------------ k_step_groups
def _arr(n, rows=B):
    return np.full((rows, 2), n, np.float32)


@pytest.mark.parametrize("case", ["order", "masked", "ragged", "k1"])
def test_k_step_groups(case):
    """Groups keep the order; a declined (masked) dataset flushes the
    pending group and goes out alone; a shape change flushes; ``k = 1``
    makes groups of one."""
    if case == "order":
        items, k = [_arr(i) for i in range(7)], 3
        want = [("group", [0, 1, 2]), ("group", [3, 4, 5]), ("group", [6])]
    elif case == "masked":
        items, k = [_arr(0), _arr(1), None, _arr(3), _arr(4), _arr(5)], 3
        want = [("group", [0, 1]), ("single", None), ("group", [3, 4, 5])]
    elif case == "ragged":
        items, k = [_arr(0), _arr(1), _arr(2), _arr(3, rows=5),
                    _arr(4, rows=5)], 4
        want = [("group", [0, 1, 2]), ("group", [3, 4])]
    else:
        items, k = [_arr(i) for i in range(3)], 1
        want = [("group", [0]), ("group", [1]), ("group", [2])]
    got = []
    for kind, item in k_step_groups(items, k, lambda a: a):
        got.append((kind, None if kind == "single"
                    else [int(a[0, 0]) for a in item]))
    assert got == want


# ------------------------------------------------------------ prefetcher
def test_prefetcher_orders_and_stages():
    pf = DevicePrefetcher(iter(range(10)), lambda i: i * 2, depth=2)
    assert list(pf) == [i * 2 for i in range(10)]
    assert not pf.thread.is_alive() and pf.staged == 10


def test_prefetcher_depth_zero_is_inline():
    pf = DevicePrefetcher(iter(range(5)), lambda i: i + 1, depth=0)
    assert list(pf) == [1, 2, 3, 4, 5]
    assert pf.thread is None and pf.staged == 5


@pytest.mark.parametrize("where", ["source", "stage"])
def test_prefetcher_error_comes_after_prior_items(where):
    def src():
        yield 0
        yield 1
        if where == "source":
            raise RuntimeError("boom")
        yield 2

    def stage(i):
        if i == 2:
            raise RuntimeError("boom")
        return i

    got = []
    with pytest.raises(RuntimeError, match="boom"):
        for v in DevicePrefetcher(src(), stage, depth=2):
            got.append(v)
    assert got == [0, 1]


def test_prefetcher_runs_ahead_of_consumer():
    staged_next = threading.Event()

    def stage(i):
        if i == 1:
            staged_next.set()
        return i

    it = iter(DevicePrefetcher(iter(range(4)), stage, depth=2))
    assert next(it) == 0
    assert staged_next.wait(timeout=10.0)
    assert list(it) == [1, 2, 3]


def test_prefetcher_close_unblocks_full_queue():
    pf = DevicePrefetcher(iter(range(100)), None, depth=1)
    it = iter(pf)
    assert next(it) == 0
    pf.close()
    pf.thread.join(timeout=5.0)
    assert not pf.thread.is_alive()
    pf.close()  # idempotent


def test_prefetcher_early_exit_joins_producer():
    pf = DevicePrefetcher(iter(range(100)), None, depth=2)
    for _ in pf:
        break  # the generator's finally closes the prefetcher
    pf.thread.join(timeout=5.0)
    assert not pf.thread.is_alive()


def test_stage_to_device_stacks_and_counts_bytes():
    batches = [([_arr(i)], [_arr(10 + i, rows=B)[:, :1]]) for i in range(3)]
    g = stage_to_device(batches, torch.device("cpu"), torch.float64)
    assert g.n == 3 and g.ready is None
    assert g.xs[0].dtype == torch.float64 and g.xs[0].shape == (3, B, 2)
    assert g.ys[0].dtype == torch.float32 and g.ys[0].shape == (3, B, 1)
    assert g.xs[0][2, 0, 0] == 2 and g.ys[0][1, 0, 0] == 11
    pf = DevicePrefetcher([g], None, depth=0)
    list(pf)
    assert pf.bytes == 3 * B * 2 * 8 + 3 * B * 4


def test_copy_into_copies_in_place():
    dst = [{"W": {"v": torch.zeros(2)}}, {}]
    keep = dst[0]["W"]["v"]
    copy_into(dst, [{"W": {"v": torch.ones(2)}}, {}])
    assert dst[0]["W"]["v"] is keep and torch.equal(keep, torch.ones(2))


# ------------------------------------------------------------ the networks
def _mln_data(rng, rows, masked):
    x = (0.5 * rng.standard_normal((rows, 784))).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, rows)]
    m = (rng.integers(0, 2, rows) | np.eye(rows, dtype=np.int64)[0]
         ).astype(np.float32) if masked else None
    return x, y, m


def _graph_data(rng, rows, masked):
    img = rng.standard_normal((rows, 4, 4, 2)).astype(np.float32)
    feat = rng.standard_normal((rows, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, rows)]
    m = (rng.integers(0, 2, rows) | np.eye(rows, dtype=np.int64)[0]
         ).astype(np.float32) if masked else None
    return [img, feat], [y], m


#: the epochs: rows a batch, and which batch carries a label mask
EPOCHS = {"plain": ([B] * 6, ()),
          "ragged": ([B] * 8 + [5, 5], ()),
          "masked": ([B] * 7, (2,))}


def _epoch(kind, variant, seed=0):
    """``(port datasets, JAX datasets)`` of one epoch."""
    rows, masked = EPOCHS[variant]
    rng = np.random.default_rng(seed)
    ours, theirs = [], []
    for i, r in enumerate(rows):
        if kind == "mln":
            x, y, m = _mln_data(rng, r, i in masked)
            ours.append(DataSet(x, y, None, m))
            theirs.append(JDataSet(x, y, None, m))
        else:
            xs, ys, m = _graph_data(rng, r, i in masked)
            lm = None if m is None else [m]
            ours.append(MultiDataSet(xs, ys, None, lm))
            theirs.append(JMDS(xs, ys, None, lm))
    return ours, theirs


def _jax_conf(kind):
    return jax_lenet() if kind == "mln" else _merge_graph("jax")


class _Scores:
    """Records each iteration and its score, as listeners see them."""

    def __init__(self):
        self.seen = []

    def iteration_done(self, model, iteration):
        self.seen.append((iteration, float(model.score_value)))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np(v) for v in tree]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's K-step runs from its own init: ``fit_iterator``
    over each epoch at ``ksteps=3``, and ``fit(x, y, epochs=5)`` on one
    batch (``dispatch_ksteps`` 8, so one group of 5)."""
    out = {}
    for kind in ("mln", "graph"):
        for variant in list(EPOCHS) + ["repeat"]:
            # a cache of its own: the JAX package fails to run an
            # executable it reloads from its cache on the CPU (ROADMAP.md)
            with compile_cache_at(tmp_path_factory.mktemp("xcache")):
                conf = _jax_conf(kind)
                jnet = (JNet(conf) if kind == "mln" else JGraph(conf)).init()
                p0 = _np(jnet.params_list)
                scores = _Scores()
                jnet.set_listeners(scores)
                if variant == "repeat":
                    _, theirs = _epoch(kind, "plain")
                    ds = theirs[0]
                    if kind == "mln":
                        jnet.fit(ds.features, ds.labels, epochs=5)
                    else:
                        jnet.fit(ds, epochs=5)
                else:
                    jnet.fit_iterator(_epoch(kind, variant)[1], ksteps=3)
                out[kind, variant] = {
                    "p0": p0, "params": _np(jnet.params_list),
                    "scores": scores.seen, "iteration": jnet.iteration}
    return out


def _port(kind, p0):
    return from_jax(_jax_conf(kind).to_json(), p0, device="cpu")


def _assert_params_close(net, want):
    got = to_numpy(net.params_list)
    items = (zip(got, want) if isinstance(want, list)
             else ((got[n], want[n]) for n in want))
    for g, w in items:
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL)


def _fit_epoch(net, datasets, ksteps, depth=2):
    net.prefetch_depth = depth
    scores = _Scores()
    net.set_listeners(scores)
    net.fit_iterator(ListDataSetIterator(datasets), ksteps=ksteps)
    return scores.seen


@pytest.mark.parametrize("variant", list(EPOCHS))
@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_fit_iterator_ksteps_matches_jax(jax_runs, kind, variant):
    ref = jax_runs[kind, variant]
    net = _port(kind, ref["p0"])
    seen = _fit_epoch(net, _epoch(kind, variant)[0], ksteps=3)
    assert [i for i, _ in seen] == [i for i, _ in ref["scores"]] \
        == list(range(1, len(EPOCHS[variant][0]) + 1))
    np.testing.assert_allclose([s for _, s in seen],
                               [s for _, s in ref["scores"]], rtol=RTOL)
    _assert_params_close(net, ref["params"])
    assert net.iteration == ref["iteration"] and net.epoch == 1


@pytest.mark.parametrize("variant", list(EPOCHS))
@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_fit_iterator_ksteps_is_bitwise_single_steps(jax_runs, kind,
                                                     variant):
    """On the CPU the groups run the single step: the same params, scores
    and iterations as ``ksteps=1``, and the groups of two or more did run
    as groups (the ragged tail too; a group of one takes a single step)."""
    p0 = jax_runs[kind, variant]["p0"]
    datasets = _epoch(kind, variant)[0]
    a, b = _port(kind, p0), _port(kind, p0)
    groups = []
    a._run_group = lambda steps, f=a._run_group: (
        groups.append(len(steps)), f(steps))[1]
    seen_a = _fit_epoch(a, datasets, ksteps=3)
    seen_b = _fit_epoch(b, datasets, ksteps=1)
    assert seen_a == seen_b
    assert torch.equal(a.params(), b.params())
    assert a.iteration == b.iteration == len(datasets)
    assert groups == {"plain": [3, 3], "ragged": [3, 3, 2, 2],
                      "masked": [2, 3]}[variant]


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_prefetch_depth_zero_and_two_agree(jax_runs, kind):
    p0 = jax_runs[kind, "ragged"]["p0"]
    datasets = _epoch(kind, "ragged")[0]
    a, b = _port(kind, p0), _port(kind, p0)
    seen_a = _fit_epoch(a, datasets, ksteps=3, depth=0)
    seen_b = _fit_epoch(b, datasets, ksteps=3, depth=2)
    assert seen_a == seen_b and torch.equal(a.params(), b.params())
    assert a.prefetcher.thread is None and b.prefetcher.thread is not None
    assert a.prefetcher.bytes == b.prefetcher.bytes > 0


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_fit_epochs_runs_repeated_groups_as_jax(jax_runs, kind):
    """``fit(x, y, epochs=5)`` takes ``_fit_repeated`` (one group of 5) and
    matches the JAX one and the port's single steps bitwise. (On another
    batch, seed 5, the LeNet runs part at step 2 by 6.9e-5 on conv1's W in
    single steps of both packages too: a near-tie within rounding resolves
    differently, not the dispatch.)"""
    ref = jax_runs[kind, "repeat"]
    ds = _epoch(kind, "plain")[0][0]
    nets = [_port(kind, ref["p0"]) for _ in range(2)]
    groups = []
    nets[0]._run_group = lambda steps, f=nets[0]._run_group: (
        groups.append(len(steps)), f(steps))[1]
    nets[1].dispatch_ksteps = 1
    seen = []
    for net in nets:
        scores = _Scores()
        net.set_listeners(scores)
        if kind == "mln":
            net.fit(ds.features, ds.labels, epochs=5)
        else:
            net.fit(ds, epochs=5)
        seen.append(scores.seen)
    assert groups == [5] and seen[0] == seen[1]
    assert torch.equal(nets[0].params(), nets[1].params())
    np.testing.assert_allclose([s for _, s in seen[0]],
                               [s for _, s in ref["scores"]], rtol=RTOL)
    _assert_params_close(nets[0], ref["params"])
    assert nets[0].iteration == ref["iteration"] == 5


def _mln_conf_json(**global_fields):
    import json
    d = json.loads(jax_lenet().to_json())
    d["global_conf"].update(global_fields)
    return json.dumps(d)


@pytest.mark.parametrize("case", ["iterations", "dropout", "ksteps1"])
def test_ineligible_networks_take_single_steps(jax_runs, case):
    """``iterations > 1``, dropout (a captured step would repeat its mask)
    and ``ksteps = 1`` never reach the K-step group path."""
    p0 = jax_runs["mln", "plain"]["p0"]
    conf = {"iterations": _mln_conf_json(iterations=2),
            "dropout": _mln_conf_json(), "ksteps1": _mln_conf_json()}[case]
    net = from_jax(conf, p0, device="cpu")
    if case == "dropout":
        net.layers[4].dropout = 0.5
        assert net.layers[4].uses_dropout()
    if case == "ksteps1":
        net.dispatch_ksteps = 1
    net._run_group = None  # any group would fail here
    datasets = _epoch("mln", "plain")[0]
    _fit_epoch(net, datasets, ksteps=1 if case == "ksteps1" else 3)
    assert net.iteration == len(datasets) * (2 if case == "iterations"
                                              else 1)
    net.fit(datasets[0].features, datasets[0].labels, epochs=2)


def test_tbptt_graph_takes_single_steps():
    from test_torch_graph_rnn import _rnn_graph
    net = _rnn_graph("port", tbptt=True).init()
    net._run_group = None
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 10, 3)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (4, 10))]
    net.fit_iterator([MultiDataSet([x], [y])] * 2, ksteps=3)
    assert net.iteration == 2 * 2  # two batches, two chunks of 5 each


def test_listeners_see_each_iteration_once_with_its_score(jax_runs):
    """Across a group the listeners run once an iteration, after the group,
    each reading that iteration's own loss."""
    p0 = jax_runs["mln", "plain"]["p0"]
    datasets = _epoch("mln", "plain")[0]
    net = _port("mln", p0)
    seen = _fit_epoch(net, datasets, ksteps=3)
    single = _port("mln", p0)
    losses = []
    for ds in datasets:
        single.fit(ds)
        losses.append(single.score_value)
    assert seen == list(zip(range(1, 7), losses))
    assert len(set(losses)) == 6


@pytest.mark.parametrize("call", ["set_params", "load_params", "load_state",
                                  "load_updater_state"])
@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_replacing_params_drops_captured_steps(jax_runs, kind, call):
    """After a K-step group, a call that replaces the params, the layer
    state or the updater state drops the cached captured steps (on the card
    they would read stale values), and training goes on as a twin's."""
    p0 = jax_runs[kind, "plain"]["p0"]
    datasets = _epoch(kind, "plain")[0]
    a, b = _port(kind, p0), _port(kind, p0)
    _fit_epoch(a, datasets, ksteps=3)
    _fit_epoch(b, datasets, ksteps=1)
    a._step_graphs["sentinel"] = object()
    fresh = _port(kind, p0)
    for net in (a, b):
        if call == "set_params":
            net.set_params(fresh.params())
        elif call == "load_params":
            net.load_params(to_numpy(fresh.params_list))
        elif call == "load_state":
            net.load_state(to_numpy(fresh.state_list))
        else:
            net.load_updater_state(to_numpy(fresh.updater_state), 0)
    assert a._step_graphs == {}
    _fit_epoch(a, datasets, ksteps=3)
    _fit_epoch(b, datasets, ksteps=1)
    assert torch.equal(a.params(), b.params())


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_dispatch_multistep_stages_inline(jax_runs, kind):
    """A pre-built group staged inline (the path for callers that group
    batches themselves) equals single steps; a group of one is a single
    step and an empty one does nothing."""
    p0 = jax_runs[kind, "plain"]["p0"]
    datasets = _epoch(kind, "plain")[0][:4]
    a, b = _port(kind, p0), _port(kind, p0)
    arrays = [a._group_arrays(ds) for ds in datasets]
    for group in (arrays[:3], arrays[3:], []):
        a._dispatch_multistep(group)
    for ds in datasets:
        b.fit(ds)
    assert torch.equal(a.params(), b.params())
    assert a.iteration == b.iteration == 4


# ------------------------------------------------------------ stage_dtype
@pytest.fixture(scope="module")
def jax_staged(tmp_path_factory):
    """The JAX K-step runs with ``stage_dtype`` bfloat16: ``fit_iterator``
    over the plain epoch at ``ksteps=3``, and ``fit(epochs=5)`` on its first
    batch."""
    import jax.numpy as jnp

    out = {}
    for kind in ("mln", "graph"):
        for path in ("fit_iterator", "fit_epochs"):
            with compile_cache_at(tmp_path_factory.mktemp("xcache")):
                conf = _jax_conf(kind)
                jnet = (JNet(conf) if kind == "mln" else JGraph(conf)).init()
                jnet.stage_dtype = jnp.bfloat16
                p0 = _np(jnet.params_list)
                scores = _Scores()
                jnet.set_listeners(scores)
                theirs = _epoch(kind, "plain")[1]
                if path == "fit_iterator":
                    jnet.fit_iterator(theirs, ksteps=3)
                elif kind == "mln":
                    jnet.fit(theirs[0].features, theirs[0].labels, epochs=5)
                else:
                    jnet.fit(theirs[0], epochs=5)
                out[kind, path] = {"p0": p0, "params": _np(jnet.params_list),
                                   "scores": scores.seen}
    return out


def _fit_path(net, kind, path):
    ours = _epoch(kind, "plain")[0]
    if path == "fit_iterator":
        return _fit_epoch(net, ours, ksteps=3)
    scores = _Scores()
    net.set_listeners(scores)
    if kind == "mln":
        net.fit(ours[0].features, ours[0].labels, epochs=5)
    else:
        net.fit(ours[0], epochs=5)
    return scores.seen


@pytest.mark.parametrize("path", ["fit_iterator", "fit_epochs"])
@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_stage_dtype_matches_jax(jax_staged, kind, path):
    """Features staged in bfloat16 train as the JAX package's do (losses
    within 1e-5 relative, params within 1e-5 a leaf): rounded to bfloat16,
    computed in float32. Unstaged, the losses part from them by more than
    that (about 1e-4 relative here), so the cast did take effect."""
    ref = jax_staged[kind, path]
    net = _port(kind, ref["p0"])
    net.stage_dtype = torch.bfloat16
    seen = _fit_path(net, kind, path)
    np.testing.assert_allclose([s for _, s in seen],
                               [s for _, s in ref["scores"]], rtol=RTOL)
    _assert_params_close(net, ref["params"])
    plain = [s for _, s in _fit_path(_port(kind, ref["p0"]), kind, path)]
    assert not np.allclose(plain, [s for _, s in seen], rtol=RTOL, atol=0)


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_stage_dtype_casts_on_the_host(jax_runs, kind):
    """The cast to ``stage_dtype`` comes before the copy to the device, on
    every K-step path: the prefetcher stages half the feature bytes, and
    ``fit(epochs=k)`` hands the device copy bfloat16 host tensors. The run
    equals, bitwise, single steps on features rounded to bfloat16 first."""
    p0 = jax_runs[kind, "plain"]["p0"]
    datasets = _epoch(kind, "plain")[0]
    staged, plain = _port(kind, p0), _port(kind, p0)
    staged.stage_dtype = torch.bfloat16
    seen = _fit_epoch(staged, datasets, ksteps=3)
    _fit_epoch(plain, datasets, ksteps=3)
    feats = sum(a.nbytes for ds in datasets
                for a in staged._group_arrays(ds)[0])
    assert plain.prefetcher.bytes - staged.prefetcher.bytes == feats // 2

    def rounded(a):
        return torch.from_numpy(a).to(torch.bfloat16).float().numpy()

    single = _port(kind, p0)
    for ds in datasets:
        xs, ys = single._group_arrays(ds)
        single._fit_arrays([rounded(a) for a in xs], ys)
    assert torch.equal(staged.params(), single.params())
    assert seen[-1][1] == single.score_value

    copied = []
    to_device = staged._to_device
    staged._to_device = lambda a: (copied.append(a.dtype), to_device(a))[1]
    _fit_path(staged, kind, "fit_epochs")
    n_in = len(staged._group_arrays(datasets[0])[0])
    assert copied[:n_in] == [torch.bfloat16] * n_in
