"""Truncated BPTT and streaming on the port's ``ComputationGraph``, held
against the JAX package on the CPU.

Weights cross by ``convert.from_jax``. Tolerances (float32, sums in another
order): each TBPTT chunk's loss within 1e-5 relative and the params after
the chunks within atol 1e-5 + rtol 1e-5 a leaf; ``rnn_time_step`` outputs
within atol 1e-5 of the JAX ones and of the port's own full-sequence
``output``; ``/v1/stream`` over a graph within atol 1e-5 of the CPU
``rnn_time_step``. The graphs: the one-LSTM graph of the JAX
``test_graph_tbptt_runs_and_learns`` (GravesLSTM(8), TBPTT 5) and a graph
of char_rnn's structure at narrow width (2 x GravesLSTM(12) and an
``RnnOutput`` over 10 symbols, mcxent, RMSProp 0.95 at 0.01, TBPTT 4).
"""
import http.client
import json

import numpy as np
import pytest
import torch

from _torch_port import compile_cache_at
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.graph_network import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.graph_network import MultiDataSet as JMDS
from deeplearning4j_tpu_torch.convert import from_jax, to_numpy
from deeplearning4j_tpu_torch.keras_server import InferenceServer
from deeplearning4j_tpu_torch.keras_server import ModelRegistry, StreamSessions
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.graph_network import (
    ComputationGraph, MultiDataSet)

ATOL = RTOL = 1e-5
V = 10


def _rnn_graph(pkg, tbptt=True, char=False):
    """The JAX ``test_graph_tbptt_runs_and_learns`` graph, or with ``char``
    two GravesLSTM(12) and a softmax head over ``V`` symbols (char_rnn's
    structure, narrow); ``pkg`` "jax" gives the JAX conf, "port" the port's
    network on the CPU."""
    jax_side = pkg == "jax"
    L = JL if jax_side else TL

    def layer(cls, **kw):
        return getattr(L, cls)(**kw) if jax_side else getattr(L, cls).conf(**kw)

    nnc = (JNNC if jax_side else NeuralNetConfiguration).builder()
    if char:
        g = (nnc.seed(12345).learning_rate(0.01).updater("rmsprop")
             .rms_decay(0.95).weight_init("xavier").graph_builder()
             .add_inputs("in"))
        lstm = dict(activation="tanh", forget_gate_bias_init=1.0,
                    gate_activation="sigmoid")
        g = (g.add_layer("l0", layer("GravesLSTM", n_in=V, n_out=12, **lstm),
                         "in")
             .add_layer("l1", layer("GravesLSTM", n_in=12, n_out=12, **lstm),
                        "l0")
             .add_layer("out", layer("RnnOutputLayer", n_in=12, n_out=V,
                                     loss="mcxent", activation="softmax"),
                        "l1"))
        length = 4
    else:
        g = (nnc.seed(5).learning_rate(0.05).graph_builder().add_inputs("in")
             .add_layer("lstm", layer("GravesLSTM", n_in=3, n_out=8,
                                      activation="tanh"), "in")
             .add_layer("out", layer("RnnOutputLayer", n_in=8, n_out=3,
                                     loss="mcxent", activation="softmax"),
                        "lstm"))
        length = 5
    g = g.set_outputs("out")
    if tbptt:
        g = g.backprop_type("TruncatedBPTT").t_bptt_forward_length(length)
    conf = g.build()
    return conf if jax_side else ComputationGraph(conf, device="cpu")


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _tbptt_data(char, masked, seed=0):
    """``(x, y, fmask, lmask)``: B = 8, T = 20 (the JAX test's shapes) or
    B = 4, T = 16 of one-hot symbols; with ``masked`` rows end early."""
    rng = np.random.default_rng(seed)
    if char:
        ids = rng.integers(0, V, (4, 17))
        x = np.eye(V, dtype=np.float32)[ids[:, :-1]]
        y = np.eye(V, dtype=np.float32)[ids[:, 1:]]
    else:
        x = rng.normal(size=(8, 20, 3)).astype(np.float32)
        y = np.zeros((8, 20, 3), np.float32)
        y[..., 0] = 1
    m = None
    if masked:
        T = x.shape[1]
        lengths = rng.integers(T // 2, T + 1, x.shape[0])
        lengths[0] = T
        m = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    return x, y, m, m


class _Losses:
    def __init__(self):
        self.seen = []

    def iteration_done(self, model, iteration):
        self.seen.append(float(model.score_value))


@pytest.mark.parametrize("graph", ["lstm", "lstm_masked", "char_rnn"])
def test_graph_tbptt_matches_jax(graph, tmp_path):
    """Two ``fit`` calls of 4 chunks each from the same params: each
    chunk's loss and the params after."""
    char, masked = graph == "char_rnn", graph == "lstm_masked"
    x, y, fm, lm = _tbptt_data(char, masked)
    with compile_cache_at(tmp_path):
        jnet = JGraph(_rnn_graph("jax", char=char)).init()
        p0 = _np(jnet.params_list)
        want = _Losses()
        jnet.set_listeners(want)
        for _ in range(2):
            jnet.fit(JMDS([x], [y], None if fm is None else [fm],
                          None if lm is None else [lm]))
        want_params = _np(jnet.params_list)
    net = from_jax(_rnn_graph("jax", char=char).to_json(), p0, device="cpu")
    got = _Losses()
    net.set_listeners(got)
    for _ in range(2):
        net.fit(MultiDataSet([x], [y], None if fm is None else [fm],
                             None if lm is None else [lm]))
    assert net.iteration == jnet.iteration == 8
    np.testing.assert_allclose(got.seen, want.seen, rtol=RTOL)
    assert got.seen[-1] < got.seen[0]
    mine = to_numpy(net.params_list)
    for n, leaves in want_params.items():
        for k, v in leaves.items():
            np.testing.assert_allclose(mine[n][k], v, rtol=RTOL, atol=ATOL)


def test_graph_tbptt_detaches_state_between_chunks():
    """A chunk's gradient does not reach back into the previous chunk: the
    same params trained on chunk 2 alone from chunk 1's carried state (given
    as a constant) take the same step."""
    from deeplearning4j_tpu_torch.nn.graph_network import (
        _init_graph_rnn_states, make_graph_tbptt_step)
    x, y, _, _ = _tbptt_data(False, False)
    a = _rnn_graph("port").init()
    b = a.clone()
    a.fit(MultiDataSet([x[:, :10]], [y[:, :10]]))  # two chunks of 5
    step = make_graph_tbptt_step(b)
    rs = _init_graph_rnn_states(b, 8)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for c in range(2):
        sl = slice(5 * c, 5 * c + 5)
        rs = {n: {k: v.clone() for k, v in s.items()} for n, s in rs.items()}
        _, b.updater_state, rs, _ = step(
            b.params_list, b.state_list, b.updater_state, rs, [xt[:, sl]],
            [yt[:, sl]], None, c)
        assert all(not v.requires_grad for v in rs["lstm"].values())
    assert torch.equal(a.params(), b.params())


@pytest.mark.parametrize("char", [False, True], ids=["lstm", "char_rnn"])
def test_graph_rnn_time_step_matches_jax_and_full_sequence(char, tmp_path):
    """Streamed one step, then three, then the rest: the JAX outputs, and
    the port's own full-sequence ``output``."""
    x = _tbptt_data(char, False, seed=2)[0][:2, :12]
    parts = [x[:, :1], x[:, 1:4], x[:, 4:]]
    with compile_cache_at(tmp_path):
        jnet = JGraph(_rnn_graph("jax", char=char)).init()
        p0 = _np(jnet.params_list)
        want = [np.asarray(jnet.rnn_time_step(p)[0]) for p in parts]
    net = from_jax(_rnn_graph("jax", char=char).to_json(), p0, device="cpu")
    got = [net.rnn_time_step(p) for p in parts]
    assert all(isinstance(g, list) and len(g) == 1 for g in got)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0].numpy(), w, rtol=0, atol=ATOL)
    full = net.output(x)[0].numpy()
    np.testing.assert_allclose(np.concatenate([g[0].numpy() for g in got],
                                              axis=1), full, rtol=0,
                               atol=ATOL)


def test_graph_previous_state_accessors_round_trip():
    x = _tbptt_data(True, False, seed=4)[0][:2, :8]
    net = _rnn_graph("port", char=True).init()
    assert net.rnn_get_previous_state() is None
    net.rnn_time_step(x[:, :5])
    state = net.rnn_get_previous_state()
    assert set(state) == set(net.order)
    assert set(state["l0"]) == {"h", "c"} and state["out"] == {}
    assert tuple(state["l1"]["h"].shape) == (2, 12)
    after = net.rnn_time_step(x[:, 5:])[0]
    # a clone carries the state; a set state continues where it was taken
    other = _rnn_graph("port", char=True)
    other.load_params(to_numpy(net.params_list))
    other.rnn_set_previous_state(to_numpy(state))
    assert torch.equal(other.rnn_time_step(x[:, 5:])[0], after)
    twin = net.clone()
    assert torch.equal(twin.rnn_time_step(x[:, :1])[0],
                       net.rnn_time_step(x[:, :1])[0])
    # clearing restarts the stream
    net.rnn_clear_previous_state()
    assert net.rnn_get_previous_state() is None
    fresh = _rnn_graph("port", char=True)
    fresh.load_params(to_numpy(net.params_list))
    assert torch.equal(net.rnn_time_step(x[:, :3])[0],
                       fresh.rnn_time_step(x[:, :3])[0])


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def test_v1_stream_serves_a_graph():
    """A session streamed in two requests over HTTP equals the CPU
    ``rnn_time_step`` over the whole input; reset drops it."""
    net = _rnn_graph("port", char=True).init()
    x = _tbptt_data(True, False, seed=6)[0][:2, :10]
    ref = net.clone().rnn_time_step(x)[0].numpy()
    srv = InferenceServer(device="cpu").start()
    try:
        srv.register("g", net)
        assert srv.registry.active("g").streaming_capable
        outs = []
        for part in (x[:, :6], x[:, 6:]):
            code, text = _post(srv.port, "/v1/stream",
                               {"model": "g", "session": "s",
                                "inputs": part.tolist()})
            assert code == 200
            lines = [json.loads(l) for l in text.splitlines() if l.strip()]
            assert lines[-1] == {"done": True, "session": "s",
                                 "timesteps": part.shape[1]}
            outs += [np.asarray(l["output"]) for l in lines[:-1]]
        np.testing.assert_allclose(np.stack(outs, axis=1), ref, rtol=0,
                                   atol=ATOL)
        assert srv.status()["streams"] == {"g@v1": ["s"]}
        code, text = _post(srv.port, "/v1/stream/reset",
                           {"model": "g", "session": "s"})
        assert code == 200 and json.loads(text) == {"reset": True}
        assert srv.status()["streams"] == {"g@v1": []}
    finally:
        srv.stop()


def test_stream_sessions_park_a_graph_state_by_vertex():
    """Two sessions on one graph clone: each keeps its own state (a dict by
    vertex), and a reset releases it."""
    reg = ModelRegistry()
    net = _rnn_graph("port", char=True).init()
    reg.register("g", net, device="cpu")
    ss = StreamSessions(reg, device="cpu")
    x = _tbptt_data(True, False, seed=8)[0][:1, :6]
    a1 = ss.step("g", "a", x[:, :3])["output"]
    ss.step("g", "b", x[:, 3:])
    a2 = ss.step("g", "a", x[:, 3:])["output"]
    ref = net.clone()
    np.testing.assert_allclose(np.concatenate([a1, a2], axis=1),
                               ref.rnn_time_step(x)[0].numpy(), rtol=0,
                               atol=ATOL)
    sm = next(iter(ss._models.values()))
    parked = sm.states["a"][0]
    assert isinstance(parked, dict) and set(parked["l0"]) == {"h", "c"}
    assert ss.reset("g", "a") and all(s == {} for s in parked.values())
