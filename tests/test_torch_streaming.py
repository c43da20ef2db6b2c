"""The port's LSTM serving paths: LSTM decode and ``/v1/stream``.

- LSTM ``DecodeEngine`` against the JAX package's on the same
  ``char_rnn_lstm`` weights (float32 and int8 at rest): equal greedy token
  streams, per-token probabilities within atol 1e-5 (float32 sums in another
  order); and against the port's own ``rnn_time_step`` oracle (as the JAX
  package's ``tests/test_decode.py`` holds its engine), including a slot that
  is reused after an eviction and must start from zero state.
- ``StreamSessions``: stepping carries state per session, ``reset``, TTL
  eviction that releases the parked state, ``status``.
- ``/v1/stream`` and ``/v1/stream/reset`` over HTTP on the CPU: a session
  streamed in two requests equals JAX ``rnn_time_step`` over the whole input
  (atol 1e-5).
"""
import http.client
import json
import time

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import compile_cache_at
from deeplearning4j_tpu.keras_server.decode import DecodeEngine as JaxDecodeEngine
from deeplearning4j_tpu.models.char_rnn import char_rnn_lstm as jax_char_rnn
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNetwork
from deeplearning4j_tpu_torch.convert import from_jax
from deeplearning4j_tpu_torch.keras_server import (
    DecodeEngine, InferenceServer, ModelRegistry, StreamSessions,
)

V, HID = 16, 24
TOL = 1e-5
PROMPTS = [[3, 9, 1], [5], [0, 15, 7, 7, 2, 11], [4, 4]]


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    conf = jax_char_rnn(V, hidden=HID, layers=2, seed=7)
    with compile_cache_at(tmp_path_factory.mktemp("xcache")):
        jnet = JaxNetwork(conf).init()
    params = [{k: np.asarray(v) for k, v in p.items()}
              for p in jnet.params_list]
    # nonzero peepholes, so the decode path exercises them
    rng = np.random.default_rng(0)
    for i in (0, 1):
        for k in ("pI", "pF", "pO"):
            params[i][k] = (rng.standard_normal(HID) * 0.3).astype(np.float32)
        jnet.params_list[i] = {k: jnp.asarray(v) for k, v in params[i].items()}
    return jnet, from_jax(conf.to_json(), params, device="cpu")


def _one_hot(ids):
    x = np.zeros((1, len(ids), V), np.float32)
    x[0, np.arange(len(ids)), ids] = 1.0
    return x


def _oracle(net, prompt, budget):
    """Greedy tokens by ``rnn_time_step`` from zero state."""
    net.rnn_clear_previous_state()
    out = net.rnn_time_step(_one_hot(prompt))
    toks = []
    for _ in range(budget):
        toks.append(int(np.asarray(out)[0, -1].argmax()))
        out = net.rnn_time_step(_one_hot([toks[-1]]))
    net.rnn_clear_previous_state()
    return toks


def _run(eng, budget=7):
    try:
        sessions = [eng.submit(p, budget) for p in PROMPTS]
        for s in sessions:
            s.result(timeout=120)
        return sessions, eng.stats()
    finally:
        eng.close()


@pytest.mark.parametrize("quant", [None, "int8"])
def test_lstm_decode_matches_jax(nets, quant, tmp_path):
    jnet, tnet = nets
    # a fixed capacity: a JAX engine below max_slots pre-warms the next
    # bucket on a daemon thread that outlives close() and allocates device
    # arrays while later tests in this process measure them
    opts = dict(min_slots=4, max_slots=4, quant=quant, capture_probs=True)
    with compile_cache_at(tmp_path):
        ref, _ = _run(JaxDecodeEngine(jnet, **opts))
    got, st = _run(DecodeEngine(tnet, device="cpu", **opts))
    assert st["kind"] == "lstm" and st["last_error"] is None
    for r, g in zip(ref, got):
        assert g.tokens == r.tokens
        np.testing.assert_allclose(np.stack(g.probs), np.stack(r.probs),
                                   rtol=0, atol=TOL)


def test_lstm_decode_matches_rnn_time_step_and_reuses_slots(nets):
    _, tnet = nets
    # one slot: every session after the first reuses it after an eviction
    eng = DecodeEngine(tnet, device="cpu", min_slots=1, max_slots=1)
    sessions, st = _run(eng, budget=5)
    assert st["capacity"] == 1 and st["evictions"] == len(PROMPTS)
    for prompt, sess in zip(PROMPTS, sessions):
        assert sess.tokens == _oracle(tnet, prompt, 5)
        assert sess.evict_reason == "max_tokens"


def test_stream_sessions_step_reset_ttl_and_status(nets):
    _, tnet = nets
    reg = ModelRegistry()
    reg.register("rnn", tnet, version="v1", device="cpu")
    ss = StreamSessions(reg, ttl_s=300.0, device="cpu")
    x = _one_hot([1, 2, 3, 4, 5, 6])
    a1 = ss.step("rnn", "a", x[:, :3])["output"]
    b1 = ss.step("rnn", "b", x[:, :1])["output"]
    a2 = ss.step("rnn", "a", x[:, 3:])
    assert a2["version"] == "v1" and a2["timesteps"] == 3
    tnet.rnn_clear_previous_state()
    full = tnet.rnn_time_step(x).numpy()
    tnet.rnn_clear_previous_state()
    np.testing.assert_allclose(np.concatenate([a1, a2["output"]], axis=1),
                               full, rtol=0, atol=TOL)
    np.testing.assert_allclose(b1, full[:, :1], rtol=0, atol=TOL)
    assert ss.status() == {"rnn@v1": ["a", "b"]}
    # the clone's live state is session a's parked state: reset un-aliases
    sm = ss._models[("rnn", "v1")]
    parked = sm.states["a"][0]
    assert sm.net.rnn_get_previous_state() is parked
    assert ss.reset("rnn", "a") is True and ss.reset("rnn", "a") is False
    assert sm.net.rnn_get_previous_state() is None
    assert all(not layer for layer in parked)  # its tensors were dropped
    # a reset session starts again from zero state
    np.testing.assert_allclose(ss.step("rnn", "a", x[:, :3])["output"], a1,
                               rtol=0, atol=TOL)
    # TTL: idle sessions go on the next touch
    ss.ttl_s = 0.0
    time.sleep(0.01)
    ss.step("rnn", "c", x[:, :1])
    assert ss.status() == {"rnn@v1": ["c"]}
    with pytest.raises(KeyError):
        ss.step("nope", "a", x)


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def test_v1_stream_over_http_carries_state_across_requests(nets, tmp_path):
    jnet, tnet = nets
    ids = np.random.default_rng(3).integers(0, V, size=(2, 10))
    x = np.eye(V, dtype=np.float32)[ids]
    with compile_cache_at(tmp_path):
        jnet.rnn_clear_previous_state()
        ref = np.asarray(jnet.rnn_time_step(x))
        jnet.rnn_clear_previous_state()
    srv = InferenceServer(device="cpu").start()
    try:
        srv.register("rnn", tnet)
        outs = []
        for part in (x[:, :6], x[:, 6:]):
            code, text = _post(srv.port, "/v1/stream",
                               {"model": "rnn", "session": "s1",
                                "inputs": part.tolist()})
            assert code == 200
            lines = [json.loads(l) for l in text.splitlines() if l.strip()]
            assert lines[-1] == {"done": True, "session": "s1",
                                 "timesteps": part.shape[1]}
            assert [l["t"] for l in lines[:-1]] == list(range(part.shape[1]))
            outs += [np.asarray(l["output"]) for l in lines[:-1]]
        np.testing.assert_allclose(np.stack(outs, axis=1), ref, rtol=0,
                                   atol=TOL)
        assert srv.status()["streams"] == {"rnn@v1": ["s1"]}
        code, text = _post(srv.port, "/v1/stream/reset",
                           {"model": "rnn", "session": "s1"})
        assert code == 200 and json.loads(text) == {"reset": True}
        assert srv.status()["streams"] == {"rnn@v1": []}
        code, _ = _post(srv.port, "/v1/stream",
                        {"model": "nope", "inputs": x[:, :1].tolist()})
        assert code == 404
        code, _ = _post(srv.port, "/v1/stream",
                        {"model": "rnn", "inputs": [1.0, 2.0]})
        assert code == 400
        # /v1/generate serves the same LSTM through the decode engine
        code, text = _post(srv.port, "/v1/generate",
                           {"model": "rnn", "prompt": [3, 9, 1],
                            "max_new_tokens": 4})
        assert code == 200
        done = json.loads(text.splitlines()[-1])
        assert done["tokens"] == _oracle(tnet, [3, 9, 1], 4)
    finally:
        srv.stop()
