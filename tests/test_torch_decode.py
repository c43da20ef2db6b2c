"""The port's ``DecodeEngine`` held against the JAX package's.

The same 128-aligned ``transformer_lm`` (so the JAX int8 Pallas kernel
engages under ``DL4J_INT8_INTERPRET=1``) decodes the same prompts in both
packages, dense and paged KV, float32 and int8, including a shared-prefix
pair whose second session maps the first one's prompt pages copy-on-write
and forks mid-page. Greedy token streams must be equal and per-token
probabilities within atol 1e-5 (float32 sums in another order). Paged and
dense decode in the port must be bitwise equal.
"""
import json
import time

import numpy as np
import pytest

from _torch_port import jax_lm
from deeplearning4j_tpu.keras_server.decode import DecodeEngine as JaxDecodeEngine
from deeplearning4j_tpu.nn.conf.multilayer import (
    MultiLayerConfiguration as JaxConfiguration,
)
from deeplearning4j_tpu_torch.convert import from_jax
from deeplearning4j_tpu_torch.keras_server.decode import DecodeEngine
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration

TOL = 1e-5
PS = 16
#: 20 tokens: the shared pair diverges at 18, mid-way through page 1
SHARED = [5, 17, 33, 2, 99, 64, 8, 127, 1, 45, 45, 3, 77, 12, 0, 6, 90, 31,
          4, 4]
PROMPTS = [[1, 2, 3, 4, 5, 6], [9], [100, 50, 25, 12, 6, 3, 1, 0, 7]]


@pytest.fixture(scope="module")
def lm():
    net, params = jax_lm(vocab=128, width=128, n_layers=2, n_heads=2,
                         max_len=64, seed=3)
    return net, from_jax(net.conf.to_json(), params, device="cpu")


def _decode(eng, budget=8):
    """The shared-prefix pair (B admitted while A is live, so it maps A's
    prompt pages), then three independent prompts concurrently."""
    try:
        a = eng.submit(SHARED, 12)
        deadline = time.time() + 60
        while len(a.tokens) < 2 and time.time() < deadline:
            time.sleep(0.005)
        b = eng.submit(SHARED[:18] + [11, 12], budget)
        rest = [eng.submit(p, budget) for p in PROMPTS]
        sessions = [a, b] + rest
        for s in sessions:
            s.result(timeout=120)
        return sessions, eng.stats()
    finally:
        eng.close()


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_decode_matches_jax(lm, monkeypatch, kv, quant):
    monkeypatch.setenv("DL4J_INT8_INTERPRET", "1")
    jnet, tnet = lm
    opts = dict(max_context=64, min_slots=2, max_slots=8, kv=kv,
                page_size=PS, quant=quant, capture_probs=True)
    ref, _ = _decode(JaxDecodeEngine(jnet, **opts))
    got, st = _decode(DecodeEngine(tnet, device="cpu", **opts))
    for r, g in zip(ref, got):
        assert g.tokens == r.tokens
        assert g.evict_reason == r.evict_reason == "max_tokens"
        np.testing.assert_allclose(np.stack(g.probs), np.stack(r.probs),
                                   rtol=0, atol=TOL)
    assert st["last_error"] is None
    if kv == "paged":
        assert st["prefix_share_ratio"] > 0.0  # the pair really shared pages
        assert st["pages_in_use"] == 0  # every page came back


@pytest.mark.parametrize("quant", [None, "int8"])
def test_paged_bitwise_equals_dense(lm, quant):
    _, tnet = lm
    out = {}
    for kv in ("dense", "paged"):
        out[kv], _ = _decode(DecodeEngine(
            tnet, device="cpu", max_context=64, min_slots=2, max_slots=4,
            kv=kv, page_size=PS, quant=quant, capture_probs=True))
    for d, p in zip(out["dense"], out["paged"]):
        assert d.tokens == p.tokens
        assert all(np.array_equal(x, y) for x, y in zip(d.probs, p.probs))


def test_static_mode_equals_continuous_and_rejects(lm):
    _, tnet = lm
    streams = {}
    for mode in ("continuous", "static"):
        eng = DecodeEngine(tnet, device="cpu", max_context=64, min_slots=2,
                           max_slots=4, mode=mode)
        try:
            sessions = [eng.submit(p, 5) for p in PROMPTS * 2]
            streams[mode] = [s.result(timeout=120) for s in sessions]
        finally:
            eng.close()
    assert streams["continuous"] == streams["static"]
    eng = DecodeEngine(tnet, device="cpu", max_context=32, kv="paged",
                       page_size=PS, n_pages=1)
    try:
        from deeplearning4j_tpu_torch.keras_server import RejectedError
        with pytest.raises(RejectedError):
            eng.submit(list(range(20)), 8)  # can never fit one page
        with pytest.raises(ValueError):
            eng.submit([500], 2)
    finally:
        eng.close()
    # a self-draft engine (the target's own weights proposing) emits the
    # plain engine's tokens, every judged proposal accepted
    eng = DecodeEngine(tnet, device="cpu", max_context=64, min_slots=2,
                       max_slots=4, draft_net=tnet)
    try:
        sessions = [eng.submit(p, 5) for p in PROMPTS * 2]
        spec = [s.result(timeout=120) for s in sessions]
        st = eng.stats()
    finally:
        eng.close()
    assert spec == streams["continuous"]
    assert st["spec_proposed"] > 0 and st["spec_acceptance"] == 1.0


def test_decode_refuses_what_jax_refuses(lm, tmp_path):
    """LSTM stacks decode (``tests/test_torch_streaming.py``); the stacks the
    JAX engine refuses are refused here too: a bidirectional LSTM, paged KV
    with an LSTM, and a mix of LSTM and transformer layers."""
    from _torch_port import compile_cache_at
    from deeplearning4j_tpu.keras_server.decode import (
        DecodeEngine as JaxEngine)
    from deeplearning4j_tpu.models.char_rnn import char_rnn_lstm
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    jnet, tnet = lm
    lstm = json.loads(char_rnn_lstm(128, hidden=8).to_json())
    bi = json.loads(json.dumps(lstm))
    bi["layers"][1]["@type"] = "GravesBidirectionalLSTM"
    mixed = json.loads(jnet.conf.to_json())
    mixed["layers"].insert(1, dict(lstm["layers"][1], n_in=128, n_out=128))
    cases = [(bi, {}, "bidirectional"), (lstm, {"kv": "paged"}, "paged"),
             (mixed, {}, "not a mix")]
    for conf, opts, msg in cases:
        text = json.dumps(conf)
        with compile_cache_at(tmp_path):
            jn = JaxNet(JaxConfiguration.from_json(text)).init()
            with pytest.raises(ValueError, match=msg):
                JaxEngine(jn, **opts)
        net = MultiLayerNetwork(MultiLayerConfiguration.from_json(text),
                                device="cpu").init()
        with pytest.raises(ValueError, match=msg):
            DecodeEngine(net, device="cpu", **opts)
