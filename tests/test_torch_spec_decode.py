"""Speculative decoding, the draft link and the registry API of the port,
held against the JAX package.

Mirrors ``tests/test_paged_decode.py``'s spec cases: the JAX package's small
``transformer_lm`` (vocabulary 24) decodes a seeded session mix through a
plain engine and a spec engine at a fixed capacity of 4 slots, with an
identical draft, a partial-acceptance draft (width 16, seed 9) and a
sign-flipped draft, on dense and paged KV, float32 and int8. Weights cross
only through ``convert.from_jax``. In the port the spec tokens must equal
the plain greedy tokens exactly. Between packages each stream is compared
up to its first near-tie: a token whose JAX top-2 probabilities differ by
under 1e-5 (float32 sums in another order may flip it); the near-ties are
counted and reported, as the MoE tests hold routing.
"""
import http.client
import json

import numpy as np
import pytest

from deeplearning4j_tpu.keras_server.decode import DecodeEngine as JaxEngine
from deeplearning4j_tpu.keras_server.registry import (
    ModelRegistry as JaxRegistry,
)
from deeplearning4j_tpu.models.transformer import transformer_lm as jax_lm
from deeplearning4j_tpu.nn.inference import make_predict_fn as jax_make_pf
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu_torch.convert import from_jax
from deeplearning4j_tpu_torch.keras_server import (
    InferenceServer, ModelRegistry, global_model_registry,
    set_global_model_registry,
)
from deeplearning4j_tpu_torch.keras_server.decode import DecodeEngine
from deeplearning4j_tpu_torch.nn.inference import make_predict_fn

V = 24
#: JAX top-2 probability gap under which a token is a near-tie
TIE = 1e-5
#: the JAX suite's draft kinds: the target's weights, a narrow model of
#: another seed, the target's weights sign-flipped
DRAFTS = ("identical", "partial", "flipped")
#: (kv, quant) of the target
PLANES = (("dense", None), ("paged", None), ("dense", "int8"),
          ("paged", "int8"))


def _jax_net(seed=5, width=32, flip=False):
    net = JaxNet(jax_lm(vocab_size=V, width=width, n_layers=2, n_heads=2,
                        max_len=64, seed=seed)).init()
    if flip:
        net.set_params(-net.params())
    return net


def _port(jnet):
    params = [{k: np.asarray(v) for k, v in p.items()}
              for p in jnet.params_list]
    return from_jax(jnet.conf.to_json(), params, device="cpu")


@pytest.fixture(scope="module")
def nets():
    target = _jax_net()
    drafts = {"identical": _jax_net(), "partial": _jax_net(seed=9, width=16),
              "flipped": _jax_net(flip=True)}
    return {"target": (target, _port(target)),
            **{k: (j, _port(j)) for k, j in drafts.items()}}


def _workload(n=8, seed=17, lo=4, hi=12):
    rng = np.random.default_rng(seed)
    prompts = [list(map(int, rng.integers(0, V, size=int(rng.integers(1, 5)))))
               for _ in range(n)]
    budgets = [int(rng.integers(lo, hi)) for _ in range(n)]
    return prompts, budgets


def _run(eng, prompts, budgets):
    try:
        sessions = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
        for s in sessions:
            s.result(timeout=120)
        return sessions, eng.stats()
    finally:
        eng.close()


def _compare_to_first_tie(ref_sessions, got_tokens):
    """Assert each port stream equals its JAX stream up to the stream's
    first near-tie; return (tokens compared, near-ties met)."""
    compared = ties = 0
    for ref, got in zip(ref_sessions, got_tokens):
        for t, tok in enumerate(ref.tokens):
            top2 = np.sort(np.asarray(ref.probs[t]))[-2:]
            if top2[1] - top2[0] < TIE:
                ties += 1
                break
            assert got[t] == tok, (ref.tokens, got)
            compared += 1
    return compared, ties


@pytest.mark.parametrize("kv,quant", PLANES)
@pytest.mark.parametrize("draft", DRAFTS)
def test_spec_tokens_equal_greedy_and_jax(nets, monkeypatch, draft, kv, quant):
    monkeypatch.setenv("DL4J_INT8_INTERPRET", "1")
    jtarget, target = nets["target"]
    jdraft, tdraft = nets[draft]
    prompts, budgets = _workload()
    opts = dict(max_context=64, min_slots=4, max_slots=4, kv=kv, page_size=8,
                quant=quant)
    plain, _ = _run(DecodeEngine(target, device="cpu", **opts),
                    prompts, budgets)
    spec, st = _run(DecodeEngine(target, device="cpu", draft_net=tdraft,
                                 spec_tokens=3, **opts), prompts, budgets)
    ref, jst = _run(JaxEngine(jtarget, draft_net=jdraft, spec_tokens=3,
                              capture_probs=True, **opts), prompts, budgets)
    # the port's contract: spec tokens are the plain greedy tokens exactly
    assert [s.tokens for s in spec] == [p.tokens for p in plain]
    assert st["last_error"] is None and st["spec_proposed"] > 0
    # the JAX suite's acceptance bounds, on the port's engine
    acc = st["spec_acceptance"]
    if draft == "identical" and quant is None:
        assert acc == 1.0 == jst["spec_acceptance"]
    elif draft == "identical":
        # the float32 draft against the int8 target: close, not equal
        assert 0.5 < acc <= 1.0
    elif draft == "partial":
        assert 0.0 < acc < 1.0
    else:
        assert acc < 0.35
    compared, ties = _compare_to_first_tie(ref, [s.tokens for s in spec])
    print(f"{draft} {kv} {quant}: {compared} tokens equal to JAX's spec "
          f"engine, {ties} near-ties (gap < {TIE})")
    assert compared >= sum(budgets) // 2
    if kv == "paged":
        assert st["pages_in_use"] == 0


def test_spec_refuses_what_jax_refuses(nets):
    _, target = nets["target"]
    _, draft = nets["partial"]
    with pytest.raises(ValueError, match="spec_tokens"):
        DecodeEngine(target, device="cpu", draft_net=draft, spec_tokens=0)
    other = _port(JaxNet(jax_lm(vocab_size=V + 1, width=16, n_layers=1,
                                n_heads=2, max_len=64, seed=2)).init())
    with pytest.raises(ValueError, match="vocab"):
        DecodeEngine(target, device="cpu", draft_net=other)
    from deeplearning4j_tpu.models.char_rnn import char_rnn_lstm
    lstm = _port(JaxNet(char_rnn_lstm(V, hidden=8)).init())
    with pytest.raises(ValueError, match="transformer target"):
        DecodeEngine(lstm, device="cpu", draft_net=draft)
    with pytest.raises(ValueError, match="transformer stack"):
        DecodeEngine(target, device="cpu", draft_net=lstm)


def test_spec_grows_capacity_and_counts_rounds(nets):
    """From one slot to four: the draft's dense blocks grow with the
    target's, each round is one step, and the draft runs spec_tokens steps
    a round."""
    _, target = nets["target"]
    _, draft = nets["identical"]
    prompts, budgets = _workload(n=6, seed=3)
    spec, st = _run(DecodeEngine(target, device="cpu", max_context=64,
                                 min_slots=1, max_slots=4, draft_net=draft,
                                 spec_tokens=2), prompts, budgets)
    assert st["capacity"] == 4 and st["buckets"][0] == 1
    assert st["draft_steps"] == 2 * st["steps"]
    assert st["spec_acceptance"] == 1.0
    assert all(len(s.tokens) == b for s, b in zip(spec, budgets))


# --------------------------------------------------------- registry + draft
def _lm_ids(rows=2, seed=0):
    return np.random.default_rng(seed).integers(0, V, size=(rows, 6)) \
        .astype(np.float32)


def test_link_draft_refusals_match_jax(nets):
    _, target = nets["target"]
    jtarget, _ = nets["target"]
    for reg, net in ((ModelRegistry(), target), (JaxRegistry(), jtarget)):
        kw = {"device": "cpu"} if isinstance(reg, ModelRegistry) else {}
        reg.register("lm", net, **kw)
        with pytest.raises(KeyError, match="not registered"):
            reg.link_draft("lm", "nope")
        with pytest.raises(ValueError, match="own spec-decode draft"):
            reg.link_draft("lm", "lm")
        assert reg.draft_of("lm") is None
        reg.register("d", net, draft_for="lm", **kw)
        assert reg.draft_of("lm") == "d"
        assert reg.status()["drafts"] == {"lm": "d"}


def test_draft_hot_swap_retires_engine_and_generate_equals_plain(nets):
    _, target = nets["target"]
    _, partial = nets["partial"]
    _, identical = nets["identical"]
    srv = InferenceServer(device="cpu", decode_kv="paged", decode_page_size=8,
                          decode_max_context=64, decode_min_slots=4,
                          decode_max_slots=4).start()
    try:
        srv.register("lm", target, quant="int8")
        srv.registry.register("d", partial, device="cpu", draft_for="lm")
        eng1 = srv.decoder("lm")
        assert eng1.spec_tokens == 3 and eng1.stats()["spec_tokens"] == 3
        prompt = [3, 9, 1, 4, 4]
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=120)
        conn.request("POST", "/v1/generate", json.dumps(
            {"model": "lm", "prompt": prompt, "max_new_tokens": 7}),
            {"Content-Type": "application/json"})
        lines = [json.loads(l) for l in
                 conn.getresponse().read().decode().splitlines()]
        conn.close()
        tokens = lines[-1]["tokens"]
        assert [l["token"] for l in lines[:-1]] == tokens
        assert "lm@v1+draft@v1" in srv.status()["decode"]
        # a hot swap of the draft retires the idle engine of the old pair
        srv.registry.register("d", identical, device="cpu")
        eng2 = srv.decoder("lm")
        assert eng2 is not eng1 and eng1._closed
        assert list(srv.status()["decode"]) == ["lm@v1+draft@v2"]
    finally:
        srv.stop()
    plain = DecodeEngine(target, device="cpu", max_context=64, quant="int8",
                         kv="paged", page_size=8, min_slots=4, max_slots=4)
    try:
        assert plain.submit(prompt, 7).result(timeout=120) == tokens
    finally:
        plain.close()


def test_server_spec_draft_option(nets):
    _, target = nets["target"]
    _, draft = nets["identical"]
    srv = InferenceServer(device="cpu", decode_max_context=64,
                          decode_spec_draft="d", decode_spec_tokens=2)
    try:
        srv.register("lm", target)
        srv.register("d", draft)
        eng = srv.decoder("lm")
        assert eng.spec_tokens == 2
        out = eng.submit([1, 2, 3], 5).result(timeout=120)
        assert eng.stats()["spec_acceptance"] == 1.0 and len(out) == 5
    finally:
        srv.stop()


def test_get_set_active_rollback_names_and_global(nets):
    jtarget, target = nets["target"]
    _, other = nets["flipped"]
    reg = ModelRegistry()
    v1 = reg.register("lm", target, device="cpu")
    v2 = reg.register("lm", other, device="cpu")
    reg.register("aaa", target, device="cpu")
    assert reg.names() == ["aaa", "lm"]
    assert reg.active("lm") is v2 and reg.get("lm", "v1") is v1
    x = _lm_ids()
    assert not np.array_equal(reg.active("lm").predict_fn(x).numpy(),
                              v1.predict_fn(x).numpy())
    assert reg.set_active("lm", "v1") is v1
    assert reg.active("lm") is v1 and reg.status()["models"]["lm"][
        "active"] == "v1"
    np.testing.assert_allclose(reg.active("lm").predict_fn(x).numpy(),
                               np.asarray(jtarget.output(x)), rtol=0,
                               atol=1e-5)
    with pytest.raises(KeyError):
        reg.set_active("lm", "v9")
    with pytest.raises(KeyError):
        reg.get("nope", "v1")
    prev = set_global_model_registry(reg)
    try:
        assert global_model_registry() is reg
    finally:
        assert set_global_model_registry(prev) is reg


@pytest.mark.parametrize("version,quant,replica", [
    (None, None, None), ("v2", None, None), (None, "int8", None),
    ("v3", "int8", 0), (None, None, 7), ("v1", "bf16", 2)])
def test_make_predict_fn_names_equal_jax(nets, version, quant, replica):
    jtarget, target = nets["target"]
    jpf = jax_make_pf(jtarget, version=version, quant=quant, replica=replica)
    pf = make_predict_fn(target, version=version, quant=quant,
                         replica=replica, device="cpu")
    assert pf.name == jpf.name
    assert pf.quant == jpf.quant and pf.n_inputs == jpf.n_inputs == 1
    x = _lm_ids(seed=3)
    np.testing.assert_allclose(pf(x).numpy(), np.asarray(jpf(x)), rtol=0,
                               atol=2e-5 if quant == "int8" else 1e-5)
