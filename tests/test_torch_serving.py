"""The port's ``InferenceServer`` on the CPU: ``/v1/generate`` and
``/v1/predict`` over real HTTP give what direct calls give, batching and
padding change no answer, and admission, 404 and status behave."""
import http.client
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from _torch_port import jax_lm
from deeplearning4j_tpu_torch.convert import from_jax
from deeplearning4j_tpu_torch.keras_server import (
    AdmissionController, InferenceServer, RejectedError, batch_bucket,
    normalize_priority,
)
from deeplearning4j_tpu_torch.keras_server.decode import DecodeEngine
from deeplearning4j_tpu_torch.nn.inference import PredictFn


@pytest.fixture(scope="module")
def tnet():
    net, params = jax_lm(vocab=64, width=32, n_layers=2, n_heads=2, seed=5)
    return from_jax(net.conf.to_json(), params, device="cpu")


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read().decode())
    finally:
        conn.close()


@pytest.mark.parametrize("quant", [None, "int8"])
def test_http_generate_and_predict_equal_direct_calls(tnet, quant):
    srv = InferenceServer(device="cpu", decode_kv="paged", decode_page_size=8,
                          decode_max_context=64, decode_max_slots=4).start()
    try:
        srv.register("lm", tnet, quant=quant)
        prompt = [3, 9, 1, 4, 4]
        code, text = _post(srv.port, "/v1/generate",
                           {"model": "lm", "prompt": prompt,
                            "max_new_tokens": 6})
        assert code == 200
        lines = [json.loads(l) for l in text.splitlines()]
        assert [l["token"] for l in lines[:-1]] == lines[-1]["tokens"]
        assert lines[-1]["done"] and lines[-1]["reason"] == "max_tokens"
        ids = np.random.default_rng(0).integers(0, 64, size=(3, 12))
        code, text = _post(srv.port, "/v1/predict",
                           {"model": "lm", "inputs": ids.tolist()})
        assert code == 200
        res = json.loads(text)
        assert res["bucket"] == 4 and res["batched_with"] == 3
        status_code, status = _get(srv.port, "/serve/status")
        assert status_code == 200
        assert status["models"]["lm"]["versions"]["v1"]["quant"] == quant
        assert status["decode"]["lm@v1"]["kv"] == "paged"
        assert _post(srv.port, "/v1/predict",
                     {"model": "nope", "inputs": [[1]]})[0] == 404
        assert _post(srv.port, "/v1/generate", {"model": "lm"})[0] == 400
    finally:
        srv.stop()
    eng = DecodeEngine(tnet, device="cpu", max_context=64, quant=quant)
    try:
        direct = eng.submit(prompt, 6).result(timeout=120)
    finally:
        eng.close()
    assert lines[-1]["tokens"] == direct
    # three rows padded to a bucket of 4 give each row's own answer
    pf = PredictFn(tnet, quant=quant, device="cpu")
    np.testing.assert_array_equal(np.asarray(res["predictions"], np.float32),
                                  pf(ids.astype(np.float32)).numpy())
    for i in range(3):
        np.testing.assert_allclose(
            np.asarray(res["predictions"][i], np.float32),
            pf(ids[i:i + 1].astype(np.float32)).numpy()[0], rtol=0, atol=1e-6)


def test_int8_pin_holds_int8_and_shrinks_params(tnet):
    dense = PredictFn(tnet, device="cpu")
    q = PredictFn(tnet, quant="int8", device="cpu")
    assert dense.param_bytes / q.param_bytes > 2.5
    x = np.random.default_rng(1).integers(0, 64, size=(2, 10)).astype(np.float32)
    drift = np.abs(q(x).numpy() - dense(x).numpy()).mean()
    assert drift <= 2e-2  # the JAX package's documented int8 drift bound
    with pytest.raises(ValueError):
        PredictFn(tnet, quant="int4", device="cpu")


def test_admission_priorities_and_buckets():
    ac = AdmissionController(max_pending=4)
    ac.admit(priority="low")
    ac.admit(priority="low")
    with pytest.raises(RejectedError) as e:
        ac.admit(priority="low")
    assert e.value.shed
    ac.admit(priority="high")
    ac.admit(priority="high")
    with pytest.raises(RejectedError) as e:
        ac.admit(priority="high")
    assert not e.value.shed
    ac.release(4)
    assert ac.pending == 0
    assert normalize_priority(None) == "high" == normalize_priority("bogus")
    assert [batch_bucket(n, 32) for n in (1, 2, 3, 5, 17, 40)] == \
        [1, 2, 4, 8, 32, 32]


def test_chip_smoke_refuses_without_cuda():
    """No card: a non-zero exit and nothing on stdout, so no result line."""
    root = Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=root,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert r.stdout == ""
