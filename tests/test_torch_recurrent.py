"""The port's recurrent layers and truncated-BPTT training held against the
JAX package.

- ``LSTM``, ``GravesLSTM`` and ``GravesBidirectionalLSTM`` (weights through
  ``convert.from_jax``) against the JAX ``apply``, with a ragged mask:
  atol 1e-5 (float32; the JAX CPU path runs its fused scan, the port the
  kernels' plain versions).
- TBPTT ``fit`` of a small ``char_rnn_lstm`` (vocab 8, hidden 8, T = 12,
  chunks of 4, RMSProp) against JAX ``fit``: the loss of every chunk at rtol
  1e-5, and the final params, RMSProp state and ``iteration`` at atol 1e-5,
  with feature and label masks sliced per chunk and a ``bias_learning_rate``
  that the TBPTT step must ignore, as JAX's does.
- ``rnn_time_step`` against JAX's and against the full-sequence forward; the
  previous-state accessors; ``clone`` copies and never aliases.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import LossRecorder, compile_cache_at, jax_train
from deeplearning4j_tpu.models.char_rnn import char_rnn_lstm as jax_char_rnn
from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu.nn.conf.layers import (
    LSTM as JaxLSTM, GravesBidirectionalLSTM as JaxBiLSTM,
    GravesLSTM as JaxGravesLSTM, RnnOutputLayer as JaxRnnOutput,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNetwork
from deeplearning4j_tpu_torch.convert import from_jax, to_numpy
from deeplearning4j_tpu_torch.models import char_rnn_lstm
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

TOL = 1e-5
V, HID, T, B, CHUNK = 8, 8, 12, 3, 4


def _np_params(net):
    return [{k: np.asarray(v) for k, v in p.items()} for p in net.params_list]


def _jax_net(conf, cache):
    with compile_cache_at(cache):
        return JaxNetwork(conf).init()


LAYERS = {"LSTM": JaxLSTM, "GravesLSTM": JaxGravesLSTM,
          "GravesBidirectionalLSTM": JaxBiLSTM}


@pytest.mark.parametrize("kind", sorted(LAYERS))
def test_layer_apply_matches_jax(kind, tmp_path):
    conf = (NeuralNetConfiguration.builder().seed(4).list()
            .layer(LAYERS[kind](n_in=5, n_out=6, activation="tanh"))
            .layer(JaxRnnOutput(n_in=6, n_out=4, activation="softmax"))
            .build())
    jnet = _jax_net(conf, tmp_path)
    params = _np_params(jnet)
    if kind == "LSTM":
        assert sorted(params[0]) == ["RW", "W", "b"]
    elif kind == "GravesBidirectionalLSTM":
        assert sorted(params[0]) == sorted(
            f"{d}{k}" for d in "FB" for k in ("W", "RW", "b", "pI", "pF", "pO"))
    # perturb the zero-initialised peepholes so they matter
    rng = np.random.default_rng(0)
    for k in params[0]:
        if "p" in k:
            params[0][k] = rng.standard_normal(params[0][k].shape).astype(
                np.float32) * 0.3
    jnet.params_list[0] = {k: jnp.asarray(v) for k, v in params[0].items()}
    tnet = from_jax(conf.to_json(), params, device="cpu")
    x = rng.standard_normal((B, 7, 5)).astype(np.float32)
    mask = (rng.random((B, 7)) > 0.3).astype(np.float32)
    mask[0] = 1.0
    ref, _ = conf.layers[0].apply({k: jnp.asarray(v) for k, v in
                                   params[0].items()}, {}, jnp.asarray(x),
                                  mask=jnp.asarray(mask))
    got = tnet.layers[0].apply(tnet.params_list[0], torch.from_numpy(x),
                               torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0,
                               atol=TOL)
    # the whole network's forward too (no mask)
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), rtol=0, atol=TOL)


def test_port_char_rnn_config_matches_jax_and_initialises():
    for args in [dict(vocab_size=64), dict(vocab_size=8, hidden=8, layers=3,
                                           tbptt_length=4, seed=7,
                                           learning_rate=0.01)]:
        assert json.loads(char_rnn_lstm(**args).to_json()) == \
            json.loads(jax_char_rnn(**args).to_json())
    net = MultiLayerNetwork(char_rnn_lstm(V, hidden=HID), device="cpu").init()
    b = net.params_list[0]["b"].detach()
    assert torch.equal(b[HID:2 * HID], torch.ones(HID))  # forget gate bias
    assert float(b[:HID].abs().sum()) == 0.0
    p = {k: v.detach() for k, v in net.params_list[0].items()}
    assert float(p["pI"].abs().sum()) == 0.0
    assert float(p["RW"].abs().sum()) > 0.0


def _tbptt_conf(bias_lr=None):
    d = json.loads(jax_char_rnn(V, hidden=HID, layers=2, tbptt_length=CHUNK,
                                seed=11, learning_rate=0.05).to_json())
    if bias_lr is not None:
        for layer in d["layers"]:
            layer["bias_learning_rate"] = bias_lr
    return json.dumps(d)


def _tbptt_batches(masked):
    rng = np.random.default_rng(1)
    out = []
    for _ in range(2):
        ids = rng.integers(0, V, size=(B, T))
        x = np.eye(V, dtype=np.float32)[ids]
        y = np.eye(V, dtype=np.float32)[np.roll(ids, -1, axis=1)]
        fm = lm = None
        if masked:
            fm = np.ones((B, T), np.float32)
            fm[1, 7:] = 0.0  # ragged: ends inside the second chunk
            fm[2, 2:6] = 0.0
            lm = fm.copy()
            lm[0, 0] = 0.0
        out.append((x, y, fm, lm))
    return out


@pytest.mark.parametrize("masked", [False, True])
def test_tbptt_fit_matches_jax_chunk_by_chunk(masked, tmp_path):
    conf_json = _tbptt_conf(bias_lr=0.5)
    batches = _tbptt_batches(masked)
    ref = jax_train(conf_json, batches, tmp_path)
    net = from_jax(conf_json, ref["params0"], device="cpu")
    losses = []
    net.set_listeners(LossRecorder(losses))
    for x, y, fm, lm in batches:
        net.fit(x, y, fmask=fm, lmask=lm)
    assert net.iteration == ref["iteration"] == 2 * (T // CHUNK)
    np.testing.assert_allclose(losses, ref["iter_losses"], rtol=1e-5, atol=0)
    for got, want in zip(to_numpy(net.params_list), ref["params"]):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL,
                                       err_msg=k)
    for got, want in zip(to_numpy(net.updater_state), ref["updater_state"]):
        for k in want:
            for slot in want[k]:
                np.testing.assert_allclose(got[k][slot], want[k][slot],
                                           rtol=0, atol=TOL)


def test_tbptt_step_trains_biases_at_the_layer_rate(tmp_path):
    """Pinned JAX behaviour: the TBPTT step ignores ``bias_learning_rate``,
    so a config that sets it trains exactly like one that does not."""
    batches = _tbptt_batches(False)[:1]
    params0 = jax_train(_tbptt_conf(), batches, tmp_path)["params0"]
    out = []
    for bias_lr in (None, 0.5):
        net = from_jax(_tbptt_conf(bias_lr), params0, device="cpu")
        assert net.layers[0].bias_learning_rate == (0.5 if bias_lr else 0.05)
        net.fit(*batches[0][:2])
        out.append(to_numpy(net.params_list))
    for a, b in zip(*out):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_rnn_time_step_matches_jax_and_full_sequence(tmp_path):
    conf = jax_char_rnn(V, hidden=HID, layers=2, seed=5)
    jnet = _jax_net(conf, tmp_path)
    params = _np_params(jnet)
    tnet = from_jax(conf.to_json(), params, device="cpu")
    rng = np.random.default_rng(2)
    x = np.eye(V, dtype=np.float32)[rng.integers(0, V, size=(2, 9))]
    with compile_cache_at(tmp_path):
        ref = np.concatenate([np.asarray(jnet.rnn_time_step(x[:, :4])),
                              np.asarray(jnet.rnn_time_step(x[:, 4:]))],
                             axis=1)
    assert tnet.rnn_get_previous_state() is None
    got = torch.cat([tnet.rnn_time_step(x[:, :4]),
                     tnet.rnn_time_step(x[:, 4:])], dim=1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(got.numpy(), tnet.output(x).numpy(), rtol=0,
                               atol=TOL)
    state = tnet.rnn_get_previous_state()
    assert [sorted(s) for s in state] == [["c", "h"], ["c", "h"], []]
    # set/clear: replaying the saved state continues the stream exactly
    nxt = np.eye(V, dtype=np.float32)[[[1], [2]]]
    a = tnet.rnn_time_step(nxt)
    tnet.rnn_set_previous_state(state)
    assert torch.equal(tnet.rnn_time_step(nxt), a)
    tnet.rnn_clear_previous_state()
    assert tnet.rnn_get_previous_state() is None
    fresh = tnet.rnn_time_step(nxt)
    assert torch.allclose(fresh, tnet.output(nxt), atol=TOL)


def test_clone_copies_and_does_not_alias():
    conf = char_rnn_lstm(V, hidden=HID, tbptt_length=CHUNK)
    net = MultiLayerNetwork(conf, device="cpu").init(seed=3)
    x = np.eye(V, dtype=np.float32)[np.random.default_rng(0).integers(
        0, V, size=(B, T))]
    net.fit(x, x)
    net.rnn_time_step(x[:, :2])
    twin = net.clone()
    assert twin.iteration == net.iteration == T // CHUNK
    for a, b in zip(net.params_list, twin.params_list):
        for k in a:
            assert torch.equal(a[k], b[k])
            assert a[k].data_ptr() != b[k].data_ptr()
    for a, b in zip(net.rnn_get_previous_state(),
                    twin.rnn_get_previous_state()):
        for k in a:
            assert torch.equal(a[k], b[k]) and a[k] is not b[k]
    # the two train on independently and from the same state, identically
    net.fit(x, x)
    twin.fit(x, x)
    assert net.score_value == twin.score_value
    with torch.no_grad():
        twin.params_list[0]["W"].add_(1.0)
    assert not torch.equal(net.params_list[0]["W"], twin.params_list[0]["W"])
    assert MultiLayerConfiguration.from_json(twin.conf.to_json()).to_json() \
        == conf.to_json()
