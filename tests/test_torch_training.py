"""The port's training path held against ``MultiLayerNetwork.fit`` of the
JAX package, on small ``transformer_lm`` configs (vocab 16, width 16, one or
two blocks of two heads, T = 8, B = 2, one-hot inputs, y = x).

Weights cross only through ``convert.from_jax``. Stated tolerances:
- SGD: losses at rtol 1e-5 and params at rtol 1e-5 (atol 1e-6), step by step;
- Adam: losses at rtol 1e-4 and params after one step within ``2 * lr``
  absolute (``m / (sqrt(v) + eps)`` is close to +-1 for a gradient entry near
  0 in either framework, so a correct port may differ by ``lr`` there);
- everything else (masks, regularization, normalization, iterations,
  continuing from carried updater state): losses at rtol 1e-5, params at
  atol 1e-5.
The JAX reference on the CPU takes its plain XLA path (log-softmax, the
chunked attention backward); the port takes its kernels' plain versions.
"""
import json

import numpy as np
import pytest
import torch

from _torch_port import compile_cache_at, jax_train, lm_conf_json
from deeplearning4j_tpu.models.transformer import transformer_lm as jax_transformer_lm
from deeplearning4j_tpu.nn.conf.multilayer import (
    MultiLayerConfiguration as JaxConfiguration,
)
from deeplearning4j_tpu_torch.convert import from_jax, to_numpy
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.models import transformer_lm
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import (
    MultiLayerNetwork, loss_fn,
)

V, T, B = 16, 8, 2
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-6
ADAM_LOSS_RTOL = 1e-4
OTHER_ATOL = 1e-5


def _batch(seed, lmask=False):
    rng = np.random.default_rng(seed)
    x = np.eye(V, dtype=np.float32)[rng.integers(0, V, (B, T))]
    m = None
    if lmask:
        m = (rng.random((B, T)) > 0.3).astype(np.float32)
        m[1, T // 2:] = 0.0
    return x, x, None, m


def _port(conf_json, jax_run):
    return from_jax(conf_json, jax_run["params0"], device="cpu")


def _assert_params(tnet, params, rtol, atol):
    for own, ref in zip(to_numpy(tnet.params_list), params):
        assert sorted(own) == sorted(ref)
        for k in ref:
            np.testing.assert_allclose(own[k], ref[k], rtol=rtol, atol=atol,
                                       err_msg=k)


def _port_losses(tnet, batches):
    out = []
    for x, y, fmask, lmask in batches:
        tnet.fit(x, y, fmask=fmask, lmask=lmask)
        out.append(tnet.score_value)
    return out


def test_fit_trajectory_matches_jax_sgd(tmp_path):
    conf = lm_conf_json(n_layers=2, learning_rate=0.05,
                        global_fields={"updater": "sgd"},
                        layer_fields={"updater": "sgd"})
    batches = [_batch(s) for s in range(4)]
    ref = jax_train(conf, batches, tmp_path)
    tnet = _port(conf, ref)
    losses = []
    for n, b in enumerate(batches):
        losses += _port_losses(tnet, [b])
        if n == 0:
            _assert_params(tnet, ref["params1"], PARAM_RTOL, PARAM_ATOL)
    np.testing.assert_allclose(losses, ref["losses"], rtol=LOSS_RTOL)
    _assert_params(tnet, ref["params"], PARAM_RTOL, PARAM_ATOL)
    assert losses[-1] < losses[0]
    assert tnet.iteration == ref["iteration"] == 4


def test_fit_trajectory_matches_jax_adam(tmp_path):
    lr = 1e-3
    conf = lm_conf_json(n_layers=2, learning_rate=lr)
    batches = [_batch(s) for s in range(4)]
    ref = jax_train(conf, batches, tmp_path)
    tnet = _port(conf, ref)
    losses = []
    for n, b in enumerate(batches):
        losses += _port_losses(tnet, [b])
        if n == 0:
            _assert_params(tnet, ref["params1"], 0, 2 * lr)
    np.testing.assert_allclose(losses, ref["losses"], rtol=ADAM_LOSS_RTOL)
    assert losses[-1] < losses[0]


def test_head_dim_above_128_matches_jax(tmp_path):
    """``transformer_lm(V, width=320, n_heads=2)``: a head dim of 160, which
    the CUDA kernels run in ``csrc/flash_wide.cu``. Output at atol 1e-5, and
    two SGD steps at the SGD tolerances."""
    conf = lm_conf_json(width=320, n_layers=1, n_heads=2, learning_rate=0.05,
                        global_fields={"updater": "sgd"},
                        layer_fields={"updater": "sgd"})
    batches = [_batch(s) for s in range(2)]
    ref = jax_train(conf, batches, tmp_path)
    tnet = _port(conf, ref)
    from deeplearning4j_tpu.nn.conf.multilayer import MultiLayerConfiguration
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
    jnet = JaxNet(MultiLayerConfiguration.from_json(conf)).init()  # params0
    x = batches[0][0]
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), rtol=0,
                               atol=OTHER_ATOL)
    losses = _port_losses(tnet, batches)
    np.testing.assert_allclose(losses, ref["losses"], rtol=LOSS_RTOL)
    _assert_params(tnet, ref["params"], PARAM_RTOL, PARAM_ATOL)


def test_continuing_from_carried_updater_state(tmp_path):
    """JAX trains two Adam steps; the port picks up its params, updater state
    and iteration, and both take a third step: the Adam bias correction
    reads the iteration, so an off-by-one shows here."""
    conf = lm_conf_json(learning_rate=1e-3)
    batches = [_batch(s) for s in range(3)]
    two = jax_train(conf, batches[:2], tmp_path / "a")
    three = jax_train(conf, batches, tmp_path / "b")
    tnet = from_jax(conf, two["params"], device="cpu",
                    updater_state=two["updater_state"],
                    iteration=two["iteration"])
    assert tnet.iteration == 2
    loss = _port_losses(tnet, batches[2:])
    np.testing.assert_allclose(loss, three["losses"][2:], rtol=LOSS_RTOL)
    _assert_params(tnet, three["params"], 0, OTHER_ATOL)
    for own, ref in zip(to_numpy(tnet.updater_state), three["updater_state"]):
        for name in ref:
            for slot in ref[name]:
                want = ref[name][slot]
                np.testing.assert_allclose(
                    own[name][slot], want, rtol=1e-4,
                    atol=1e-4 * float(np.abs(want).max()))


VARIANTS = {
    "l1_l2": dict(global_fields={"use_regularization": True},
                  layer_fields={"l1": 1e-3, "l2": 1e-2}),
    "clip_l2_per_layer": dict(layer_fields={
        "gradient_normalization": "ClipL2PerLayer",
        "gradient_normalization_threshold": 0.5}),
    "renorm_step_policy_bias_lr": dict(
        global_fields={"lr_policy": "step", "lr_policy_decay_rate": 0.5,
                       "lr_policy_steps": 1.0},
        layer_fields={"gradient_normalization": "RenormalizeL2PerParamType",
                      "bias_learning_rate": 0.2}),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_regularization_normalization_and_policies_match_jax(tmp_path, variant):
    conf = lm_conf_json(learning_rate=0.05,
                        global_fields={"updater": "sgd",
                                       **VARIANTS[variant].get("global_fields", {})},
                        layer_fields={"updater": "sgd",
                                      **VARIANTS[variant]["layer_fields"]})
    batches = [_batch(s) for s in range(2)]
    ref = jax_train(conf, batches, tmp_path)
    tnet = _port(conf, ref)
    np.testing.assert_allclose(_port_losses(tnet, batches), ref["losses"],
                               rtol=LOSS_RTOL)
    _assert_params(tnet, ref["params"], 0, OTHER_ATOL)


def test_label_mask_and_dataset_fit_match_jax(tmp_path):
    conf = lm_conf_json(learning_rate=0.05, global_fields={"updater": "sgd"},
                        layer_fields={"updater": "sgd"})
    batches = [_batch(s, lmask=True) for s in range(2)]
    ref = jax_train(conf, batches, tmp_path)
    tnet = _port(conf, ref)
    losses = []
    for x, y, _, m in batches:
        tnet.fit(DataSet(x, y, labels_mask=m))
        losses.append(tnet.score_value)
    np.testing.assert_allclose(losses, ref["losses"], rtol=LOSS_RTOL)
    _assert_params(tnet, ref["params"], 0, OTHER_ATOL)


def test_iterations_two_takes_two_steps_per_fit(tmp_path):
    conf = lm_conf_json(learning_rate=1e-3, global_fields={"iterations": 2})
    batches = [_batch(0)]
    ref = jax_train(conf, batches, tmp_path)
    assert ref["iteration"] == 2
    tnet = _port(conf, ref)
    seen = []

    class Listener:
        def iteration_done(self, net, iteration):
            seen.append((iteration, net.score_value))

    tnet.add_listener(Listener())
    np.testing.assert_allclose(_port_losses(tnet, batches), ref["losses"],
                               rtol=LOSS_RTOL)
    assert [s[0] for s in seen] == [1, 2] and tnet.iteration == 2
    _assert_params(tnet, ref["params"], 0, OTHER_ATOL)


def test_score_matches_jax(tmp_path):
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
    conf = lm_conf_json(global_fields={"use_regularization": True},
                        layer_fields={"l2": 1e-2})
    x, y, _, m = _batch(3, lmask=True)
    with compile_cache_at(tmp_path):
        jnet = JaxNet(JaxConfiguration.from_json(conf)).init()
        params = [{k: np.asarray(v) for k, v in p.items()}
                  for p in jnet.params_list]
        from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
        ref = jnet.score(dataset=JaxDataSet(x, y, labels_mask=m))
    tnet = from_jax(conf, params, device="cpu")
    got = tnet.score(dataset=DataSet(x, y, labels_mask=m))
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)


def test_fit_iterator_equals_batch_by_batch_fit():
    conf = MultiLayerConfiguration.from_json(lm_conf_json())
    data = [DataSet(*_batch(s)[:2]) for s in range(3)]
    a = MultiLayerNetwork(conf, device="cpu").init(seed=5)
    b = MultiLayerNetwork(conf, device="cpu").init(seed=5)
    events = []

    class Listener:
        def iteration_done(self, net, iteration):
            events.append(("it", iteration))

        def on_epoch_start(self, net):
            events.append(("start", net.epoch))

        def on_epoch_end(self, net):
            events.append(("end", net.epoch))

    a.add_listener(Listener())
    a.fit(data, epochs=2)  # an iterable of DataSets goes to fit_iterator
    for _ in range(2):
        for ds in data:
            b.fit(ds)
    assert a.epoch == 2 and a.iteration == b.iteration == 6
    assert events[0] == ("start", 0) and events[4] == ("end", 0)
    assert [e[1] for e in events if e[0] == "it"] == [1, 2, 3, 4, 5, 6]
    for pa, pb in zip(a.params_list, b.params_list):
        for k in pa:
            assert torch.equal(pa[k], pb[k])


@pytest.mark.parametrize("dropout", [0.0, 0.8])
def test_gradient_checkpointing_gives_the_same_gradients(dropout):
    fields = {"dropout": dropout}
    plain = MultiLayerConfiguration.from_json(
        lm_conf_json(n_layers=2, layer_fields=fields))
    remat = MultiLayerConfiguration.from_json(lm_conf_json(
        n_layers=2, layer_fields=fields,
        global_fields={"gradient_checkpointing": True}))
    x, y, _, _ = _batch(1)
    grads = []
    for conf in (plain, remat):
        net = MultiLayerNetwork(conf, device="cpu").init(seed=9)
        params = net.params_list
        loss, _ = loss_fn(net, params, torch.from_numpy(x),
                          torch.from_numpy(y), rng=1234)
        flat = [p for d in params for p in d.values()]
        grads.append(torch.autograd.grad(loss, flat))
    for ga, gb in zip(*grads):
        torch.testing.assert_close(ga, gb, rtol=0, atol=1e-6)


def test_dropout_keeps_the_retain_share_and_follows_the_seed():
    conf = MultiLayerConfiguration.from_json(
        lm_conf_json(layer_fields={"dropout": 0.8}))
    block = MultiLayerNetwork(conf, device="cpu").layers[1]
    x = torch.ones(200, 100)

    def drop(seed):
        return block.apply_dropout(
            x, torch.Generator().manual_seed(seed), True)

    out = drop(0)
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.8) < 0.01
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], 1 / 0.8))
    assert torch.equal(drop(0), out) and not torch.equal(drop(1), out)
    # no generator or not training: the identity
    assert torch.equal(block.apply_dropout(x, None, True), x)
    assert torch.equal(block.apply_dropout(x, torch.Generator(), False), x)


@pytest.mark.parametrize("field,value", [
    ("backprop_type", "TruncatedBPTT"), ("optimization_algo", "lbfgs"),
    ("pretrain", True)])
def test_unported_training_settings_raise_at_fit(field, value, tmp_path):
    """A ``pretrain(True)`` stack without a pretraining layer trains as the
    JAX one does: ``fit`` takes the supervised step, and ``fit_iterator``
    runs the (empty) layerwise pretraining, then the supervised epoch, the
    same steps (layerwise pretraining itself is held against JAX in
    tests/test_torch_pretrain.py). A transformer LM flagged
    ``TruncatedBPTT`` has no LSTM, so it trains with the standard step (one
    update per batch, not per chunk), as the JAX package does. An LBFGS
    config trains through the Solver (one LBFGS iteration a ``fit``, the
    config's ``iterations``), as the JAX package's does: the iteration
    count exactly, the losses within 1e-4 relative
    (``tests/test_torch_solvers.py`` holds the solvers themselves)."""
    top = {field: value} if field != "optimization_algo" else {}
    glob = {field: value} if field == "optimization_algo" else {}
    x, y, _, _ = _batch(0)
    if field == "optimization_algo":
        conf = lm_conf_json(global_fields=glob)
        batches = [_batch(s) for s in range(2)]
        ref = jax_train(conf, batches, tmp_path)
        tnet = _port(conf, ref)
        losses = _port_losses(tnet, batches)
        assert tnet.iteration == ref["iteration"] == 2
        np.testing.assert_allclose(losses, ref["losses"], rtol=1e-4)
        return
    if field == "backprop_type":
        conf = lm_conf_json(learning_rate=0.05,
                            global_fields={"updater": "sgd"},
                            layer_fields={"updater": "sgd"},
                            top_fields={**top, "tbptt_fwd_length": 3})
        batches = [_batch(s) for s in range(2)]
        ref = jax_train(conf, batches, tmp_path)
        tnet = _port(conf, ref)
        losses = _port_losses(tnet, batches)
        assert tnet.iteration == ref["iteration"] == 2
        np.testing.assert_allclose(losses, ref["losses"], rtol=LOSS_RTOL)
        _assert_params(tnet, ref["params"], PARAM_RTOL, PARAM_ATOL)
        return
    conf = lm_conf_json(global_fields=glob, top_fields=top)
    batches = [_batch(s) for s in range(2)]
    ref = jax_train(conf, batches, tmp_path)
    tnet = _port(conf, ref)
    losses = _port_losses(tnet, batches)
    assert tnet.iteration == ref["iteration"] == 2
    np.testing.assert_allclose(losses, ref["losses"], rtol=LOSS_RTOL)
    again = _port(conf, ref)
    again.fit_iterator([DataSet(b[0], b[1]) for b in batches])
    assert again.iteration == 2
    assert torch.equal(again.params(), tnet.params())


def test_config_round_trip_through_the_port():
    """A JAX config's JSON read and written by the port is the same JSON,
    and the JAX package reads it back to the same config: no training field
    is dropped."""
    jconf = jax_transformer_lm(64, width=32, n_layers=2, n_heads=2)
    jconf.global_conf.lr_policy = "step"
    jconf.global_conf.lr_schedule = {"10": 0.01}
    jconf.global_conf.iterations = 3
    jconf.backprop_type = "TruncatedBPTT"
    jconf.tbptt_fwd_length = 7
    text = jconf.to_json()
    ours = MultiLayerConfiguration.from_json(text)
    assert ours.global_conf.lr_policy == "step"
    assert ours.global_conf.iterations == 3 and ours.tbptt_fwd_length == 7
    assert json.loads(ours.to_json()) == json.loads(text)
    assert JaxConfiguration.from_json(ours.to_json()) == jconf
    # the port's own transformer_lm writes exactly the JAX config
    assert json.loads(transformer_lm(64, width=32, n_layers=2,
                                     n_heads=2).to_json()) == \
        json.loads(jax_transformer_lm(64, width=32, n_layers=2,
                                      n_heads=2).to_json())
    bad = json.loads(text)
    bad["global_conf"]["no_such_field"] = 1
    with pytest.raises(ValueError, match="no_such_field"):
        MultiLayerConfiguration.from_dict(bad)


def test_unbaked_layers_take_the_global_defaults_as_jax_bakes_them():
    """Layers that leave the inherited fields unset get them from the global
    conf exactly as the JAX package's ``bake_layer_defaults`` fills them (an
    unset bias learning rate becomes the layer's baked learning rate, so the
    global ``bias_learning_rate`` reaches no layer), and the port's layers
    read those baked values."""
    from deeplearning4j_tpu.nn.conf.builders import (
        _LAYER_INHERIT_FIELDS, bake_layer_defaults)
    jconf = jax_transformer_lm(32, width=16, n_layers=1, n_heads=2)
    g = jconf.global_conf
    g.bias_learning_rate, g.l2, g.dropout, g.momentum = 0.2, 1e-3, 0.9, 0.5
    for layer in jconf.layers:
        for f in _LAYER_INHERIT_FIELDS:
            setattr(layer, f, None)
        layer.bias_init = None
    jconf.layers[0].learning_rate = 0.01
    unbaked = jconf.to_json()
    for layer in jconf.layers:
        bake_layer_defaults(layer, g)
    ours = MultiLayerConfiguration.from_json(unbaked)
    assert json.loads(ours.to_json()) == json.loads(jconf.to_json())
    net = MultiLayerNetwork(ours, device="cpu")
    assert [l.bias_learning_rate for l in net.layers] == [0.01, 3e-4, 3e-4]
    assert all(l.l2 == 1e-3 and l.dropout == 0.9 and l.momentum == 0.5
               for l in net.layers)
