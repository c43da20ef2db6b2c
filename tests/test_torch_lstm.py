"""The port's recurrent engine (``ops/lstm.py``) held against the JAX
package's.

The plain versions of the CUDA kernels (``lstm_fwd_plain``,
``lstm_bwd_plain``) against the JAX Pallas kernels run in interpret mode
(B = 3, T = 16, blocks of 8 steps, F = 5, H = 8), with and without
peepholes and a ragged mask, the backward with nonzero final-state
cotangents; ``lstm_sequence`` and its autograd gradients against JAX
``lstm_sequence(impl="pallas", interpret=True)`` under ``jax.grad``; and a
cell with a non-standard activation through ``lstm_fused``. All float32:
atol 1e-5 for outputs, 2e-5 for gradients (sums over 48 rows in another
order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import activations as jact
from deeplearning4j_tpu.ops import lstm as jl
from deeplearning4j_tpu_torch.ops import activations as tact
from deeplearning4j_tpu_torch.ops import lstm as tl

B, T, BT, F, H = 3, 16, 8, 5, 8
TOL = 1e-5
GRAD_TOL = 2e-5


def _arrays(peephole, masked, seed=0):
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    m = np.ones((T, B), np.float32)
    if masked:
        m = (rng.random((T, B)) > 0.3).astype(np.float32)
        m[:, 1] = 0.0  # a batch row masked at every step
    return dict(x_t=r(T, B, F), wcat=r(F + H, 4 * H, scale=0.4),
                b=r(1, 4 * H, scale=0.2), peep=r(3, H, scale=0.3),
                h0=r(B, H, scale=0.5), c0=r(B, H, scale=0.5), m_t=m)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


CASES = [(True, False), (True, True), (False, False), (False, True)]


@pytest.mark.parametrize("peephole,masked", CASES)
def test_forward_plain_matches_jax_kernel(peephole, masked):
    a = _arrays(peephole, masked)
    ref = jl._pallas_forward(*(jnp.asarray(a[k]) for k in
                               ("x_t", "wcat", "b", "peep", "h0", "c0", "m_t")),
                             BT, peephole, True)
    before = tl.lstm_fwd.launches
    got = tl.lstm_fwd(_t(a["x_t"]), _t(a["wcat"]), _t(a["b"]),
                      _t(a["peep"]) if peephole else None, _t(a["h0"]),
                      _t(a["c0"]), _t(a["m_t"]))
    assert tl.lstm_fwd.launches == before  # the CPU runs the plain version
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=TOL)


@pytest.mark.parametrize("peephole,masked", CASES)
def test_backward_plain_matches_jax_kernel(peephole, masked):
    a = _arrays(peephole, masked, seed=1)
    rng = np.random.default_rng(2)
    ys, cs, _, _ = jl._pallas_forward(
        *(jnp.asarray(a[k]) for k in ("x_t", "wcat", "b", "peep", "h0", "c0",
                                      "m_t")), BT, peephole, True)
    hprev = np.concatenate([a["h0"][None], np.asarray(ys)[:-1]])
    cprev = np.concatenate([a["c0"][None], np.asarray(cs)[:-1]])
    dys = rng.standard_normal((T, B, H)).astype(np.float32)
    dht = rng.standard_normal((B, H)).astype(np.float32)
    dct = rng.standard_normal((B, H)).astype(np.float32)
    ref = jl._pallas_backward(
        *(jnp.asarray(v) for v in (a["x_t"], hprev, cprev, a["wcat"], a["b"],
                                   a["peep"], dys, dht, dct, a["m_t"])),
        BT, peephole, True)
    before = tl.lstm_bwd.launches
    got = tl.lstm_bwd(_t(a["x_t"]), _t(hprev), _t(cprev), _t(a["wcat"]),
                      _t(a["b"]), _t(a["peep"]) if peephole else None,
                      _t(dys), _t(dht), _t(dct), _t(a["m_t"]))
    assert tl.lstm_bwd.launches == before
    names = ("dx", "dW", "db", "dpeep", "dh0", "dc0")
    for name, g, r in zip(names, got, ref):
        r = np.asarray(r)
        if name == "dpeep" and not peephole:
            r = np.zeros_like(r)  # the kernel leaves its block unwritten
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=GRAD_TOL,
                                   err_msg=name)


def _params(peephole, seed=3):
    rng = np.random.default_rng(seed)
    p = {"W": rng.standard_normal((F, 4 * H)) * 0.4,
         "RW": rng.standard_normal((H, 4 * H)) * 0.4,
         "b": rng.standard_normal(4 * H) * 0.2}
    if peephole:
        for k in ("pI", "pF", "pO"):
            p[k] = rng.standard_normal(H) * 0.3
    return {k: v.astype(np.float32) for k, v in p.items()}


def _grads_both(params, x, h0, c0, mask, peephole, act="tanh",
                gate="sigmoid"):
    """Outputs and gradients (params, x, h0, c0) of sum(ys * w) + sum(h) +
    2 sum(c) through the JAX engine (Pallas, interpret mode; fused for a
    non-standard cell) and the port's."""
    w = np.random.default_rng(9).standard_normal((B, T, H)).astype(np.float32)
    impl = "pallas" if act == "tanh" else "fused"

    def jloss(p, x_, h_, c_):
        ys, (h, c) = jl.lstm_sequence(
            p, x_, jact.get_activation(act), jact.get_activation(gate), h_,
            c_, peephole, None if mask is None else jnp.asarray(mask),
            act_name=act, gate_name=gate, impl=impl, interpret=True)
        return jnp.sum(ys * w) + jnp.sum(h) + 2 * jnp.sum(c), ys

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    (_, jys), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                      has_aux=True)(jp, jnp.asarray(x),
                                                    jnp.asarray(h0),
                                                    jnp.asarray(c0))
    tp = {k: _t(v).requires_grad_(True) for k, v in params.items()}
    tx, th, tc = (_t(v).requires_grad_(True) for v in (x, h0, c0))
    ys, (h, c) = tl.lstm_sequence(
        tp, tx, tact.get_activation(act), tact.get_activation(gate), th, tc,
        peephole, None if mask is None else _t(mask), act_name=act,
        gate_name=gate)
    loss = (ys * _t(w)).sum() + h.sum() + 2 * c.sum()
    tg = torch.autograd.grad(loss, list(tp.values()) + [tx, th, tc])
    return (jys, jg), (ys, tg, list(tp))


@pytest.mark.parametrize("peephole", [True, False])
def test_lstm_sequence_and_gradients_match_jax_pallas(peephole):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    h0 = (rng.standard_normal((B, H)) * 0.5).astype(np.float32)
    c0 = (rng.standard_normal((B, H)) * 0.5).astype(np.float32)
    mask = (rng.random((B, T)) > 0.25).astype(np.float32)
    (jys, jg), (ys, tg, names) = _grads_both(_params(peephole), x, h0, c0,
                                             mask, peephole)
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(jys), rtol=0,
                               atol=TOL)
    jflat = [jg[0][k] for k in names] + list(jg[1:])
    for name, g, r in zip(names + ["x", "h0", "c0"], tg, jflat):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=GRAD_TOL, err_msg=name)


def test_nonstandard_cell_runs_fused_and_matches_jax():
    """A relu cell is not the kernels' cell: the port runs ``lstm_fused``
    (no launch counted) and matches JAX ``lstm_fused``, gradients too."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    z = np.zeros((B, H), np.float32)
    mask = (rng.random((B, T)) > 0.25).astype(np.float32)
    n = (tl.lstm_fwd.launches, tl.lstm_bwd.launches)
    (jys, jg), (ys, tg, names) = _grads_both(_params(True), x, z, z, mask,
                                             True, act="relu")
    assert (tl.lstm_fwd.launches, tl.lstm_bwd.launches) == n
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(jys), rtol=0,
                               atol=TOL)
    for name, g in zip(names, tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[0][name]), rtol=0,
                                   atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("fn", ["scan", "fused"])
def test_plain_engines_match_jax(fn):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    h0 = rng.standard_normal((B, H)).astype(np.float32)
    c0 = rng.standard_normal((B, H)).astype(np.float32)
    mask = (rng.random((B, T)) > 0.25).astype(np.float32)
    p = _params(True)
    jfn = {"scan": jl.lstm_scan, "fused": jl.lstm_fused}[fn]
    tfn = {"scan": tl.lstm_scan, "fused": tl.lstm_fused}[fn]
    jys, (jh, jc) = jfn({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), jax.nn.tanh, jax.nn.sigmoid,
                        jnp.asarray(h0), jnp.asarray(c0), True,
                        jnp.asarray(mask))
    ys, (h, c) = tfn({k: _t(v) for k, v in p.items()}, _t(x), torch.tanh,
                     torch.sigmoid, _t(h0), _t(c0), True, _t(mask))
    for g, r in ((ys, jys), (h, jh), (c, jc)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=TOL)


def test_wrappers_check_their_operands():
    a = {k: _t(v) for k, v in _arrays(True, False).items()}
    with pytest.raises(ValueError, match="wcat"):
        tl.lstm_fwd(a["x_t"], a["wcat"][:-1], a["b"], a["peep"], a["h0"],
                    a["c0"], a["m_t"])
    with pytest.raises(ValueError, match="T, B, H >= 1"):
        tl.lstm_fwd(a["x_t"][:0], a["wcat"], a["b"], a["peep"], a["h0"],
                    a["c0"], a["m_t"][:0])
    with pytest.raises(ValueError, match="m_t"):
        tl.lstm_fwd(a["x_t"], a["wcat"], a["b"], a["peep"], a["h0"], a["c0"],
                    a["m_t"][:, :2])
    assert tl.is_standard_cell("tanh", "sigmoid")
    assert tl.is_standard_cell(None, None)
    assert not tl.is_standard_cell("relu", "sigmoid")
    assert not tl.is_standard_cell("tanh", "hardsigmoid")
