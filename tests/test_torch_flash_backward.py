"""The port's flash-attention backward held against the JAX package.

``flash_bwd_plain`` (what ``flash_bwd`` runs on CPU tensors) against the JAX
Pallas backward (``_flash_backward`` in interpret mode) on the same
``out``/``lse``: causal and not, with and without a key mask that fully masks
one batch row, at atol 2e-6 in float32 (sums in another order) and within
one bfloat16 ulp (atol 3e-2 at magnitudes up to ~4) in bfloat16. Then the
port's autograd gradients of ``flash_attention``/``masked_attention``
against ``jax.grad`` through the Pallas backward (interpret, forced past its
length gate), and at a ragged T against JAX's chunked XLA backward, at atol
1e-5. The CUDA kernels are held against the plain versions on the card in
``test_torch_cuda_kernels.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import pallas_kernels as jpk
from deeplearning4j_tpu_torch.ops import flash_attention as tfa

TOL = 2e-6
GRAD_TOL = 1e-5
BF16_TOL = 3e-2


def _arrays(T, seed, B=2, H=2, D=32, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, D)).astype(np.float32)
            for _ in range(n)]


def _key_mask(T, seed=1, B=2):
    km = (np.random.default_rng(seed).random((B, T)) > 0.25).astype(np.float32)
    km[1, :] = 0.0  # every query row of batch 1 sees no key at all
    return km


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_plain_matches_jax_interpret(causal, masked):
    q, k, v, g = _arrays(64, seed=3)
    km = _key_mask(64) if masked else None
    jkm = None if km is None else jnp.asarray(km)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    out, lse = jpk._flash_forward(jq, jk, jv, causal, interpret=True,
                                  key_mask=jkm)
    ref = jpk._flash_backward(jq, jk, jv, out, lse, jnp.asarray(g), causal,
                              interpret=True, key_mask=jkm)
    got = tfa.flash_bwd(_t(q), _t(k), _t(v), _t(out), _t(lse), _t(g), causal,
                        None if km is None else _t(km))
    for r, x in zip(ref, got):
        assert x.dtype == torch.float32 and x.shape == (2, 64, 2, 32)
        np.testing.assert_allclose(x.numpy(), np.asarray(r), rtol=0, atol=TOL)
    if masked:
        # keys of a fully masked batch row take no gradient; its queries see
        # no key, so they take none either
        assert not any(x.numpy()[1].any() for x in got)


def test_flash_bwd_plain_matches_jax_interpret_bf16():
    arrs = [a.astype(jnp.bfloat16) for a in map(jnp.asarray, _arrays(64, 4))]
    jq, jk, jv, jg = arrs
    out, lse = jpk._flash_forward(jq, jk, jv, True, interpret=True)
    ref = jpk._flash_backward(jq, jk, jv, out, lse, jg, True, interpret=True)
    tb = [_t(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)
          for a in (jq, jk, jv, jg, out)]
    got = tfa.flash_bwd(tb[0], tb[1], tb[2], tb[4], _t(lse), tb[3], True)
    for r, x in zip(ref, got):
        assert x.dtype == torch.bfloat16
        np.testing.assert_allclose(x.float().numpy(),
                                   np.asarray(r.astype(jnp.float32)), rtol=0,
                                   atol=BF16_TOL)


def _port_grads(fn, q, k, v, w, *extra):
    qt, kt, vt = (_t(a).requires_grad_(True) for a in (q, k, v))
    out, lse = fn(qt, kt, vt, *extra)
    assert not lse.requires_grad
    return torch.autograd.grad((out * _t(w)).sum(), (qt, kt, vt))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_grad_matches_jax_pallas(causal):
    q, k, v, w = _arrays(128, seed=5)
    ref = jax.grad(lambda a, b, c: jnp.sum(
        jpk.flash_attention(a, b, c, causal, True, True) * w),
        argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = _port_grads(lambda a, b, c: tfa.flash_attention(a, b, c, causal),
                      q, k, v, w)
    for r, x in zip(ref, got):
        np.testing.assert_allclose(x.numpy(), np.asarray(r), rtol=0,
                                   atol=GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_masked_attention_grad_matches_jax_pallas(causal):
    q, k, v, w = _arrays(128, seed=6)
    km = _key_mask(128, seed=2)
    ref = jax.grad(lambda a, b, c: jnp.sum(
        jpk.masked_attention(a, b, c, jnp.asarray(km), causal, True, True)
        * w), argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = _port_grads(
        lambda a, b, c: tfa.masked_attention(a, b, c, _t(km), causal),
        q, k, v, w)
    for r, x in zip(ref, got):
        np.testing.assert_allclose(x.numpy(), np.asarray(r), rtol=0,
                                   atol=GRAD_TOL)


@pytest.mark.parametrize("causal,masked", [(True, False), (False, True)])
def test_head_dim_above_128_grad_matches_jax_pallas(causal, masked):
    """D = 160 (csrc/flash_wide.cu on the card): the port's gradients
    against jax.grad through the Pallas backward in interpret mode."""
    q, k, v, w = _arrays(128, seed=9, D=160)
    km = _key_mask(128, seed=4) if masked else None
    if masked:
        def jf(a, b, c):
            return jpk.masked_attention(a, b, c, jnp.asarray(km), causal,
                                        True, True)

        def tf(a, b, c):
            return tfa.masked_attention(a, b, c, _t(km), causal)
    else:
        def jf(a, b, c):
            return jpk.flash_attention(a, b, c, causal, True, True)

        def tf(a, b, c):
            return tfa.flash_attention(a, b, c, causal)
    ref = jax.grad(lambda a, b, c: jnp.sum(jf(a, b, c) * w),
                   argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = _port_grads(tf, q, k, v, w)
    for r, x in zip(ref, got):
        assert x.shape == (2, 128, 2, 160)
        np.testing.assert_allclose(x.numpy(), np.asarray(r), rtol=0,
                                   atol=GRAD_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_ragged_length_grad_matches_jax_xla(masked):
    """T = 50 does not tile for the JAX kernels: JAX takes its XLA forward
    and chunked backward (or the masked XLA vjp); the port takes its kernels'
    plain versions, which mask the tail."""
    q, k, v, w = _arrays(50, seed=7)
    km = _key_mask(50, seed=3) if masked else None
    if masked:
        km[1, :10] = 1.0  # no fully masked row: XLA's softmax would differ

        def jf(a, b, c):
            return jpk.masked_attention(a, b, c, jnp.asarray(km), True)

        def tf(a, b, c):
            return tfa.masked_attention(a, b, c, _t(km), True)
    else:
        def jf(a, b, c):
            return jpk.flash_attention(a, b, c, True)

        def tf(a, b, c):
            return tfa.flash_attention(a, b, c, True)
    ref = jax.grad(lambda a, b, c: jnp.sum(jf(a, b, c) * w),
                   argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = _port_grads(tf, q, k, v, w)
    for r, x in zip(ref, got):
        np.testing.assert_allclose(x.numpy(), np.asarray(r), rtol=0,
                                   atol=GRAD_TOL)


def test_backward_wrappers_check_operands():
    q, k, v, g = map(_t, _arrays(16, seed=8))
    out, lse = tfa.flash_fwd(q, k, v, True)
    delta = tfa.bwd_delta(out, g)
    assert delta.shape == (4, 16) and delta.dtype == torch.float32
    with pytest.raises(TypeError):
        tfa.flash_bwd_dq(q, k.double(), v, g, lse, delta, True)
    with pytest.raises(ValueError):
        tfa.flash_bwd_dkv(q, k, v, g, lse[:, :3], delta, True)
    with pytest.raises(ValueError):
        tfa.flash_bwd(q, k, v, out[:, :3], lse, g, True)
    with pytest.raises(ValueError):
        tfa.flash_bwd_dq(q, k, v, g, lse, delta, True,
                         key_mask=torch.ones(2, 15))
