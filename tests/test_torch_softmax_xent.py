"""The port's fused softmax cross-entropy and its losses held against JAX.

The plain version of ``ops/softmax_xent.py`` (what the wrapper runs on CPU
tensors) against the JAX Pallas kernel in interpret mode: loss at atol 2e-6
and gradient at atol 1e-6 in float32 (one float32 pass in another summation
order), the bfloat16 gradient within one bfloat16 ulp (4e-3 at magnitudes
up to 1). The ``mcxent`` autograd path against ``jax.grad`` through the JAX
fused ``custom_vjp`` (forced with ``DL4J_FUSED_XENT=1``) with a label mask,
and every other loss of ``ops/losses.py`` against the JAX loss of the same
name (value and gradient at rtol 1e-5). The CUDA kernel is held against the
plain version on the card in ``test_torch_cuda_kernels.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import activations as jact
from deeplearning4j_tpu.ops import losses as jl
from deeplearning4j_tpu.ops import pallas_kernels as jpk
from deeplearning4j_tpu_torch.ops import activations as tact
from deeplearning4j_tpu_torch.ops import losses as tl
from deeplearning4j_tpu_torch.ops import softmax_xent as tsx

LOSS_TOL = 2e-6
GRAD_TOL = 1e-6
BF16_GRAD_TOL = 4e-3


def _inputs(N, C, seed, soft=False):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((N, C)) * 3).astype(np.float32)
    if soft:
        y = rng.random((N, C)).astype(np.float32)
        y /= y.sum(axis=1, keepdims=True)
    else:
        y = np.eye(C, dtype=np.float32)[rng.integers(0, C, N)]
    return x, y


@pytest.mark.parametrize("N,C,soft", [(64, 32, False), (50, 300, False),
                                      (24, 257, True)])
def test_plain_matches_jax_interpret(N, C, soft):
    x, y = _inputs(N, C, seed=N + C, soft=soft)
    jloss, jgrad = jpk.softmax_cross_entropy(jnp.asarray(x), jnp.asarray(y),
                                             interpret=True)
    loss, grad = tsx.softmax_cross_entropy(torch.from_numpy(x),
                                           torch.from_numpy(y))
    assert loss.dtype == torch.float32 and loss.shape == (N,)
    assert grad.dtype == torch.float32 and grad.shape == (N, C)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=0,
                               atol=LOSS_TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=0,
                               atol=GRAD_TOL)


def test_plain_matches_jax_interpret_bf16():
    x, y = _inputs(64, 48, seed=5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    jx = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    jloss, jgrad = jpk.softmax_cross_entropy(jx, jnp.asarray(y),
                                             interpret=True)
    loss, grad = tsx.softmax_cross_entropy(xb, torch.from_numpy(y))
    assert loss.dtype == torch.float32 and grad.dtype == torch.bfloat16
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=0,
                               atol=LOSS_TOL)
    np.testing.assert_allclose(grad.float().numpy(),
                               np.asarray(jgrad.astype(jnp.float32)), rtol=0,
                               atol=BF16_GRAD_TOL)


def test_mcxent_gradient_matches_jax_fused_vjp(monkeypatch):
    monkeypatch.setenv("DL4J_FUSED_XENT", "1")
    rng = np.random.default_rng(7)
    B, T, C = 3, 7, 40
    preout = (rng.standard_normal((B, T, C)) * 2).astype(np.float32)
    labels = np.eye(C, dtype=np.float32)[rng.integers(0, C, (B, T))]
    mask = (rng.random((B, T)) > 0.3).astype(np.float32)
    mask[2] = 0.0
    sm = jact.get_activation("softmax")
    jval, jgrad = jax.value_and_grad(
        lambda p: jl.mcxent(jnp.asarray(labels), p, sm, jnp.asarray(mask)))(
            jnp.asarray(preout))
    p = torch.from_numpy(preout).requires_grad_(True)
    val = tl.mcxent(torch.from_numpy(labels), p, tact.softmax,
                    torch.from_numpy(mask))
    (grad,) = torch.autograd.grad(val, p)
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=0,
                               atol=GRAD_TOL)
    assert not grad.numpy()[2].any()  # fully masked rows take no gradient


_ACT_FOR = {"xent": "sigmoid", "reconstruction_crossentropy": "sigmoid",
            "kl_divergence": "softmax", "kld": "softmax", "poisson": "softmax",
            "mcxent": "softmax", "negativeloglikelihood": "softmax",
            "hinge": "tanh", "squared_hinge": "tanh", "squaredhinge": "tanh"}


@pytest.mark.parametrize("name", sorted(tl.LOSSES))
def test_loss_matches_jax(name):
    assert sorted(tl.LOSSES) == sorted(jl.LOSSES)
    rng = np.random.default_rng(11)
    preout = rng.standard_normal((4, 6, 10)).astype(np.float32)
    labels = rng.random((4, 6, 10)).astype(np.float32)
    if _ACT_FOR.get(name) == "softmax":
        labels = labels / labels.sum(axis=-1, keepdims=True)
    mask = (rng.random((4, 6)) > 0.4).astype(np.float32)
    act = _ACT_FOR.get(name, "identity")
    jfn, tfn = jl.get_loss(name), tl.get_loss(name)
    jval, jgrad = jax.value_and_grad(
        lambda p: jfn(jnp.asarray(labels), p, jact.get_activation(act),
                      jnp.asarray(mask)))(jnp.asarray(preout))
    p = torch.from_numpy(preout).requires_grad_(True)
    val = tfn(torch.from_numpy(labels), p, tact.get_activation(act),
              torch.from_numpy(mask))
    (grad,) = torch.autograd.grad(val, p)
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-7)


def test_get_loss_and_wrapper_refuse_bad_input():
    with pytest.raises(ValueError, match="Unknown loss"):
        tl.get_loss("no_such_loss")
    x, y = map(torch.from_numpy, _inputs(4, 8, seed=1))
    with pytest.raises(ValueError):
        tsx.softmax_cross_entropy(x, y[:, :4])
    with pytest.raises(TypeError):
        tsx.softmax_cross_entropy(x.double(), y.double())
    with pytest.raises(ValueError):
        tsx.softmax_cross_entropy(x[0], y[0])
