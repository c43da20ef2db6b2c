"""The port's flash-attention forward held against the JAX Pallas kernel in
interpret mode: out and lse, causal and not, with and without a key mask
(one fully masked row), at atol 2e-5 (float32 online softmax against the
port's one-pass plain version). The CUDA kernel is held against the plain
version on the card in ``test_torch_cuda_kernels.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import pallas_kernels as jpk
from deeplearning4j_tpu_torch.ops import flash_attention as tfa

TOL = 2e-5


def _qkv(T, seed=0, B=2, H=2, D=32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, D)).astype(np.float32)
            for _ in range(3)]


def _key_mask(T, seed=1):
    km = (np.random.default_rng(seed).random((2, T)) > 0.25).astype(np.float32)
    km[1, :] = 0.0  # every query row of batch 1 sees no key at all
    return km


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T", [128, 256])
def test_flash_attention_matches_jax_interpret(T, causal):
    q, k, v = _qkv(T)
    ref = np.asarray(jpk.flash_attention(*map(jnp.asarray, (q, k, v)), causal,
                                         interpret=True))
    _, ref_lse = jpk._flash_forward(*map(jnp.asarray, (q, k, v)), causal,
                                    interpret=True)
    out, lse = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=0, atol=TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T", [128, 256])
def test_masked_attention_matches_jax_interpret(T, causal):
    q, k, v = _qkv(T, seed=2)
    km = _key_mask(T)
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    ref = np.asarray(jpk.masked_attention(*jargs, jnp.asarray(km), causal,
                                          interpret=True))
    _, ref_lse = jpk._flash_forward(*jargs, causal, interpret=True,
                                    key_mask=jnp.asarray(km))
    out, lse = tfa.masked_attention(*map(torch.from_numpy, (q, k, v, km)),
                                    causal)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=0, atol=TOL)
    assert not out.numpy()[1].any()  # fully masked rows output 0


@pytest.mark.parametrize("causal,masked", [(True, False), (False, True)])
def test_head_dim_above_128_matches_jax_interpret(causal, masked):
    """D = 160: on the card csrc/flash_wide.cu's column groups; here the
    plain version against the JAX Pallas kernel in interpret mode."""
    q, k, v = _qkv(128, seed=4, D=160)
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    km = _key_mask(128, seed=5) if masked else None
    jkm = None if km is None else jnp.asarray(km)
    ref, ref_lse = jpk._flash_forward(*jargs, causal, interpret=True,
                                      key_mask=jkm)
    targs = list(map(torch.from_numpy, (q, k, v)))
    if masked:
        out, lse = tfa.masked_attention(*targs, torch.from_numpy(km), causal)
    else:
        out, lse = tfa.flash_attention(*targs, causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=0,
                               atol=TOL)


def test_flash_fwd_wrapper_checks_operands():
    q, k, v = map(torch.from_numpy, _qkv(16))
    with pytest.raises(TypeError):
        tfa.flash_fwd(q, k.double(), v, True)
    with pytest.raises(ValueError):
        tfa.flash_fwd(q, k[:, :, :1], v, True)
    with pytest.raises(ValueError):
        tfa.flash_fwd(q, k, v, True, key_mask=torch.ones(2, 15))
