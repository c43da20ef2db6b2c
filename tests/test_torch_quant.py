"""Int8 quantization of the PyTorch port held against the JAX package.

Codes and scales must equal ``deeplearning4j_tpu.ops.quant`` exactly (same
round-half-even, clip and zero-channel rule). The matmul's plain version is
held against the JAX Pallas kernel in interpret mode at atol 1e-5 (float32
sums in another order), and against the JAX fallback on an unaligned shape.
The CUDA kernel is held against the plain version on the card in
``test_torch_cuda_kernels.py``.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import quant as jq
from deeplearning4j_tpu_torch.ops import quant as tq


def _weights(rng, shape):
    w = rng.standard_normal(shape).astype(np.float32) * 0.05
    w[..., 3] = 0.0  # an all-zero channel takes scale 1
    w[0, 5] = 0.5 * (w[:, 5].max() - w[:, 5].min())  # exercise rounding
    return w


@pytest.mark.parametrize("shape", [(256, 256), (64, 130), (3, 40, 24)])
def test_int8_codes_and_scales_equal_jax(shape):
    w = _weights(np.random.default_rng(0), shape)
    jl = jq.quantize_per_channel(w)
    tl = tq.quantize_per_channel(torch.from_numpy(w))
    assert np.array_equal(np.asarray(jl.q), tl.q.numpy())
    assert np.array_equal(np.asarray(jl.scale), tl.scale.numpy())
    assert tl.q.dtype == torch.int8 and tl.scale.dtype == torch.float32
    assert np.array_equal(np.asarray(jq.dequantize_leaf(jl)),
                          tq.dequantize_leaf(tl).numpy())


def test_quantize_tree_eligibility_and_bytes_equal_jax():
    rng = np.random.default_rng(1)
    tree = [{"W": _weights(rng, (64, 32)), "b": np.zeros(32, np.float32),
             "small": _weights(rng, (8, 8))}]
    jt = jq.quantize_tree(tree)
    tt = tq.quantize_tree([{k: torch.from_numpy(v) for k, v in tree[0].items()}])
    assert jq.is_quantized(jt[0]["W"]) and tq.is_quantized(tt[0]["W"])
    assert not tq.is_quantized(tt[0]["b"]) and not tq.is_quantized(tt[0]["small"])
    assert tq.tree_param_bytes(tt) == jq.tree_param_bytes(jt)
    dense = tq.dequantize_tree(tt)
    assert np.array_equal(dense[0]["W"].numpy(),
                          np.asarray(jq.dequantize_tree(jt)[0]["W"]))
    idx = np.array([[3, 0], [63, 7]])
    assert np.array_equal(
        tq.gather_rows(tt[0]["W"], torch.from_numpy(idx)).numpy(),
        np.asarray(jq.gather_rows(jt[0]["W"], idx)))


def test_quantized_matmul_matches_jax_pallas_interpret():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 256)).astype(np.float32)
    w = _weights(rng, (256, 256))
    ref = np.asarray(jq.quantized_matmul(x, jq.quantize_per_channel(w),
                                         interpret=True))
    out = tq.quantized_matmul(torch.from_numpy(x),
                              tq.quantize_per_channel(torch.from_numpy(w)))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_quantized_matmul_unaligned_matches_jax_fallback():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 200)).astype(np.float32)
    w = _weights(rng, (200, 130))
    ref = np.asarray(jq.quantized_matmul(x, jq.quantize_per_channel(w)))
    out = tq.quantized_matmul(torch.from_numpy(x),
                              tq.quantize_per_channel(torch.from_numpy(w)))
    assert out.shape == (2, 3, 130)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    dense = tq.quantized_matmul(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(dense.numpy(), x @ w, rtol=0, atol=1e-5)


def test_int8_matmul_wrapper_checks_operands():
    x = torch.zeros(2, 8)
    q = torch.zeros(8, 4, dtype=torch.int8)
    s = torch.ones(4)
    with pytest.raises(ValueError):
        tq.int8_matmul(x, q[:7], s)
    with pytest.raises(TypeError):
        tq.int8_matmul(x, q.float(), s)
    with pytest.raises(ValueError):
        tq.int8_matmul(x[0], q, s)
    before = tq.int8_matmul.launches
    assert tq.int8_matmul(x, q, s).shape == (2, 4)
    assert tq.int8_matmul.launches == before  # the CPU path launches nothing
