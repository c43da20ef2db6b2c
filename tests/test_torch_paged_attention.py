"""The port's paged KV gather held against the JAX package: bitwise, trash
rows included (pure data movement). The CUDA kernel is held against the
plain version on the card in ``test_torch_cuda_kernels.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import paged_attention as jpa
from deeplearning4j_tpu_torch.ops import paged_attention as tpa


def _inputs(seed=0, n_pages=12, ps=4, H=2, D=8, cap=3, P=5):
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((n_pages + 1, ps, H, D)).astype(np.float32)
    table = rng.integers(0, n_pages + 1, size=(cap, P)).astype(np.int32)
    table[0, -2:] = 0   # unmapped tail: the trash page
    table[2, :] = 0     # an inactive slot maps trash everywhere
    return pool, table


def test_paged_gather_bitwise_equals_jax_pallas_interpret(monkeypatch):
    monkeypatch.setenv("DL4J_PAGED_GATHER_INTERPRET", "1")
    pool, table = _inputs()
    ref = np.asarray(jpa.paged_gather(jnp.asarray(pool), jnp.asarray(table),
                                      impl="pallas"))
    out = tpa.paged_gather(torch.from_numpy(pool), torch.from_numpy(table))
    assert out.shape == ref.shape == (3, 20, 2, 8)
    assert np.array_equal(out.numpy(), ref)
    # trash rows are the trash page's contents, copied like any other page
    assert np.array_equal(out.numpy()[2, :4], pool[0])


def test_paged_gather_wrapper_checks_operands():
    pool, table = _inputs()
    with pytest.raises(TypeError):
        tpa.paged_gather(torch.from_numpy(pool),
                         torch.from_numpy(table).long())
    with pytest.raises(ValueError):
        tpa.paged_gather(torch.from_numpy(pool)[0], torch.from_numpy(table))
