"""C3's repair on the CPU: the serving pins' dense products go through
``ops/fixed_matmul.py`` (on the card a hand-written GEMM whose answer for a
row does not depend on the row count; held there by
``test_torch_cuda_kernels.py``), and nothing else does. On a CPU tensor
the wrapper is its plain version, ``torch.matmul``, bitwise."""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models import transformer_lm
from deeplearning4j_tpu_torch.nn.conf.layers import feedforward
from deeplearning4j_tpu_torch.nn.inference import make_predict_fn
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import fixed_matmul as fm


def test_plain_version_on_the_cpu_and_refusals():
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(3, 5, 8, generator=g), torch.randn(8, 6, generator=g)
    assert torch.equal(fm.fixed_matmul(x, w), torch.matmul(x, w))
    with pytest.raises(TypeError):
        fm.fixed_matmul(x.double(), w.double())
    with pytest.raises(ValueError):
        fm.fixed_matmul(x, w.t())


def _spy(monkeypatch):
    calls = []

    def spy(x, w):
        calls.append((tuple(x.shape), tuple(w.shape)))
        return fm.fixed_matmul_plain(x, w)
    monkeypatch.setattr(feedforward, "fixed_matmul", spy)
    return calls


def test_only_the_pins_products_take_it(monkeypatch):
    """A pin's forward runs every dense product (4 a block and the head)
    through fixed_matmul, float32 and int8 alike, and its answer is the
    network's; ``output`` and ``fit`` do not, and the flag is the calling
    thread's alone, off again after the call."""
    calls = _spy(monkeypatch)
    net = MultiLayerNetwork(transformer_lm(16, width=16, n_layers=2,
                                           n_heads=2, max_len=8),
                            device="cpu").init(seed=1)
    ids = np.random.default_rng(0).integers(0, 16, (3, 8)).astype(np.float32)
    want = net.output(ids)
    assert calls == [] and not fm.row_invariant()
    for quant in (None, "int8"):
        calls.clear()
        out = make_predict_fn(net, device="cpu", quant=quant)(ids)
        assert len(calls) == 2 * 4 + 1
        assert {w for _x, w in calls} == {(16, 48), (16, 16), (16, 64),
                                          (64, 16)}
        if quant is None:
            assert torch.equal(out, want)
        assert not fm.row_invariant()
    calls.clear()
    x = torch.nn.functional.one_hot(torch.from_numpy(ids).long(), 16).float()
    net.fit(x.numpy(), x.numpy())
    assert calls == []
