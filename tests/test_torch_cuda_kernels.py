"""The port's CUDA kernels held against their plain PyTorch versions on the
card, at the tolerances stated below. Every test here is marked ``cuda`` and
skips without a card.

This file imports neither JAX nor ``deeplearning4j_tpu``, so it also runs
where only the port is installed. ``tests/conftest.py`` imports JAX, so there
run it without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py -q
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import flash_attention as tfa
from deeplearning4j_tpu_torch.ops import paged_attention as tpa
from deeplearning4j_tpu_torch.ops import quant as tq
from deeplearning4j_tpu_torch.ops import softmax_xent as tsx

#: float32 online softmax against the one-pass plain version
FLASH_TOL = 2e-5
#: bfloat16 inputs and output: one bfloat16 ulp of the output
FLASH_BF16_TOL = 2e-2
#: float32 backward sums in another order than the plain version's matmuls
FLASH_BWD_TOL = 2e-5
#: one bfloat16 ulp at magnitudes below 8
FLASH_BWD_BF16_TOL = 3.2e-2
#: loss: float32 row sums of up to 50,257 terms in another order
XENT_LOSS_TOL = 1e-5
XENT_GRAD_TOL = 1e-6
#: one bfloat16 ulp at magnitudes up to 1
XENT_BF16_GRAD_TOL = 4e-3


@pytest.fixture
def cuda_device():
    """The card; decided when the test runs, never at import, so every
    worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


#: int8_matmul: float32 sums in another order than cuBLAS; bf16 x is
#: widened exactly on both sides, so it keeps the float32 bound
INT8_ATOL, INT8_RTOL = 1e-4, 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,dtype", [
    (4, 256, 768, torch.float32),
    (16, 1024, 256, torch.float32),  # decode's W2 at full capacity
    (3, 200, 130, torch.float32),    # N % 16 != 0: codes read one by one
    (1, 256, 768, torch.float32),    # M = 1
    (2, 256, 256, torch.float32),    # the most K slices
    (5, 1000, 384, torch.float32),   # K not a multiple of the slice
    (16, 256, 768, torch.bfloat16)])
def test_int8_matmul_kernel_matches_plain_on_card(cuda_device, M, K, N, dtype):
    if (M, K, N) == (5, 1000, 384):
        sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
        kc, slices = tq.int8_matmul_plan(M, K, N, sms)
        assert slices > 1 and K % kc != 0
    g = torch.Generator().manual_seed(0)
    x = torch.randn(M, K, generator=g).to(cuda_device).to(dtype)
    leaf = tq.quantize_per_channel(torch.randn(K, N, generator=g).to(cuda_device))
    before = tq.int8_matmul.launches
    out = tq.int8_matmul(x, leaf.q, leaf.scale)
    torch.cuda.synchronize()
    assert tq.int8_matmul.launches == before + 1
    ref = tq.int8_matmul_plain(x, leaf.q, leaf.scale)
    torch.testing.assert_close(out, ref, rtol=INT8_RTOL, atol=INT8_ATOL)
    # bitwise the same from run to run: partials summed in slice order
    for _ in range(3):
        assert torch.equal(tq.int8_matmul(x, leaf.q, leaf.scale), out)


@pytest.mark.cuda
def test_paged_gather_kernel_bitwise_on_card(cuda_device):
    rng = np.random.default_rng(0)
    n_pages, ps, H, D, cap, P = 64, 16, 4, 64, 8, 8
    pool = rng.standard_normal((n_pages + 1, ps, H, D)).astype(np.float32)
    table = rng.integers(0, n_pages + 1, size=(cap, P)).astype(np.int32)
    table[0, -2:] = 0   # unmapped tail: the trash page
    table[2, :] = 0     # an inactive slot maps trash everywhere
    p = torch.from_numpy(pool).to(cuda_device)
    t = torch.from_numpy(table).to(cuda_device)
    before = tpa.paged_gather.launches
    out = tpa.paged_gather(p, t)
    torch.cuda.synchronize()
    assert tpa.paged_gather.launches == before + 1
    assert torch.equal(out, tpa.paged_gather_plain(p, t))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Tq,Tk,D,causal,masked,dtype", [
    (2, 4, 512, 512, 64, True, False, torch.float32),    # predict: 4 splits
    (16, 4, 256, 256, 64, True, False, torch.float32),   # train: 2 splits
    (2, 4, 100, 100, 64, False, True, torch.float32),
    (2, 4, 100, 100, 64, True, True, torch.float32),
    (2, 4, 100, 100, 32, True, False, torch.float32),    # D = 32
    (2, 4, 77, 200, 64, False, False, torch.float32),    # Tq != Tk
    (2, 4, 45, 19, 32, False, True, torch.float32),      # Tk below a tile
    (1, 1, 333, 333, 64, True, False, torch.float32),    # B * H = 1, ragged
    (2, 4, 130, 130, 64, True, True, torch.bfloat16),
    # head dims other than 32 and 64: the widths 16 and 128, and D padded
    # with zeros to the next width (8, 12 -> 16; 40 -> 64)
    (2, 4, 100, 100, 8, True, False, torch.float32),
    (2, 4, 100, 100, 16, True, True, torch.float32),
    (2, 4, 100, 100, 12, False, False, torch.float32),
    (2, 4, 100, 100, 40, True, False, torch.float32),
    (4, 4, 128, 128, 128, True, False, torch.float32),   # transformer_lm width 512
    (2, 4, 77, 200, 128, False, True, torch.float32),    # ragged, masked, D = 128
    (2, 4, 130, 130, 128, True, True, torch.bfloat16),
    (2, 4, 100, 100, 12, True, True, torch.bfloat16),
    # head dims above 128: flash_wide.cu's column groups (2, 2, 4)
    (2, 2, 100, 100, 160, True, False, torch.float32),
    (4, 2, 128, 128, 256, True, False, torch.float32),   # width 512, 2 heads
    (2, 2, 77, 200, 256, False, True, torch.float32),    # ragged, masked
    (2, 2, 100, 100, 512, True, True, torch.float32),
    (2, 2, 130, 130, 160, True, True, torch.bfloat16),
    (2, 2, 100, 100, 256, False, False, torch.bfloat16),
    (2, 2, 100, 100, 512, True, False, torch.bfloat16),
    # the tensor-core wide forward: key splits over a ragged Tk, Tq != Tk,
    # one batch-head with a long ragged sequence, D not a multiple of 4
    (2, 2, 77, 200, 160, False, True, torch.float32),
    (2, 2, 45, 19, 512, False, True, torch.float32),
    (1, 1, 333, 333, 256, True, False, torch.float32),
    (2, 2, 100, 100, 258, True, True, torch.float32),
    (2, 2, 77, 200, 256, True, True, torch.bfloat16)])
def test_flash_fwd_kernel_matches_plain_on_card(cuda_device, B, H, Tq, Tk, D,
                                                causal, masked, dtype):
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((B, Tq, H, D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, Tk, H, D))
                             .astype(np.float32)) for _ in range(2))
    q, k, v = (t.to(cuda_device).to(dtype) for t in (q, k, v))
    km = None
    if masked:
        m = (rng.random((B, Tk)) > 0.25).astype(np.float32)
        m[-1, :] = 0.0  # every query row of the last batch sees no key
        km = torch.from_numpy(m).to(cuda_device)
    before = tfa.flash_fwd.launches
    out, lse = tfa.flash_fwd(q, k, v, causal, key_mask=km)
    torch.cuda.synchronize()
    assert tfa.flash_fwd.launches == before + 1
    ro, rl = tfa.flash_fwd_plain(q, k, v, causal, key_mask=km)
    tol = FLASH_TOL if dtype == torch.float32 else FLASH_BF16_TOL
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), ro.float(), rtol=0, atol=tol)
    torch.testing.assert_close(lse, rl, rtol=0, atol=tol)
    if masked:
        assert not out[-1].any()
    # bitwise the same from run to run: no atomics, a fixed combine order
    for _ in range(2):
        o2, l2 = tfa.flash_fwd(q, k, v, causal, key_mask=km)
        assert torch.equal(o2, out) and torch.equal(l2, lse)


@pytest.mark.cuda
@pytest.mark.parametrize("N,C,dtype", [(4096, 256, torch.float32),
                                       (8, 50257, torch.float32),
                                       (300, 256, torch.bfloat16),
                                       # a warp a row: char_rnn's C = 64, a
                                       # ragged N, odd C, the widest row
                                       (1600, 64, torch.float32),
                                       (1601, 100, torch.float32),
                                       (37, 33, torch.float32),
                                       (64, 2048, torch.float32),
                                       (65, 2049, torch.float32),
                                       (300, 64, torch.bfloat16),
                                       (30, 2047, torch.bfloat16)])
def test_sm_xent_kernel_matches_plain_on_card(cuda_device, N, C, dtype):
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(N, C, generator=g) * 3).to(cuda_device).to(dtype)
    y = torch.nn.functional.one_hot(
        torch.randint(0, C, (N,), generator=g), C).float().to(cuda_device)
    before = tsx.softmax_cross_entropy.launches
    loss, grad = tsx.softmax_cross_entropy(x, y)
    torch.cuda.synchronize()
    assert tsx.softmax_cross_entropy.launches == before + 1
    rl, rg = tsx.softmax_cross_entropy_plain(x, y)
    torch.testing.assert_close(loss, rl, rtol=0, atol=XENT_LOSS_TOL)
    gtol = XENT_GRAD_TOL if dtype == torch.float32 else XENT_BF16_GRAD_TOL
    assert grad.dtype == dtype
    torch.testing.assert_close(grad.float(), rg.float(), rtol=0, atol=gtol)
    # bitwise the same from run to run: fixed-order sums
    again = tsx.softmax_cross_entropy(x, y)
    assert torch.equal(again[0], loss) and torch.equal(again[1], grad)


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,causal,masked,dtype", [
    (256, 64, True, False, torch.float32),
    (100, 64, False, True, torch.float32),
    (100, 64, True, True, torch.float32),
    (100, 32, True, False, torch.float32),
    (128, 64, True, False, torch.bfloat16),
    # head dims other than 32 and 64, padded where they are no width
    (100, 8, True, False, torch.float32),
    (100, 16, False, True, torch.float32),
    (100, 12, True, False, torch.float32),
    (100, 40, True, True, torch.float32),
    (128, 128, True, False, torch.float32),
    (100, 128, True, True, torch.float32),               # ragged, masked
    (100, 128, False, False, torch.bfloat16),
    (100, 8, True, True, torch.bfloat16),
    (100, 40, False, False, torch.bfloat16),
    # head dims above 128: flash_wide.cu's column groups
    (100, 160, True, False, torch.float32),
    (128, 256, True, False, torch.float32),
    (100, 256, False, True, torch.float32),
    (100, 512, True, True, torch.float32),
    (100, 160, False, True, torch.bfloat16),
    (128, 256, True, False, torch.bfloat16),
    (100, 512, False, False, torch.bfloat16)])
def test_flash_bwd_kernels_match_plain_on_card(cuda_device, T, D, causal,
                                                masked, dtype):
    g = torch.Generator().manual_seed(1)
    H = 4 if D <= 128 else 2
    q, k, v, do = (torch.randn(2, T, H, D, generator=g).to(cuda_device)
                   .to(dtype) for _ in range(4))
    km = None
    if masked:
        km = (torch.rand(2, T, generator=g) > 0.25).float()
        km[1] = 0.0  # every query row of batch 1 sees no key at all
        km = km.to(cuda_device)
    out, lse = tfa.flash_fwd(q, k, v, causal, key_mask=km)
    delta = tfa.bwd_delta(out, do)
    n_dq, n_dkv = tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches
    dq = tfa.flash_bwd_dq(q, k, v, do, lse, delta, causal, km)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, do, lse, delta, causal, km)
    torch.cuda.synchronize()
    assert tfa.flash_bwd_dq.launches == n_dq + 1
    assert tfa.flash_bwd_dkv.launches == n_dkv + 1
    rq = tfa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, km)
    rk, rv = tfa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, km)
    tol = FLASH_BWD_TOL if dtype == torch.float32 else FLASH_BWD_BF16_TOL
    for got, ref in ((dq, rq), (dk, rk), (dv, rv)):
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=tol)
    # bitwise the same from run to run: no atomics
    assert torch.equal(tfa.flash_bwd_dq(q, k, v, do, lse, delta, causal, km), dq)
    dk2, dv2 = tfa.flash_bwd_dkv(q, k, v, do, lse, delta, causal, km)
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv)
    if masked:  # batch 1 sees no key: no gradient reaches it
        assert not dq[1].any() and not dk[1].any() and not dv[1].any()


#: float32 cell forward: dot products over F + H terms in another order
LSTM_FWD_TOL = 2e-5
#: float32 backward: dW sums T * B = 1,600 rows in another order than the
#: plain version's matmul, so each output is held to 1e-4 of its own largest
#: entry (plus 1e-5)
LSTM_BWD_ATOL = 1e-5
LSTM_BWD_RTOL = 1e-4


def _close_to_scale(got, ref):
    err = float((got - ref).abs().max())
    assert err <= LSTM_BWD_ATOL + LSTM_BWD_RTOL * float(ref.abs().max()), err


def _lstm_inputs(dev, T, B, F, H, peephole, masked, seed=0):
    from deeplearning4j_tpu_torch.ops import lstm as tl
    g = torch.Generator().manual_seed(seed)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    m = torch.ones(T, B)
    if masked:
        m = (torch.rand(T, B, generator=g) > 0.3).float()
        m[:, 0] = 0.0  # a batch row masked at every step
    return tl, dict(x_t=r(T, B, F), wcat=r(F + H, 4 * H, scale=0.2),
                    b=r(1, 4 * H, scale=0.1),
                    peep=r(3, H, scale=0.3) if peephole else None,
                    h0=r(B, H, scale=0.5), c0=r(B, H, scale=0.5),
                    m_t=m.to(dev))


LSTM_CASES = [(50, 32, 64, 200, True, False), (50, 32, 200, 200, True, True),
              (1, 8, 64, 200, True, False), (7, 3, 5, 37, False, True),
              (50, 32, 64, 200, False, False), (50, 32, 200, 37, True, True),
              # the one-step route at the decode and stream widths, and a
              # ragged one (H % 4 != 0: h staged by plain loads)
              (1, 1, 64, 200, True, False), (1, 8, 200, 200, True, True),
              (1, 3, 5, 37, True, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,F,H,peephole,masked", LSTM_CASES)
def test_lstm_fwd_kernel_matches_plain_on_card(cuda_device, T, B, F, H,
                                               peephole, masked):
    tl, a = _lstm_inputs(cuda_device, T, B, F, H, peephole, masked)
    before = tl.lstm_fwd.launches
    out = tl.lstm_fwd(**a)
    torch.cuda.synchronize()
    assert tl.lstm_fwd.launches == before + 1
    for got, ref in zip(out, tl.lstm_fwd_plain(**a)):
        torch.testing.assert_close(got, ref, rtol=0, atol=LSTM_FWD_TOL)
    if masked:  # the fully masked row keeps its initial state everywhere
        assert torch.equal(out[0][:, 0], a["h0"][0].expand(T, H))
    # bitwise the same from run to run: every sum in a fixed order
    for _ in range(2):
        assert all(torch.equal(x, y) for x, y in zip(tl.lstm_fwd(**a), out))
    plan = tl.lstm_plan(T, B, F, H)
    assert plan["route"] == int(T > 1)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [6, 1])
@pytest.mark.parametrize("H", [400, 401, 700, 1100])
def test_lstm_fwd_wide_layers_match_plain_on_card(cuda_device, T, H):
    """Hidden widths whose plan takes more than 2 units a block on a 132-SM
    card: 4 (400; 401 with a last block of one unit), 6 (700) and 9 (1100,
    whose weight columns no longer fit in shared memory and are read from
    global memory), on both routes."""
    B, F = 8, 64
    tl, a = _lstm_inputs(cuda_device, T, B, F, H, True, True, seed=6)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = tl.lstm_plan(T, B, F, H)
    assert plan["units"] == max(2, -(-H // sms))
    assert plan["blocks"] == -(-H // plan["units"])
    if H == 1100:
        assert not plan["w_shared"]
    out = tl.lstm_fwd(**a)
    for got, ref in zip(out, tl.lstm_fwd_plain(**a)):
        torch.testing.assert_close(got, ref, rtol=0, atol=LSTM_FWD_TOL)
    assert all(torch.equal(x, y) for x, y in zip(tl.lstm_fwd(**a), out))


@pytest.mark.cuda
@pytest.mark.parametrize("B,c_shared", [(64, 1), (6000, 0)])
@pytest.mark.parametrize("H", [1100, 1101])
def test_lstm_fwd_large_batches_match_plain_on_card(cuda_device, B, c_shared,
                                                    H):
    """Batches whose h_{t-1} no longer fits in shared memory at once, so the
    recurrence restages it in chunks of batch rows (whole 16-byte chunks at
    H = 1100, plain loads at 1101), and at B = 6000 a c carry too large for
    shared memory, read back from cs through L2."""
    T, F = 3, 64
    tl, a = _lstm_inputs(cuda_device, T, B, F, H, True, True, seed=7)
    plan = tl.lstm_plan(T, B, F, H)
    assert plan["route"] == 1 and not plan["w_shared"]
    assert plan["rows"] < B and plan["c_shared"] == c_shared, plan
    out = tl.lstm_fwd(**a)
    for got, ref in zip(out, tl.lstm_fwd_plain(**a)):
        torch.testing.assert_close(got, ref, rtol=0, atol=LSTM_FWD_TOL)
    assert torch.equal(out[0][:, 0], a["h0"][0].expand(T, H))
    assert all(torch.equal(x, y) for x, y in zip(tl.lstm_fwd(**a), out))


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,F,H,peephole,masked", LSTM_CASES)
def test_lstm_bwd_kernel_matches_plain_on_card(cuda_device, T, B, F, H,
                                               peephole, masked):
    tl, a = _lstm_inputs(cuda_device, T, B, F, H, peephole, masked, seed=1)
    ys, cs, _, _ = tl.lstm_fwd_plain(**a)
    g = torch.Generator().manual_seed(2)
    dys, dht, dct = (torch.randn(*s, generator=g).to(cuda_device)
                     for s in ((T, B, H), (B, H), (B, H)))
    args = dict(x_t=a["x_t"], hprev=torch.cat([a["h0"][None], ys[:-1]]),
                cprev=torch.cat([a["c0"][None], cs[:-1]]), wcat=a["wcat"],
                b=a["b"], peep=a["peep"], dys=dys, dht=dht, dct=dct,
                m_t=a["m_t"])
    before = tl.lstm_bwd.launches
    out = tl.lstm_bwd(**args)
    torch.cuda.synchronize()
    assert tl.lstm_bwd.launches == before + 1
    for got, ref in zip(out, tl.lstm_bwd_plain(**args)):
        _close_to_scale(got, ref)
    # the same from run to run: fixed-order sums, no atomics
    assert all(torch.equal(x, y) for x, y in zip(tl.lstm_bwd(**args), out))


@pytest.mark.cuda
@pytest.mark.parametrize("H", [400, 401, 700, 1100])
def test_lstm_bwd_wide_layers_match_plain_on_card(cuda_device, H):
    """Hidden widths whose plan takes more than 2 units a recurrence block
    on a 132-SM card: 4 units a block (400; 401 with a last block of one
    unit), 6 (700, the 8-unit pass with a ragged last block) and 9 (1100:
    two passes, RW's rows read from global memory)."""
    T, B, F = 6, 8, 64
    tl, a = _lstm_inputs(cuda_device, T, B, F, H, True, True, seed=4)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = tl.lstm_bwd_plan(T, B, F, H, True)
    assert plan["units"] == max(2, -(-H // sms))
    assert plan["blocks"] == -(-H // plan["units"])
    ys, cs, _, _ = tl.lstm_fwd_plain(**a)
    g = torch.Generator().manual_seed(5)
    dys, dht, dct = (torch.randn(*s, generator=g).to(cuda_device)
                     for s in ((T, B, H), (B, H), (B, H)))
    args = dict(x_t=a["x_t"], hprev=torch.cat([a["h0"][None], ys[:-1]]),
                cprev=torch.cat([a["c0"][None], cs[:-1]]), wcat=a["wcat"],
                b=a["b"], peep=a["peep"], dys=dys, dht=dht, dct=dct,
                m_t=a["m_t"])
    out = tl.lstm_bwd(**args)
    for got, ref in zip(out, tl.lstm_bwd_plain(**args)):
        _close_to_scale(got, ref)
    assert all(torch.equal(x, y) for x, y in zip(tl.lstm_bwd(**args), out))


@pytest.mark.cuda
def test_lstm_sequence_gradients_on_card_match_cpu(cuda_device):
    from deeplearning4j_tpu_torch.ops import activations as ta
    from deeplearning4j_tpu_torch.ops import lstm as tl
    g = torch.Generator().manual_seed(3)
    B, T, F, H = 4, 9, 6, 10
    cpu = {"W": torch.randn(F, 4 * H, generator=g) * 0.3,
           "RW": torch.randn(H, 4 * H, generator=g) * 0.3,
           "b": torch.randn(4 * H, generator=g) * 0.1,
           "pI": torch.randn(H, generator=g) * 0.2,
           "pF": torch.randn(H, generator=g) * 0.2,
           "pO": torch.randn(H, generator=g) * 0.2}
    x = torch.randn(B, T, F, generator=g)
    mask = (torch.rand(B, T, generator=g) > 0.2).float()
    grads = []
    for dev in ("cpu", cuda_device):
        p = {k: v.to(dev).requires_grad_(True) for k, v in cpu.items()}
        z = torch.zeros(B, H, device=dev)
        n = (tl.lstm_fwd.launches, tl.lstm_bwd.launches)
        ys, _ = tl.lstm_sequence(p, x.to(dev), ta.tanh, ta.sigmoid, z, z,
                                 True, mask.to(dev))
        gr = torch.autograd.grad((ys * ys).sum(), list(p.values()))
        grads.append([t.cpu() for t in gr])
        if dev != "cpu":
            assert (tl.lstm_fwd.launches, tl.lstm_bwd.launches) == \
                (n[0] + 1, n[1] + 1)
    for a, b in zip(*grads):
        _close_to_scale(b, a)
