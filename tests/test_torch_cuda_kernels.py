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

from deeplearning4j_tpu_torch.ops import fixed_matmul as tfm
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


#: fixed_matmul against cuBLAS in float32 on outputs of unit scale
FIXED_MM_TOL = 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", [(256, 768), (256, 256), (256, 1024),
                                 (1024, 256), (100, 70), (1000, 256),
                                 (1000, 20), (1001, 20)])
def test_fixed_matmul_rows_bitwise_across_m_on_card(cuda_device, K, N):
    """C3: each dense product of a serving pin (Wqkv, Wo, W1, W2 and the
    head of transformer_lm(256)), and ragged shapes (N % 4 != 0; K = 1,000,
    no multiple of the plan's chunk; N = 20, under one tile; K = 1,001, no
    multiple of 4): a row comes out of fixed_matmul with the same bits at
    every row count M from 1 to 4,096, within FIXED_MM_TOL of the plain
    version, on the float32 weight and on the int8 route's dequantized
    one; and alike from an operand that is not 16-byte aligned (copied 4
    bytes at a time)."""
    g = torch.Generator().manual_seed(K + N)
    x = torch.randn(4096, K, generator=g).to(cuda_device)
    w32 = torch.randn(K, N, generator=g) / K ** 0.5
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = tfm.fixed_matmul_plan(4096, K, N, sms)
    if K == 1000:
        assert K % plan.chunk
    if K == 1001:
        assert K % 4
    if N == 20:
        assert N < plan.bn
    for w in (w32, tq.dequantize_leaf(tq.quantize_per_channel(w32))):
        w = w.to(cuda_device)
        before = tfm.fixed_matmul.launches
        whole = tfm.fixed_matmul(x, w)
        assert tfm.fixed_matmul.launches == before + 1
        assert float((whole - tfm.fixed_matmul_plain(x, w)).abs().max()) \
            <= FIXED_MM_TOL
        for M in (1, 2, 3, 7, 64, 255, 512, 1000, 1024, 2048):
            assert torch.equal(tfm.fixed_matmul(x[:M], w), whole[:M]), M
        shifted = torch.empty(x.numel() + 1, device=cuda_device)[1:]
        shifted = shifted.view(x.shape).copy_(x)
        assert torch.equal(tfm.fixed_matmul(shifted, w), whole)


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
                                       (30, 2047, torch.bfloat16),
                                       # LeNet's C = 10 (22 of a warp's 32
                                       # lanes idle): a training batch, one
                                       # score_examples row, a test set
                                       (128, 10, torch.float32),
                                       (1, 10, torch.float32),
                                       (10000, 10, torch.float32),
                                       (128, 10, torch.bfloat16),
                                       (1, 10, torch.bfloat16),
                                       (10000, 10, torch.bfloat16),
                                       # ResNet-50's fc output at B = 128
                                       (128, 1000, torch.float32)])
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
    _check_flash_bwd(cuda_device, 2, 4 if D <= 128 else 2, T, D, causal,
                     masked, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,T,D,causal,masked,dtype", [
    # flash_wide.cu's 4 tile splits given uneven or empty work: 11 key
    # tiles over 4 splits under a causal mask at one head; a ragged T with a
    # fully masked batch row at D = 512; causal and masked in bfloat16; and
    # T = 19, fewer tiles than splits
    (1, 1, 333, 256, True, False, torch.float32),
    (2, 2, 45, 512, False, True, torch.float32),
    (2, 2, 77, 256, True, True, torch.bfloat16),
    (2, 2, 19, 160, False, False, torch.float32)])
def test_flash_bwd_wide_splits_match_plain_on_card(cuda_device, B, H, T, D,
                                                    causal, masked, dtype):
    _check_flash_bwd(cuda_device, B, H, T, D, causal, masked, dtype)


def _check_flash_bwd(cuda_device, B, H, T, D, causal, masked, dtype):
    """dQ and dK/dV at [B, T, H, D] within the tolerance of their plain
    versions, one launch each, and bitwise the same from run to run."""
    g = torch.Generator().manual_seed(1)
    q, k, v, do = (torch.randn(B, T, H, D, generator=g).to(cuda_device)
                   .to(dtype) for _ in range(4))
    km = None
    if masked:
        km = (torch.rand(B, T, generator=g) > 0.25).float()
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


#: bfloat16 operands: the kernel and the plain version work in float32 from
#: the same bf16 inputs, so their float32 results agree to the float32
#: tolerances above; each rounds them to bf16 on its own, which may part
#: them by one bf16 ulp, at most 2^-7 of the value
LSTM_BF16_RTOL = 2.0 ** -7

#: char_rnn's two layers (T = 50, B = 32, F = 64 and 200, H = 200), the
#: decode step, a ragged H with a ragged mask, and a batch whose c carry
#: does not fit in shared memory with weights read from global memory
LSTM_BF16_CASES = [(50, 32, 64, 200, True, False),
                   (50, 32, 200, 200, True, True),
                   (1, 8, 64, 200, True, False), (1, 3, 5, 37, True, True),
                   (7, 3, 5, 37, False, True), (3, 6000, 64, 1100, True, True)]


def _bf16(a: dict) -> dict:
    return {k: None if v is None else v.to(torch.bfloat16)
            for k, v in a.items()}


def _close_bf16(got, ref, atol):
    """Each element within one bf16 ulp of the reference plus ``atol``."""
    assert got.dtype == ref.dtype == torch.bfloat16
    g, r = got.float(), ref.float()
    excess = float(((g - r).abs() - (LSTM_BF16_RTOL * r.abs() + atol)).max())
    assert excess <= 0, excess


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,F,H,peephole,masked", LSTM_BF16_CASES)
def test_lstm_fwd_bf16_kernel_matches_plain_on_card(cuda_device, T, B, F, H,
                                                    peephole, masked):
    tl, a = _lstm_inputs(cuda_device, T, B, F, H, peephole, masked, seed=8)
    a = _bf16(a)
    before = tl.lstm_fwd.launches
    out = tl.lstm_fwd(**a)
    torch.cuda.synchronize()
    assert tl.lstm_fwd.launches == before + 1
    for got, ref in zip(out, tl.lstm_fwd_plain(**a)):
        _close_bf16(got, ref, LSTM_FWD_TOL)
    if masked:  # the fully masked row keeps its initial state everywhere
        assert torch.equal(out[0][:, 0], a["h0"][0].expand(T, H))
    assert all(torch.equal(x, y) for x, y in zip(tl.lstm_fwd(**a), out))


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,F,H,peephole,masked", LSTM_BF16_CASES)
def test_lstm_bwd_bf16_kernel_matches_plain_on_card(cuda_device, T, B, F, H,
                                                    peephole, masked):
    tl, a = _lstm_inputs(cuda_device, T, B, F, H, peephole, masked, seed=9)
    a = _bf16(a)
    ys, cs, _, _ = tl.lstm_fwd_plain(**a)
    g = torch.Generator().manual_seed(10)
    dys, dht, dct = (torch.randn(*s, generator=g).to(cuda_device,
                                                     torch.bfloat16)
                     for s in ((T, B, H), (B, H), (B, H)))
    args = dict(x_t=a["x_t"], hprev=torch.cat([a["h0"][None], ys[:-1]]),
                cprev=torch.cat([a["c0"][None], cs[:-1]]), wcat=a["wcat"],
                b=a["b"], peep=a["peep"], dys=dys, dht=dht, dct=dct,
                m_t=a["m_t"])
    before = tl.lstm_bwd.launches
    out = tl.lstm_bwd(**args)
    torch.cuda.synchronize()
    assert tl.lstm_bwd.launches == before + 1
    ref = tl.lstm_bwd_plain(**args)
    # dx in bf16 (one ulp beside the float32 bound), the rest float32
    _close_bf16(out[0], ref[0], LSTM_BWD_ATOL
                + LSTM_BWD_RTOL * float(ref[0].float().abs().max()))
    for got, r in zip(out[1:], ref[1:]):
        assert got.dtype == torch.float32
        _close_to_scale(got, r)
    assert all(torch.equal(x, y) for x, y in zip(tl.lstm_bwd(**args), out))


@pytest.mark.cuda
def test_lstm_kernels_refuse_other_dtypes_on_card(cuda_device):
    """No cast behind the caller's back: float16 operands, or operands of
    two dtypes, raise on the card instead of running another dtype."""
    tl, a = _lstm_inputs(cuda_device, 4, 2, 5, 8, True, False)
    with pytest.raises(TypeError):
        tl.lstm_fwd(**{k: v.half() for k, v in a.items()})
    with pytest.raises(TypeError):
        tl.lstm_fwd(**{**a, "x_t": a["x_t"].to(torch.bfloat16)})


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


@pytest.mark.cuda
def test_lenet_fit_step_on_card_matches_cpu(cuda_device):
    """One ``fit`` step of full-width LeNet at B = 128 on the card against
    the CPU from the same weights: the loss within 1e-4 relative, every
    param within 1e-4 of its CPU value, the output within 1e-4, and one
    ``sm_xent`` launch (cuDNN's convolutions, TF32 off, sum in another
    order)."""
    from deeplearning4j_tpu_torch.models import lenet_mnist
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    net = MultiLayerNetwork(lenet_mnist(), device=cuda_device).init(seed=1)
    ref = net.clone(device="cpu")
    rng = np.random.default_rng(0)
    x = rng.random((128, 784)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 128)]
    before = tsx.softmax_cross_entropy.launches
    net.fit(x, y)
    torch.cuda.synchronize()
    assert tsx.softmax_cross_entropy.launches == before + 1
    ref.fit(x, y)
    assert abs(net.score_value - ref.score_value) <= 1e-4 * ref.score_value
    for a, b in zip(net.params_list, ref.params_list):
        for k in a:
            torch.testing.assert_close(a[k].detach().cpu(), b[k].detach(),
                                       rtol=0, atol=1e-4)
    torch.testing.assert_close(net.output(x[:16]).cpu(), ref.output(x[:16]),
                               rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_max_pool_ties_route_as_on_the_cpu_on_card(cuda_device):
    """Max pooling over tied inputs (0, 1, 2) on the card gives each window's
    gradient to the same element as the CPU, which the CPU tests hold to
    XLA's routing: the gradients are equal."""
    from deeplearning4j_tpu_torch.nn.conf.layers import SubsamplingLayer
    from deeplearning4j_tpu_torch.nn.conf.multilayer import (
        GlobalConf, LayerConf, bake_layer_defaults)
    rng = np.random.default_rng(1)
    x = rng.integers(0, 3, (4, 24, 24, 20)).astype(np.float32)
    ct = rng.standard_normal((4, 12, 12, 20)).astype(np.float32)
    grads = []
    for dev in ("cpu", cuda_device):
        lc = SubsamplingLayer.conf(pooling_type="max")
        layer = SubsamplingLayer(LayerConf(lc.type, bake_layer_defaults(
            lc.fields, GlobalConf())), torch.device(dev))
        xt = torch.tensor(x, device=dev, requires_grad=True)
        (layer.apply({}, xt) * torch.tensor(ct, device=dev)).sum().backward()
        grads.append(xt.grad.cpu())
    assert torch.equal(grads[0], grads[1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(128, 56, 56, 64), (128, 7, 7, 2048),
                                   (8, 1000)])
def test_batch_norm_on_card_matches_cpu(cuda_device, shape):
    """``batch_norm_train`` (ResNet-50 shapes: the first stage, the last
    stage, features) forward, its statistics and its backward on the card
    against the CPU from the same inputs: within 1e-4 of each tensor's
    largest magnitude (float32 sums of up to 401,408 terms in another
    order)."""
    from deeplearning4j_tpu_torch.ops.batch_norm import batch_norm_train
    g = torch.Generator().manual_seed(2)
    c = shape[-1]
    x = torch.randn(shape, generator=g) * 2 + 0.5
    gamma = torch.rand(c, generator=g) + 0.5
    beta = torch.randn(c, generator=g)
    ct = torch.randn(shape, generator=g)
    got = []
    for dev in ("cpu", cuda_device):
        xs = [t.to(dev, copy=True).requires_grad_(True)
              for t in (x, gamma, beta)]
        out, mean, var = batch_norm_train(*xs, 1e-5)
        (out * ct.to(dev)).sum().backward()
        got.append([t.detach().cpu() for t in
                    (out, mean, var, *(v.grad for v in xs))])
    for a, b in zip(*got):
        err = float((b - a).abs().max())
        assert err <= 1e-4 * float(a.abs().max()), err


#: a captured K-step group against eager single steps on the card from one
#: init: the same kernels on the same inputs (cuDNN deterministic, so its
#: algorithms accumulate alike in both), but the learning rate and
#: Adam's bias correction computed on the card instead of the host (an ulp
#: of a scalar a step), so losses within 1e-5 relative and params within
#: 1e-5 of each leaf's largest magnitude
KSTEP_TOL = 1e-5


def _kstep_net(model, device):
    from deeplearning4j_tpu_torch.models import (
        char_rnn_lstm, lenet_mnist, resnet18, transformer_lm)
    from deeplearning4j_tpu_torch.nn.graph_network import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    if model == "resnet18":
        return ComputationGraph(resnet18(n_classes=10, image_size=32),
                                device=device).init()
    conf = {"lenet": lambda: lenet_mnist(),
            "transformer": lambda: transformer_lm(32, width=64, n_layers=1,
                                                  n_heads=2, max_len=16),
            "lstm": lambda: char_rnn_lstm(16, hidden=32)}[model]()
    if model == "lstm":  # full-sequence backprop: the K-step path takes it
        conf.backprop_type = "Standard"
    return MultiLayerNetwork(conf, device=device).init()


def _kstep_batches(model, n):
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.graph_network import MultiDataSet
    rng = np.random.default_rng(4)
    out = []
    for _ in range(n):
        if model == "lenet":
            x = rng.random((16, 784), dtype=np.float32)
            y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 16)]
        elif model == "resnet18":
            x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
            y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 4)]
            out.append(MultiDataSet([x], [y]))
            continue
        else:
            v = 32 if model == "transformer" else 16
            x = np.eye(v, dtype=np.float32)[rng.integers(0, v, (4, 12))]
            y = x
        out.append(DataSet(x, y))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["lenet", "transformer", "lstm", "resnet18"])
def test_ksteps_on_card_match_single_steps(cuda_device, model, monkeypatch):
    """``fit_iterator(ksteps=3)`` over 7 batches (groups of 3 and 3 replayed
    from one captured step, then a single step) and ``fit(epochs=4)``
    against single steps on the card from one init: losses, params, batch
    norm's running statistics, and the exact launches of every kernel (each
    replay adds its capture's count)."""
    from deeplearning4j_tpu_torch.ops import _cuda
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    a = _kstep_net(model, cuda_device)
    b = a.clone()
    data = _kstep_batches(model, 7)
    runs = []
    for net, k in ((a, 3), (b, 1)):
        losses = []

        class Rec:
            def iteration_done(self, model_, it):
                losses.append(model_.score_value)

        net.set_listeners(Rec())
        before = _cuda.launch_counts()
        net.fit_iterator(data, ksteps=k)
        net.dispatch_ksteps = 4 if k > 1 else 1
        net.fit(data[0] if model == "resnet18" else data[0].features,
                None if model == "resnet18" else data[0].labels, epochs=4)
        torch.cuda.synchronize()
        after = _cuda.launch_counts()
        runs.append((losses, {f.__name__: after[f] - before[f]
                              for f in before if after[f] != before[f]}))
    assert len(a._step_graphs) == 1
    # 2 + 3 replays in the epoch (a group's first step captures), 4 in fit
    assert next(iter(a._step_graphs.values())).replays == 2 + 3 + 4
    assert runs[0][1] == runs[1][1] and runs[0][1]
    torch.testing.assert_close(torch.tensor(runs[0][0]),
                               torch.tensor(runs[1][0]), rtol=KSTEP_TOL,
                               atol=0)
    for own, other in ((a.params_list, b.params_list),
                       (a.state_list, b.state_list)):
        items = own.items() if isinstance(own, dict) else enumerate(own)
        for i, leaves in items:
            for k, v in leaves.items():
                w = other[i][k].detach()
                err = float((v.detach() - w).abs().max())
                assert err <= KSTEP_TOL * max(float(w.abs().max()), 1e-3), \
                    (i, k, err)


@pytest.mark.cuda
def test_ksteps_capture_failure_raises(cuda_device, monkeypatch):
    """A step that syncs with the host cannot be captured: the K-step path
    raises and names it; it does not fall back to single steps."""
    from deeplearning4j_tpu_torch.nn.conf.layers.feedforward import DenseLayer
    net = _kstep_net("lenet", cuda_device)
    apply = DenseLayer.apply

    def syncing(self, params, x, *args, **kw):
        float(x.sum())  # a host sync inside the step
        return apply(self, params, x, *args, **kw)

    monkeypatch.setattr(DenseLayer, "apply", syncing)
    with pytest.raises(RuntimeError, match="capturing the train step"):
        net.fit_iterator(_kstep_batches("lenet", 3), ksteps=3)


@pytest.mark.cuda
def test_ksteps_ragged_shapes_share_one_pool_on_card(cuda_device,
                                                     monkeypatch):
    """An epoch of two batch shapes (3 of 16 rows, then 3 of 8) captures a
    step for each, both into the network's one memory pool, and still
    trains as single steps do (KSTEP_TOL)."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    a = _kstep_net("lenet", cuda_device)
    b = a.clone()
    data = _kstep_batches("lenet", 6)
    data = data[:3] + [DataSet(d.features[:8], d.labels[:8])
                       for d in data[3:]]
    a.fit_iterator(data, ksteps=3)
    b.fit_iterator(data, ksteps=1)
    torch.cuda.synchronize()
    graphs = list(a._step_graphs.values())
    assert len(graphs) == 2 and all(g.replays == 2 for g in graphs)
    assert graphs[0].pool == graphs[1].pool == a._graph_pool
    assert graphs[0].graph.pool() == graphs[1].graph.pool()
    for own, other in zip(a.params_list, b.params_list):
        for k, v in own.items():
            err = float((v - other[k]).abs().max())
            assert err <= KSTEP_TOL * max(float(other[k].abs().max()), 1e-3)
    a.set_params(a.params())
    assert a._step_graphs == {} and a._graph_pool is None


@pytest.mark.cuda
def test_monitored_ksteps_on_card_are_bitwise_unmonitored(cuda_device):
    """``fit(epochs=8)`` in groups of 4 with ``HealthMonitor(cadence=4)``:
    the health graph replays each group's first step, the plain graph the
    rest, both in the network's one pool and from its one capture stream;
    params and losses bitwise the unmonitored fit's, two checks, the same
    launches a replay in both graphs, and the second capture grows the
    pool by less than the first."""
    from deeplearning4j_tpu_torch.observability import (
        HealthMonitor, NanAlertListener)
    a = _kstep_net("transformer", cuda_device)
    b = a.clone()
    data = _kstep_batches("transformer", 1)[0]
    losses = ([], [])
    for net, seen, monitored in ((a, losses[0], True), (b, losses[1], False)):
        class Rec:
            def iteration_done(self, model_, it, seen=seen):
                seen.append(float(model_.score_value))

        net.dispatch_ksteps = 4
        listeners = [Rec()]
        if monitored:
            HealthMonitor(cadence=4).attach(net)
            listeners.insert(0, NanAlertListener())
        net.set_listeners(*listeners)
        net.fit(data.features, data.labels, epochs=8)
    torch.cuda.synchronize()
    assert losses[0] == losses[1]
    for own, other in zip(a.params_list, b.params_list):
        for k, v in own.items():
            assert torch.equal(v, other[k]), k
    hm = a.health_monitor
    hm.poll()
    assert hm.checks == 2 and hm.last["iteration"] == 4
    graphs = {sg.health: sg for sg in a._step_graphs.values()}
    assert set(graphs) == {True, False}
    assert graphs[True].per_replay == graphs[False].per_replay
    assert graphs[True].pool == graphs[False].pool == a._graph_pool
    assert graphs[True].stream is graphs[False].stream is a._capture_stream
    assert graphs[False].pool_bytes < graphs[True].pool_bytes


@pytest.mark.cuda
def test_ksteps_stage_dtype_on_card(cuda_device, monkeypatch):
    """``stage_dtype=torch.bfloat16`` on the card: the K-step epoch and
    ``fit(epochs=4)`` stage bfloat16 features and train as single steps on
    features rounded to bfloat16 first (KSTEP_TOL)."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    a = _kstep_net("lenet", cuda_device)
    b = a.clone()
    a.stage_dtype = torch.bfloat16
    data = _kstep_batches("lenet", 6)
    rounded = [DataSet(torch.from_numpy(d.features).to(torch.bfloat16)
                       .float().numpy(), d.labels) for d in data]
    a.fit_iterator(data, ksteps=3)
    staged = a.prefetcher.bytes
    a.fit(data[0].features, data[0].labels, epochs=4)
    b.fit_iterator(rounded, ksteps=1)
    b.dispatch_ksteps = 1
    b.fit(rounded[0].features, rounded[0].labels, epochs=4)
    torch.cuda.synchronize()
    assert staged == sum(d.features.nbytes // 2 + d.labels.nbytes
                         for d in data)
    for own, other in zip(a.params_list, b.params_list):
        for k, v in own.items():
            err = float((v - other[k]).abs().max())
            assert err <= KSTEP_TOL * max(float(other[k].abs().max()), 1e-3)


@pytest.mark.cuda
def test_ksteps_policy_flip_recaptures_on_card(cuda_device, monkeypatch):
    """A network whose config names no dtype policy follows the ambient
    one: after ``fit(epochs=4)`` under float32, the same batch under
    ``bfloat16_full`` captures a second step (keyed by the effective
    policy) instead of replaying the float32 graph, and trains as bf16
    single steps do; a config that names a policy keeps one graph whatever
    the ambient policy."""
    from deeplearning4j_tpu_torch import common
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    a = _kstep_net("lenet", cuda_device)
    b = a.clone()
    d = _kstep_batches("lenet", 1)[0]
    a.dispatch_ksteps = b.dispatch_ksteps = 4
    try:
        a.fit(d.features, d.labels, epochs=4)
        common.full_bf16_policy()
        a.fit(d.features, d.labels, epochs=4)
        assert len(a._step_graphs) == 2
        assert a.output(d.features).dtype == torch.bfloat16
        common.set_policy(torch.float32, torch.float32, torch.float32)
        b.fit(d.features, d.labels, epochs=4)
        common.full_bf16_policy()
        b.dispatch_ksteps = 1
        b.fit(d.features, d.labels, epochs=4)
    finally:
        common.set_policy(torch.float32, torch.float32, torch.float32,
                          reduction_dtype=None, grad_accum_dtype=None)
    for own, other in zip(a.params_list, b.params_list):
        for k, v in own.items():
            err = float((v - other[k]).abs().max())
            assert err <= KSTEP_TOL * max(float(other[k].abs().max()), 1e-3)
    pinned = _kstep_net("lenet", cuda_device)
    pinned.conf.global_conf.dtype = "bfloat16_full"
    pinned.dispatch_ksteps = 4
    try:
        pinned.fit(d.features, d.labels, epochs=4)
        common.flagship_bf16_policy()
        pinned.fit(d.features, d.labels, epochs=4)
    finally:
        common.set_policy(torch.float32, torch.float32, torch.float32,
                          reduction_dtype=None, grad_accum_dtype=None)
    assert len(pinned._step_graphs) == 1


def _leaf_pairs(a, b):
    """``(path, tensor_a, tensor_b)`` over two trees of one structure."""
    from deeplearning4j_tpu_torch.utils.pytree import leaves_with_paths
    la, lb = list(leaves_with_paths(a)), list(leaves_with_paths(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    return [(p, x, y) for (p, x), (_, y) in zip(la, lb)]


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["lenet", "resnet18"])
def test_model_file_restores_on_card_and_resumes_bitwise(cuda_device, model,
                                                         tmp_path,
                                                         monkeypatch):
    """A model zip written after 2 card steps restores on the card with
    every param, layer-state and updater-state leaf bitwise; with cuDNN
    deterministic, 2 more steps from the restored network and from the
    original give bitwise-equal losses and leaves. It also restores on the
    CPU, where its output is within 1e-4 of the card's."""
    from deeplearning4j_tpu_torch.utils import model_serializer as ser
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    net = _kstep_net(model, cuda_device)
    data = _kstep_batches(model, 4)

    def step(n, ds):
        if model == "resnet18":
            n.fit(ds)
        else:
            n.fit(ds.features, ds.labels)
        return n.score_value

    for ds in data[:2]:
        step(net, ds)
    path = str(tmp_path / "m.zip")
    ser.write_model(net, path)
    back = ser.guess_model(path, device=cuda_device)
    assert back.device.type == "cuda" and back.iteration == 2
    for own, ref in ((back.params_list, net.params_list),
                     (back.state_list, net.state_list),
                     (back.updater_state, net.updater_state)):
        for p, a, b in _leaf_pairs(own, ref):
            assert torch.equal(a, b), p
    x0 = data[0].features[0] if model == "resnet18" else data[0].features
    out = net.output(x0)
    out = out[0] if model == "resnet18" else out
    cpu = ser.guess_model(path, device="cpu").output(x0)
    cpu = cpu[0] if model == "resnet18" else cpu
    torch.testing.assert_close(out.cpu(), cpu, rtol=0, atol=1e-4)
    for ds in data[2:]:
        assert step(back, ds) == step(net, ds)
    for own, ref in ((back.params_list, net.params_list),
                     (back.state_list, net.state_list),
                     (back.updater_state, net.updater_state)):
        for p, a, b in _leaf_pairs(own, ref):
            assert torch.equal(a, b), p


@pytest.mark.cuda
def test_registry_warms_every_bucket_on_card(cuda_device, tmp_path):
    """``load`` into ``InferenceServer(warmup=True, max_batch=16)`` with an
    explicit example runs one forward a bucket on the card before the
    version is active, and the served answer is the restored network's."""
    from deeplearning4j_tpu_torch.keras_server import InferenceServer
    from deeplearning4j_tpu_torch.models import lenet_mnist
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.utils.model_serializer import write_model
    net = MultiLayerNetwork(lenet_mnist(), device=cuda_device).init(seed=2)
    path = str(tmp_path / "lenet.zip")
    write_model(net, path)
    srv = InferenceServer(device=cuda_device, warmup=True,
                          max_batch=16).start()
    try:
        mv = srv.load("lenet", path,
                      warmup_example=np.zeros((1, 784), np.float32))
        assert sorted(mv.predict_fn.warmed) == [1, 2, 4, 8, 16]
        assert mv.predict_fn.calls == 0
        x = np.random.default_rng(3).random((5, 784)).astype(np.float32)
        torch.testing.assert_close(mv.predict_fn(x), net.output(x),
                                   rtol=0, atol=1e-6)
    finally:
        srv.stop()


@pytest.mark.cuda
def test_lbfgs_on_card_follows_the_cpu(cuda_device):
    """Full-width LeNet, ``optimization_algo="lbfgs"``, ``iterations=10``
    on one batch of 128 on the card and from the same init on the CPU: the
    loss falls, the card's final loss within 1e-4 relative of the CPU's,
    and at least one ``sm_xent`` launch an iteration."""
    import dataclasses
    from deeplearning4j_tpu_torch.models import lenet_mnist
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = lenet_mnist()
    conf.global_conf = dataclasses.replace(
        conf.global_conf, optimization_algo="lbfgs", iterations=10)
    net = MultiLayerNetwork(conf, device=cuda_device).init(seed=4)
    ref = net.clone(device="cpu")
    rng = np.random.default_rng(5)
    x = rng.random((128, 784)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 128)]
    s0 = net.score(x, y)
    before = tsx.softmax_cross_entropy.launches
    net.fit(x, y)
    launches = tsx.softmax_cross_entropy.launches - before
    ref.fit(x, y)
    assert net.score_value < s0
    assert abs(net.score_value - ref.score_value) <= 1e-4 * ref.score_value
    assert net.iteration == ref.iteration and 0 < net.iteration <= 10
    assert launches >= net.iteration


def _ps_lm(device):
    from deeplearning4j_tpu_torch.models import transformer_lm
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    return MultiLayerNetwork(transformer_lm(32, width=64, n_layers=2,
                                           n_heads=2, max_len=32),
                             device=device).init(seed=3)


def _ps_batches(n=8, b=4, t=32, v=32, seed=0):
    g = np.random.default_rng(seed)
    return [np.eye(v, dtype=np.float32)[g.integers(0, v, (b, t))]
            for _ in range(n)]


@pytest.mark.cuda
def test_param_server_worker_on_card_equals_fit(cuda_device):
    """One inproc PS worker on the card (push frequency 4, 8 batches):
    each window lands at weight 1, so the params are fit's within the JAX
    suite's rtol 2e-4 atol 2e-5, and the worker's steps launch exactly the
    fit's kernels: each flash kernel once a layer a step, sm_xent once."""
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel.param_server import (
        ParameterServerParallelWrapper)
    xs = _ps_batches()
    ref = _ps_lm(cuda_device)
    for x in xs:
        ref.fit(x, x)
    net = _ps_lm(cuda_device)
    counted = (tfa.flash_fwd, tfa.flash_bwd_dq, tfa.flash_bwd_dkv,
               tsx.softmax_cross_entropy)
    for fn in counted:
        fn.launches = 0
    w = (ParameterServerParallelWrapper.builder(net).workers(1)
         .push_frequency(4).build())
    w.fit(ListDataSetIterator([DataSet(x, x) for x in xs]))
    assert w.server.pushes == 2
    assert [fn.launches for fn in counted] == [16, 16, 16, 8]
    got, want = net.params().cpu(), ref.params().cpu()
    assert bool(((got - want).abs() <= 2e-5 + 2e-4 * want.abs()).all())


@pytest.mark.cuda
def test_sharded_checkpoint_round_trips_on_card(cuda_device, tmp_path):
    """save_sharded then restore_sharded on the card: params, layer states
    and Adam's state bitwise, restored onto the card."""
    from deeplearning4j_tpu_torch.utils.sharded_checkpoint import (
        restore_sharded, save_sharded)
    net = _ps_lm(cuda_device)
    for x in _ps_batches(2):
        net.fit(x, x)
    back = restore_sharded(save_sharded(str(tmp_path / "ck"), net),
                           device=cuda_device)
    assert back.device.type == "cuda" and back.iteration == net.iteration
    for a, b in ((back.params_list, net.params_list),
                 (back.updater_state, net.updater_state)):
        for la, lb in zip(a, b):
            for k in lb:
                va, vb = la[k], lb[k]
                if isinstance(vb, dict):
                    assert all(torch.equal(va[s], vb[s]) for s in vb)
                else:
                    assert torch.equal(va, vb)
