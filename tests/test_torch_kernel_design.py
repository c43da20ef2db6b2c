"""The arithmetic and the launch plans of the port's redesigned kernels, held
on the CPU (the kernels themselves run only on the card, where
``test_torch_cuda_kernels.py`` holds them against their plain versions).

``csrc/flash_fwd.cu`` computes both of its products on TF32 tensor cores
and keeps float32 accuracy by splitting each operand into ``hi = tf32(a)``
and ``lo = tf32(a - hi)`` and summing ``hi.lo + lo.hi + hi.hi``; tf32()
drops the low 13 mantissa bits. Here that arithmetic is emulated in plain
PyTorch (TF32 products are exact in float32, and the tensor core sums them
in float32) and held against ``flash_fwd_plain`` within the kernel's 2e-5;
a single TF32 pass misses that tolerance, which is why the split exists.

``csrc/int8_matmul.cu`` splits K into slices per ``int8_matmul_plan``: every
K index must be covered exactly once, and the grid must reach the card's SM
count at every decode shape.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import flash_attention as tfa
from deeplearning4j_tpu_torch.ops import quant as tq

#: the flash kernel's tolerance against its plain version (float32)
FLASH_TOL = 2e-5
#: H100 SXM
SMS = 132
#: the decode step's int8 products (K, N): Wqkv, Wo and the head, W1, W2
DECODE_KN = [(256, 768), (256, 256), (256, 1024), (1024, 256)]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Truncate float32 to TF32: zero the low 13 mantissa bits."""
    bits = x.contiguous().view(torch.int32) & -8192  # 0xffffe000
    return bits.view(torch.float32)


def split_mm(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """``a @ b`` as the kernel's TF32 mma computes it: three passes
    (``hi.lo + lo.hi + hi.hi``) or, with ``passes=1``, ``hi.hi`` alone."""
    ah, bh = tf32(a), tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = tf32(a - ah), tf32(b - bh)
    return (ah @ bl + al @ bh) + ah @ bh


def emulated_flash_fwd(q, k, v, causal, key_mask, passes):
    """The kernel's forward with its two products emulated: ``S =
    (q / sqrt(D)) . k^T`` and ``P . V``, the -1e30 mask conventions, ``l``
    clamped at 1e-20."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    qf = (q * (1.0 / D ** 0.5)).permute(0, 2, 1, 3)
    kf, vf = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    s = split_mm(qf, kf.transpose(-1, -2), passes)
    neg = torch.tensor(tfa.NEG)
    if key_mask is not None:
        s = torch.where(key_mask[:, None, None, :] > 0, s, neg)
    if causal:
        s = torch.where(torch.arange(Tq)[:, None] >= torch.arange(Tk)[None, :],
                        s, neg)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s <= tfa.NEG, torch.zeros_like(s), torch.exp(s - m))
    l_safe = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-20)
    out = split_mm(p, vf, passes) / l_safe
    lse = (m + torch.log(l_safe))[..., 0].reshape(B * H, Tq)
    return out.permute(0, 2, 1, 3), lse


def _inputs(T, D, masked, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, T, 4, D))
                                .astype(np.float32)) for _ in range(3))
    km = None
    if masked:
        m = (rng.random((2, T)) > 0.25).astype(np.float32)
        m[1, :] = 0.0  # every query row of batch 1 sees no key at all
        km = torch.from_numpy(m)
    return q, k, v, km


@pytest.mark.parametrize("causal,masked", [(True, False), (False, True),
                                           (True, True)])
@pytest.mark.parametrize("T,D", [(100, 32), (100, 64), (256, 32), (256, 64)])
def test_split_tf32_forward_holds_float32_tolerance(T, D, causal, masked):
    q, k, v, km = _inputs(T, D, masked, seed=T + D)
    ro, rl = tfa.flash_fwd_plain(q, k, v, causal, key_mask=km)
    out, lse = emulated_flash_fwd(q, k, v, causal, km, passes=3)
    torch.testing.assert_close(out, ro, rtol=0, atol=FLASH_TOL)
    torch.testing.assert_close(lse, rl, rtol=0, atol=FLASH_TOL)
    # one TF32 pass is about 1e-3 off: the split is what keeps float32
    out1, lse1 = emulated_flash_fwd(q, k, v, causal, km, passes=1)
    err1 = max(float((out1 - ro).abs().max()), float((lse1 - rl).abs().max()))
    assert err1 > FLASH_TOL, err1
    if masked:
        assert not out[1].any()


def test_tf32_split_is_exact_and_drops_13_bits():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32))
    hi = tf32(x)
    lo = tf32(x - hi)
    assert not (hi.view(torch.int32) & 8191).any()
    assert not (lo.view(torch.int32) & 8191).any()
    # hi + lo keeps 22 of float32's 24 significant bits
    assert float(((hi + lo - x) / x).abs().max()) < 2.0 ** -21


def _decode_shapes():
    return [(M, K, N) for M in range(1, 17) for K, N in DECODE_KN]


@pytest.mark.parametrize("M,K,N", _decode_shapes()
                         + [(1, 1, 16), (3, 0, 5), (300, 4096, 4096),
                            (7, 1000, 130), (16, 4096, 11008)])
def test_int8_plan_covers_k_once(M, K, N):
    kc, slices = tq.int8_matmul_plan(M, K, N, SMS)
    assert kc >= 1 and slices >= 1
    covered = np.zeros(K, np.int64)
    for s in range(slices):
        lo, hi = s * kc, min(K, (s + 1) * kc)
        assert lo < hi or K == 0  # no empty slice
        covered[lo:hi] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("M,K,N", _decode_shapes())
def test_int8_plan_fills_the_card_at_decode_shapes(M, K, N):
    kc, slices = tq.int8_matmul_plan(M, K, N, SMS)
    tiles = -(-N // tq.INT8_BN) * -(-M // tq.INT8_BM)
    assert tiles * slices >= SMS


@pytest.mark.parametrize("M,K,N", [(8, 256, 1024), (2, 256, 256),
                                   (5, 1000, 384), (16, 1024, 256)])
def test_int8_split_k_sum_matches_plain(M, K, N):
    """The kernel's arithmetic: per-slice float32 partial sums added in slice
    order, then the per-channel scale once. Tolerance: float32 sums in
    another order, as on the card (atol 1e-4, rtol 1e-5)."""
    rng = np.random.default_rng(M + K + N)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    leaf = tq.quantize_per_channel(torch.from_numpy(
        rng.standard_normal((K, N)).astype(np.float32)))
    kc, slices = tq.int8_matmul_plan(M, K, N, SMS)
    acc = torch.zeros(M, N)
    for s in range(slices):
        sl = slice(s * kc, min(K, (s + 1) * kc))
        acc = acc + x[:, sl] @ leaf.q[sl].to(torch.float32)
    out = acc * leaf.scale
    torch.testing.assert_close(out, tq.int8_matmul_plain(x, leaf.q, leaf.scale),
                               rtol=1e-5, atol=1e-4)
