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
``csrc/flash_bwd.cu`` runs the backward's five products (S, dP, dQ, dK, dV)
the same way, with P and dS formed from the emulated S and dP; a head dim
that is no kernel width is padded with zero columns, which add exactly 0.
The tensor core's float32 accumulation truncates; ``tensor_core_mm``
emulates it, and shows why the backward sums each streamed tile apart and
carries it into the total with a float32 add.
``flash_plan`` picks every flash launch's width, key splits and shared
memory: it must cover every head dim from 1 to 128 within a block's limit.

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


def _pad(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` with zero columns up to the kernel width, as the kernels load
    a head dim that is no width."""
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def emulated_flash_bwd(q, k, v, do, lse, delta, causal, key_mask, passes):
    """The backward kernels' arithmetic: ``S = q.k^T * scale`` (scale of the
    true D) and ``dP = dO.v^T`` on operands padded to the kernel width, then
    ``P = exp(S - lse)`` (0 where masked) and ``dS = P (dP - delta) scale``,
    then ``dQ = dS.k``, ``dK = dS^T.q`` and ``dV = P^T.dO``, every product
    emulated; the padded columns are cut off the results."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    width = tfa.flash_plan("dq", D, B * H, Tq, SMS).width
    scale = 1.0 / D ** 0.5
    qf, kf, vf, gf = (_pad(t, width).permute(0, 2, 1, 3) for t in (q, k, v, do))
    s = split_mm(qf, kf.transpose(-1, -2), passes) * scale
    masked = torch.zeros(B, 1, Tq, Tk, dtype=torch.bool)
    if key_mask is not None:
        masked = masked | (key_mask[:, None, None, :] <= 0)
    if causal:
        masked = masked | (torch.arange(Tq)[:, None] < torch.arange(Tk)[None, :])
    lse4 = lse.reshape(B, H, Tq, 1)
    p = torch.where(masked | (s <= tfa.NEG), torch.zeros_like(s),
                    torch.exp(s - lse4))
    dp = split_mm(gf, vf.transpose(-1, -2), passes)
    ds = p * (dp - delta.reshape(B, H, Tq, 1)) * scale
    dq = split_mm(ds, kf, passes)
    dk = split_mm(ds.transpose(-1, -2), qf, passes)
    dv = split_mm(p.transpose(-1, -2), gf, passes)
    assert not dq[..., D:].any() and not dk[..., D:].any()
    return tuple(t[..., :D].permute(0, 2, 1, 3) for t in (dq, dk, dv))


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


@pytest.mark.parametrize("causal,masked", [(True, False), (False, True),
                                           (True, True)])
@pytest.mark.parametrize("T,D", [(100, 16), (100, 64), (64, 128), (100, 40),
                                 (100, 12)])
def test_split_tf32_backward_holds_float32_tolerance(T, D, causal, masked):
    q, k, v, km = _inputs(T, D, masked, seed=3 * T + D)
    do = torch.from_numpy(np.random.default_rng(D).standard_normal(
        q.shape).astype(np.float32))
    out, lse = tfa.flash_fwd_plain(q, k, v, causal, key_mask=km)
    delta = tfa.bwd_delta(out, do)
    rq = tfa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, km)
    rk, rv = tfa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, km)
    got = emulated_flash_bwd(q, k, v, do, lse, delta, causal, km, passes=3)
    for g, r in zip(got, (rq, rk, rv)):
        torch.testing.assert_close(g, r, rtol=0, atol=FLASH_TOL)
    # one TF32 pass misses float32's tolerance in the backward too
    one = emulated_flash_bwd(q, k, v, do, lse, delta, causal, km, passes=1)
    err1 = max(float((g - r).abs().max()) for g, r in zip(one, (rq, rk, rv)))
    assert err1 > FLASH_TOL, err1
    if masked:
        assert not any(g[1].any() for g in got)


def _round_to_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 to float32, rounded toward zero."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def tensor_core_mm(a, b, tile=None):
    """``a @ b`` as a chain of split-TF32 m16n8k8 steps whose float32
    accumulator is rounded toward zero after every step (each step's exact
    sum added), as the tensor core accumulates. With ``tile``, the chain
    restarts every ``tile`` rows of the reduction and a float32 add (round
    to nearest) carries each partial into the total, as the backward does."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    total = torch.zeros(a.shape[:-1] + b.shape[-1:])
    acc = torch.zeros_like(total)
    for k0 in range(0, a.shape[-1], 8):
        if tile and k0 and k0 % tile == 0:
            total, acc = total + acc, torch.zeros_like(acc)
        ks = slice(k0, k0 + 8)
        for x, y in ((ah, bl), (al, bh), (ah, bh)):
            acc = _round_to_zero(acc.double()
                                 + x[..., ks].double() @ y[..., ks, :].double())
    return total + acc


def test_tile_partials_hold_float32_under_truncating_accumulation():
    """dV = P^T . dO at T = 256, causal: one truncating chain over all 256
    queries of a key drifts past 2e-5 (as the card showed, 2.4e-5); the
    kernel's per-tile partials (32 queries) stay well inside it."""
    q, k, v, _ = _inputs(256, 64, False, seed=0)
    do = torch.from_numpy(np.random.default_rng(9).standard_normal(
        q.shape).astype(np.float32))
    out, lse = tfa.flash_fwd_plain(q, k, v, True)
    delta = tfa.bwd_delta(out, do)
    p, _ = tfa._plain_p_ds(q, k, v, do, lse, delta, True, None)
    _, rv = tfa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, True)
    pt, g = p.transpose(-1, -2), do.permute(0, 2, 1, 3)
    chain = tensor_core_mm(pt, g).permute(0, 2, 1, 3)
    tiled = tensor_core_mm(pt, g, tile=32).permute(0, 2, 1, 3)
    assert float((chain - rv).abs().max()) > FLASH_TOL
    torch.testing.assert_close(tiled, rv, rtol=0, atol=FLASH_TOL / 2)


#: the serving (B * H = 8, T = 512) and training (B * H = 64, T = 256) grids
FLASH_GRIDS = [(8, 512), (64, 256)]


@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
@pytest.mark.parametrize("BH,Tq", FLASH_GRIDS)
def test_flash_plan_covers_every_head_dim(kernel, BH, Tq):
    for D in range(1, 129):
        plan = tfa.flash_plan(kernel, D, BH, Tq, SMS)
        assert plan.width >= D and plan.width % 8 == 0, (D, plan)
        assert plan.width in tfa.FLASH_WIDTHS
        # the least width that holds D: padding never doubles past it
        assert all(w < D for w in tfa.FLASH_WIDTHS if w < plan.width)
        assert 0 < plan.smem <= tfa.SMEM_PER_BLOCK, (D, plan)
        if kernel == "fwd":
            assert plan.splits in ((2,) if plan.width == 128 else (2, 4))
        else:
            assert plan.splits == 1


def test_flash_plan_keeps_the_d64_forward_launches():
    """At D = 64 the forward keeps its launch: 4 key splits at the predict
    grid (128 blocks, under 2 an SM), 2 at the training grid; 2 at D = 128,
    where 4 would need more shared memory than a block has."""
    assert tfa.flash_plan("fwd", 64, 8, 512, SMS).splits == 4
    assert tfa.flash_plan("fwd", 64, 64, 256, SMS).splits == 2
    wide = tfa.flash_plan("fwd", 128, 8, 512, SMS)
    assert wide.splits == 2
    four = 4 * (4 * 4 * 32 * (128 + 4) + 2 * 4 * 32 + 32 * (128 + 4))
    assert four > tfa.SMEM_PER_BLOCK >= wide.smem


def test_flash_kernels_name_the_head_dim_range():
    with pytest.raises(ValueError, match=r"1\.\.128"):
        tfa.flash_plan("fwd", 129, 8, 512, SMS)
    # a tensor that is not on the CPU takes the kernel's checks (meta tensors
    # reach them without a card)
    q = torch.empty(1, 8, 1, 129, device="meta")
    lse = torch.empty(1, 8, device="meta")
    with pytest.raises(ValueError, match=r"1\.\.128"):
        tfa.flash_fwd(q, q, q, True)
    with pytest.raises(ValueError, match=r"1\.\.128"):
        tfa._check_bwd("flash_bwd_dq", q, q, q, q, lse, lse, None)
    with pytest.raises(ValueError, match=r"1\.\.128"):
        tfa.flash_bwd_dkv(q, q, q, q, lse, lse, True)
    # within the range a meta tensor is refused for its device, not its D
    q = torch.empty(1, 8, 1, 128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_fwd(q, q, q, True)
    # the plain version on the CPU takes any head dim
    x = torch.zeros(1, 4, 1, 129)
    assert tfa.flash_fwd(x, x, x, True)[0].shape == x.shape


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
