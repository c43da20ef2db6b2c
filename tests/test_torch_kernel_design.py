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

Above head dim 128 ``flash_plan`` sends the three flash kernels to
``csrc/flash_wide.cu``, whose column groups must cover every output column
once, at the scale of the true D. Its forward runs on the tensor cores too:
S summed over 128-column slabs in slab order, the online softmax over key
tiles, each tile's P.V in fresh accumulators; that arithmetic is emulated
at D = 160 and 256 against ``flash_fwd_plain``.

``csrc/int8_matmul.cu`` splits K into slices per ``int8_matmul_plan``: every
K index must be covered exactly once, and the grid must reach the card's SM
count at every decode shape.

``csrc/sm_xent.cu`` follows ``sm_xent_plan``: a warp a row (a lane holding
chunks of ``vec`` elements) up to C = 2,048, a block a row beyond; every row
and every element of a row must be taken exactly once.

``csrc/lstm.cu``'s backward runs in three parts: the gate product z for all
rows at once, the recurrence on z, and the tail's products with the reduced
dimension cut in slices of 256 whose partial sums are added in slice order.
That decomposition is mirrored here in plain PyTorch and held against
``lstm_bwd_plain`` at the kernel's tolerance. Its forward hoists ``x W_x +
b`` off the recurrence and sums each step's ``h RW`` split over a warp's
lanes (or, at T = 1, one step over ``[x, h]``); that decomposition is held
against ``lstm_fwd_plain`` and the JAX Pallas kernel in interpret mode (the
only tests here that import JAX, inside the test).
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import flash_attention as tfa
from deeplearning4j_tpu_torch.ops import lstm as tl
from deeplearning4j_tpu_torch.ops import quant as tq
from deeplearning4j_tpu_torch.ops import softmax_xent as tsx

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
    for D in range(1, 1025):
        plan = tfa.flash_plan(kernel, D, BH, Tq, SMS)
        assert 0 < plan.smem <= tfa.SMEM_PER_BLOCK, (D, plan)
        assert plan.scale == 1.0 / D ** 0.5
        if D > 128:  # flash_wide.cu: column groups of 128 cover D once
            assert plan.width == 128, (D, plan)
            # every kernel splits its streamed tiles over 4 warps
            assert plan.splits == 4, plan
            assert plan.groups == -(-D // 128)
            assert (plan.groups - 1) * plan.width < D <= plan.groups * plan.width
            continue
        assert plan.groups == 1
        assert plan.width >= D and plan.width % 8 == 0, (D, plan)
        assert plan.width in tfa.FLASH_WIDTHS
        # the least width that holds D: padding never doubles past it
        assert all(w < D for w in tfa.FLASH_WIDTHS if w < plan.width)
        if kernel == "fwd":
            assert plan.splits in ((2,) if plan.width == 128 else (2, 4))
        else:
            assert plan.splits == 1


def test_flash_plan_keeps_the_d64_forward_launches():
    """The forward's key splits depend on the head dim and Tq alone: the
    same count at B * H = 1, 16 and 64 (a count that moved with the batch
    summed a row's keys in another order at another batch). At D = 64, 4
    key splits at the predict grid's T 512, 2 at the training grid's T 256;
    2 at D = 128, where 4 would need more shared memory than a block has."""
    for D in (8, 16, 32, 40, 64, 128):
        width = next(w for w in tfa.FLASH_WIDTHS if w >= D)
        for Tq in (1, 256, 511, 512, 2048):
            plans = {tfa.flash_plan("fwd", D, BH, Tq, sms)
                     for BH in (1, 16, 64) for sms in (SMS, 2 * SMS)}
            assert len(plans) == 1, (D, Tq, plans)
            assert plans.pop().splits == tfa.FWD_SPLITS[width][
                Tq >= tfa.FWD_LONG_TQ]
    assert tfa.flash_plan("fwd", 64, 8, 512, SMS).splits == 4
    assert tfa.flash_plan("fwd", 64, 64, 256, SMS).splits == 2
    wide = tfa.flash_plan("fwd", 128, 8, 512, SMS)
    assert wide.splits == 2
    four = 4 * (4 * 4 * 32 * (128 + 4) + 2 * 4 * 32 + 32 * (128 + 4))
    assert four > tfa.SMEM_PER_BLOCK >= wide.smem


def test_flash_kernels_name_the_head_dim_range():
    """Every head dim runs on the card: up to 128 in the width kernels, above
    it in flash_wide.cu's column groups, always at the true 1/sqrt(D)."""
    for D, groups in ((129, 2), (160, 2), (256, 2), (257, 3), (512, 4)):
        for kernel in ("fwd", "dq", "dkv"):
            plan = tfa.flash_plan(kernel, D, 8, 512, SMS)
            assert plan.groups == groups > 1 and plan.width == 128
            assert plan.scale == 1.0 / D ** 0.5
    # the shared-memory bytes of flash_wide.cu's structs: a staging area a
    # warp times 4 splits, at the wide phase's grid (128 blocks, under 2 an
    # SM) and at one of 2 blocks an SM or more alike. The forward's area is
    # 16 query and 2 x 32 key rows of 132 floats: 4 * 4 * 80 * 132 =
    # 168,960; dQ's 2 x 16 query (Q, dO) and 2 x 32 key rows (K, V): 4 * 4 *
    # 96 * 132 = 202,752; dK/dV's 2 x 16 key and 2 x 32 query rows and the
    # tile's 32 lse and 32 delta: 4 * 4 * (96 * 132 + 64) = 203,776
    assert [tfa.flash_plan(k, 256, 8, 128, SMS).smem
            for k in ("fwd", "dq", "dkv")] == [168_960, 202_752, 203_776]
    assert tfa.flash_plan("fwd", 256, 8, 128, SMS).splits == 4
    assert tfa.flash_plan("fwd", 256, 64, 256, SMS) \
        == tfa.flash_plan("fwd", 256, 8, 128, SMS)
    assert tfa.flash_plan("dq", 128, 8, 512, SMS).groups == 1
    with pytest.raises(ValueError):
        tfa.flash_plan("fwd", 0, 8, 512, SMS)
    # a tensor that is neither on the CPU nor on a card is refused for its
    # device, whatever its head dim (meta tensors reach the checks)
    for D in (128, 129, 256):
        q = torch.empty(1, 8, 1, D, device="meta")
        lse = torch.empty(1, 8, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            tfa.flash_fwd(q, q, q, True)
        with pytest.raises(ValueError, match="unsupported device"):
            tfa._check_bwd("flash_bwd_dq", q, q, q, q, lse, lse, None)
        with pytest.raises(ValueError, match="unsupported device"):
            tfa.flash_bwd_dkv(q, q, q, q, lse, lse, True)
    # the plain version on the CPU takes any head dim
    x = torch.zeros(1, 4, 1, 129)
    assert tfa.flash_fwd(x, x, x, True)[0].shape == x.shape


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_wide_backward_plan_fits_a_block_at_every_head_dim(kernel):
    """The backward's plan fits a block's shared memory at every head dim;
    above 128 flash_wide.cu's staging areas (a warp each, 4 splits) do not
    grow with D: every D takes the same bytes, and the same bytes at every
    grid."""
    wide = set()
    for D in range(1, 1025):
        for BH, Tq in FLASH_GRIDS + [(8, 128), (1, 333)]:
            plan = tfa.flash_plan(kernel, D, BH, Tq, SMS)
            assert 0 < plan.smem <= tfa.SMEM_PER_BLOCK, (D, plan)
            if D > 128:
                assert plan.splits == 4 and plan.groups == -(-D // 128), plan
                wide.add(plan.smem)
    assert wide == {202_752 if kernel == "dq" else 203_776}


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,C", [(1600, 64), (4096, 256), (37, 2048),
                                 (9, 2049), (5, 50257), (1601, 100), (3, 33),
                                 (8, 1), (1, 2047)])
def test_sm_xent_plan_covers_every_row_once(N, C, dtype):
    plan = tsx.sm_xent_plan(N, C, dtype)
    rows = np.zeros(N, np.int64)
    if plan.route == "block":
        assert C > tsx.WARP_MAX_C and plan.rows == 1 and plan.grid == N
        rows[:] = 1
        cols = np.zeros(C, np.int64)
        for tid in range(256):  # a block's threads stride the row
            cols[tid::256] += 1
        assert (cols == 1).all()
    else:
        assert C <= tsx.WARP_MAX_C and plan.rows == tsx.WARP_ROWS
        for blk in range(plan.grid):
            for w in range(plan.rows):
                r = blk * plan.rows + w
                if r < N:
                    rows[r] += 1
        # lane l takes chunks l, l + 32, ... of vec elements, within the
        # values it can hold
        assert C % plan.vec == 0 and plan.per_lane & (plan.per_lane - 1) == 0
        cols = np.zeros(C, np.int64)
        for lane in range(32):
            held = 0
            for i in range(plan.per_lane // plan.vec):
                ch = lane + 32 * i
                if ch < C // plan.vec:
                    cols[ch * plan.vec:(ch + 1) * plan.vec] += 1
                    held += plan.vec
            assert held <= plan.per_lane
        assert (cols == 1).all()
        if C >= 32 * plan.vec:  # every lane has a chunk
            assert C // plan.vec >= 32
    assert (rows == 1).all()


def test_sm_xent_plan_routes_the_main_shapes():
    """char_rnn's rows (C = 64) and the transformer's (C = 256) take a warp
    each with every lane busy: one 8-byte chunk, two 16-byte chunks."""
    assert tsx.sm_xent_plan(1600, 64) == ("warp", 8, 200, 2, 2)
    assert tsx.sm_xent_plan(4096, 256) == ("warp", 8, 512, 4, 8)
    assert tsx.sm_xent_plan(64, 50257).route == "block"


#: lstm_bwd against lstm_bwd_plain: each output within 1e-4 of its largest
#: entry, plus 1e-5 (sums over T * B = 1,600 rows in another order)
LSTM_BWD_ATOL, LSTM_BWD_RTOL = 1e-5, 1e-4
#: rows of the reduced dimension in one slice of a tail product (lstm.cu)
LSTM_SLICE = 256


def _sliced(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the tail computes it: the reduced dimension cut in
    slices of 256, each slice's partial summed on its own, the partials
    added in slice order."""
    out = None
    for p0 in range(0, a.shape[1], LSTM_SLICE):
        part = a[:, p0:p0 + LSTM_SLICE] @ b[p0:p0 + LSTM_SLICE]
        out = part if out is None else out + part
    return out


def hoisted_lstm_bwd(x_t, hprev, cprev, wcat, b, peep, dys, dht, dct, m_t):
    """The CUDA backward's decomposition: (1) z for every row at once, (2)
    the recurrence reading z_t (dz_t, the dc carry, dh_{t-1} = dz_t RW^T),
    (3) the tail: dW, db, dx and dpeep as sliced products."""
    T, B, F = x_t.shape
    H = hprev.shape[-1]
    xh = torch.cat([x_t, hprev], dim=-1).reshape(T * B, F + H)
    z = (xh @ wcat + b.reshape(-1)).reshape(T, B, 4 * H)
    dh, dc = dht.clone(), dct.clone()
    dz = torch.empty(T, B, 4 * H)
    pacc = torch.zeros(B, 3 * H)
    for t in range(T - 1, -1, -1):
        cp = cprev[t]
        zi, zf, zg, zo = z[t].split(H, dim=-1)
        if peep is not None:
            zi, zf = zi + cp * peep[0], zf + cp * peep[1]
        i, f, g = torch.sigmoid(zi), torch.sigmoid(zf), torch.tanh(zg)
        cn = f * cp + i * g
        if peep is not None:
            zo = zo + cn * peep[2]
        o, tc = torch.sigmoid(zo), torch.tanh(cn)
        live = (m_t[t] > 0)[:, None]
        dh_t = dh + dys[t]
        zero = torch.zeros_like(dh_t)
        dh_act, dh_skip = torch.where(live, dh_t, zero), torch.where(live, zero, dh_t)
        dc_act, dc_skip = torch.where(live, dc, zero), torch.where(live, zero, dc)
        dzo = dh_act * tc * o * (1 - o)
        dc_t = dc_act + dh_act * o * (1 - tc * tc)
        if peep is not None:
            dc_t = dc_t + dzo * peep[2]
        dzi = dc_t * g * i * (1 - i)
        dzf = dc_t * cp * f * (1 - f)
        dzg = dc_t * i * (1 - g * g)
        dz[t] = torch.cat([dzi, dzf, dzg, dzo], dim=-1)
        dc = dc_t * f + dc_skip
        if peep is not None:
            dc = dc + dzi * peep[0] + dzf * peep[1]
            pacc += torch.cat([dzi * cp, dzf * cp, dzo * cn], dim=-1)
        dh = dz[t] @ wcat[F:].t() + dh_skip
    dzr = dz.reshape(T * B, 4 * H)
    dw = _sliced(xh.t().contiguous(), dzr)
    db = _sliced(torch.ones(1, T * B), dzr)
    dx = _sliced(dzr, wcat[:F].t().contiguous()).reshape(T, B, F)
    dpeep = (_sliced(torch.ones(1, B), pacc).reshape(3, H)
             if peep is not None else torch.zeros(3, H))
    return dx, dw, db, dpeep, dh, dc


@pytest.mark.parametrize("T,B,F,H,peephole,masked", [
    (50, 32, 64, 200, True, False),   # char_rnn's chunk, layer 1
    (50, 32, 200, 200, True, True),   # layer 2, a ragged mask
    (50, 32, 64, 200, False, False),  # no peepholes
    (7, 3, 5, 37, True, True)])
def test_hoisted_lstm_bwd_matches_plain(T, B, F, H, peephole, masked):
    g = torch.Generator().manual_seed(T + F + H)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    m = torch.ones(T, B)
    if masked:
        m = (torch.rand(T, B, generator=g) > 0.3).float()
        m[:, 0] = 0.0
    x, wcat, b = r(T, B, F), r(F + H, 4 * H, scale=0.1), r(1, 4 * H, scale=0.1)
    peep = r(3, H, scale=0.3) if peephole else None
    h0, c0 = r(B, H, scale=0.5), r(B, H, scale=0.5)
    ys, cs, _, _ = tl.lstm_fwd_plain(x, wcat, b, peep, h0, c0, m)
    args = (x, torch.cat([h0[None], ys[:-1]]), torch.cat([c0[None], cs[:-1]]),
            wcat, b, peep, r(T, B, H), r(B, H), r(B, H), m)
    got = hoisted_lstm_bwd(*args)
    want = tl.lstm_bwd_plain(*args)
    for name, x_, w_ in zip(("dx", "dW", "db", "dpeep", "dh0", "dc0"), got, want):
        assert x_.shape == w_.shape, name
        err = float((x_ - w_).abs().max())
        assert err <= LSTM_BWD_ATOL + LSTM_BWD_RTOL * float(w_.abs().max()), \
            (name, err)


#: the forward kernel's tolerance against lstm_fwd_plain (chip_smoke.py):
#: float32 dot products over F + H terms in another order
LSTM_FWD_TOL = 2e-5


def lane_split_dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a [B, K] @ w [K, N]`` as ``csrc/lstm.cu``'s lean step sums it: K
    padded with zeros to a multiple of 4, float4 chunk c taken by lane
    c % 32, each lane's chunks in order (four products a chunk), then the
    32 lanes' partials added in ``lane_totals``'s tree (lanes l and l ^ 16
    first, then l ^ 8, ... l ^ 1)."""
    B, K = a.shape
    kp = -(-K // 4) * 4
    a = torch.nn.functional.pad(a, (0, kp - K))
    w = torch.nn.functional.pad(w, (0, 0, 0, kp - K))
    part = torch.zeros(32, B, w.shape[1])
    for c in range(kp // 4):
        for k in range(4 * c, 4 * c + 4):
            part[c % 32] = part[c % 32] + a[:, k, None] * w[k]
    for off in (16, 8, 4, 2, 1):
        part = part[:off] + part[off:2 * off]
    return part[0]


def _pad_rows(m: torch.Tensor, rows: int) -> torch.Tensor:
    return torch.nn.functional.pad(m, (0, 0, 0, rows - m.shape[0]))


def hoisted_lstm_fwd(x_t, wcat, b, peep, h0, c0, m_t):
    """The CUDA forward's decomposition. T > 1: (1) ``zx = x W_x + b`` for
    every row at once, (2) per step ``z = zx_t + h_{t-1} RW`` with the
    recurrent product summed in the lane-split order, then the cell update.
    T = 1: one step over ``[x padded to a multiple of 4, h]`` and ``[W_x,
    RW]`` padded alike, plus the bias."""
    T, B, F = x_t.shape
    H = h0.shape[-1]
    bias = b.reshape(-1)
    h, c = h0, c0
    if T == 1:
        fp = -(-F // 4) * 4
        xh = torch.cat([torch.nn.functional.pad(x_t[0], (0, fp - F)), h], -1)
        w = torch.cat([_pad_rows(wcat[:F], fp), wcat[F:]])
        zs = [lane_split_dot(xh, w) + bias]
    else:
        zx = (x_t.reshape(T * B, F) @ wcat[:F] + bias).reshape(T, B, 4 * H)
    ys, cs = [], []
    for t in range(T):
        z = zs[0] if T == 1 else zx[t] + lane_split_dot(h, wcat[F:])
        _, _, _, o, c_new = tl._gates(z, c, peep, H)
        h_new = o * torch.tanh(c_new)
        live = (m_t[t] > 0)[:, None]
        h = torch.where(live, h_new, h)
        c = torch.where(live, c_new, c)
        ys.append(h)
        cs.append(c)
    return torch.stack(ys), torch.stack(cs), h, c


@pytest.mark.parametrize("T,B,F,H,peephole,masked", [
    (50, 32, 64, 200, True, False),   # char_rnn's chunk, layer 1
    (50, 32, 200, 200, True, True),   # layer 2, a ragged mask
    (50, 32, 64, 200, False, False),  # no peepholes
    (1, 8, 64, 200, True, False),     # the one-step route: decode
    (1, 1, 64, 200, True, False),     # stream
    (7, 3, 5, 37, True, True)])
def test_hoisted_lstm_fwd_matches_plain_and_jax(T, B, F, H, peephole, masked):
    import jax.numpy as jnp

    from deeplearning4j_tpu.ops import lstm as jl
    rng = np.random.default_rng(T + F + H + B)

    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    m = np.ones((T, B), np.float32)
    if masked:
        m = (rng.random((T, B)) > 0.3).astype(np.float32)
        m[:, 0] = 0.0  # a batch row masked at every step
    a = dict(x_t=r(T, B, F), wcat=r(F + H, 4 * H, scale=0.1),
             b=r(1, 4 * H, scale=0.1), peep=r(3, H, scale=0.3),
             h0=r(B, H, scale=0.5), c0=r(B, H, scale=0.5), m_t=m)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    peep = t["peep"] if peephole else None
    args = (t["x_t"], t["wcat"], t["b"], peep, t["h0"], t["c0"], t["m_t"])
    got = hoisted_lstm_fwd(*args)
    plain = tl.lstm_fwd_plain(*args)
    # the JAX Pallas kernel in interpret mode, one block of all T steps
    ref = jl._pallas_forward(*(jnp.asarray(a[k]) for k in
                               ("x_t", "wcat", "b", "peep", "h0", "c0", "m_t")),
                             T, peephole, True)
    for name, g, p, j in zip(("ys", "cs", "h", "c"), got, plain, ref):
        assert g.shape == p.shape, name
        torch.testing.assert_close(g, p, rtol=0, atol=LSTM_FWD_TOL, msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0,
                                   atol=LSTM_FWD_TOL, err_msg=name)
    if masked:  # the held row keeps its initial state at every step
        assert torch.equal(got[0][:, 0], t["h0"][0].expand(T, H))


def test_lane_split_dot_tree_is_the_shuffle_transpose():
    """``lane_totals`` in ``csrc/lstm.cu``, simulated lane by lane: at each
    level a lane keeps the half of its 32 sums whose index has its lane's
    bit and adds its partner's copy; lane l ends with the total of index l,
    bitwise the tree ``lane_split_dot`` models."""
    rng = np.random.default_rng(0)
    v = rng.standard_normal((32, 32)).astype(np.float32)  # [lane][index]
    lanes = [list(row) for row in v]
    off = 16
    while off:
        new = []
        for lane in range(32):
            up = bool(lane & off)
            partner = lanes[lane ^ off]
            new.append([np.float32((lanes[lane][i + off] if up else lanes[lane][i])
                                   + (partner[i + off] if up else partner[i]))
                        for i in range(off)])
        lanes = new
        off //= 2
    got = np.array([lanes[lane][0] for lane in range(32)], np.float32)
    part = torch.from_numpy(v)
    for off in (16, 8, 4, 2, 1):
        part = part[:off] + part[off:2 * off]
    assert np.array_equal(got, part[0].numpy())


#: csrc/flash_wide.cu's forward: keys of a tile, columns of a slab and of an
#: output group
WIDE_FK, WIDE_GW = 32, 128


def emulated_wide_flash_fwd(q, k, v, causal, key_mask, passes=3):
    """``csrc/flash_wide.cu``'s forward with its products emulated: per key
    tile of 32, ``S = (q / sqrt(D)) k^T`` as the sum of its 128-column
    slabs' split-TF32 products, added in slab order; the online softmax;
    and per output group of 128 columns the tile's ``P V_g``, in fresh
    accumulators, added to the rescaled output in float32. Every group uses
    the one S, m, l and P."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    qs = (q * (1.0 / D ** 0.5)).permute(0, 2, 1, 3)
    kf, vf = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    masked = torch.zeros(B, 1, Tq, Tk, dtype=torch.bool)
    if key_mask is not None:
        masked = masked | (key_mask[:, None, None, :] <= 0)
    if causal:
        masked = masked | (torch.arange(Tq)[:, None] < torch.arange(Tk)[None, :])
    m = torch.full((B, H, Tq, 1), tfa.NEG)
    l = torch.zeros(B, H, Tq, 1)
    acc = torch.zeros(B, H, Tq, D)
    for kb in range(0, Tk, WIDE_FK):
        ks = slice(kb, kb + WIDE_FK)
        s = torch.zeros(B, H, Tq, min(Tk, kb + WIDE_FK) - kb)
        for c0 in range(0, D, WIDE_GW):
            cs = slice(c0, c0 + WIDE_GW)
            s = s + split_mm(qs[..., cs], kf[:, :, ks, cs].transpose(-1, -2),
                             passes)
        s = torch.where(masked[..., ks], torch.tensor(tfa.NEG), s)
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - mn)
        p = torch.where(s <= tfa.NEG, torch.zeros_like(s), torch.exp(s - mn))
        m, l = mn, l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha
        for c0 in range(0, D, WIDE_GW):
            cs = slice(c0, c0 + WIDE_GW)
            acc[..., cs] = acc[..., cs] + split_mm(p, vf[:, :, ks, cs], passes)
    ls = torch.clamp_min(l, 1e-20)
    lse = (m + torch.log(ls))[..., 0].reshape(B * H, Tq)
    return (acc / ls).permute(0, 2, 1, 3), lse


@pytest.mark.parametrize("causal,masked", [(True, False), (False, True),
                                           (True, True)])
@pytest.mark.parametrize("D", [160, 256])
def test_wide_split_tf32_forward_holds_float32_tolerance(D, causal, masked):
    q, k, v, km = _inputs(100, D, masked, seed=D + 7 * causal + masked)
    ro, rl = tfa.flash_fwd_plain(q, k, v, causal, key_mask=km)
    out, lse = emulated_wide_flash_fwd(q, k, v, causal, km)
    torch.testing.assert_close(out, ro, rtol=0, atol=FLASH_TOL)
    torch.testing.assert_close(lse, rl, rtol=0, atol=FLASH_TOL)
    # one TF32 pass misses it at these head dims too
    out1, lse1 = emulated_wide_flash_fwd(q, k, v, causal, km, passes=1)
    err1 = max(float((out1 - ro).abs().max()), float((lse1 - rl).abs().max()))
    assert err1 > FLASH_TOL, err1
    if masked:
        assert not out[1].any()


#: csrc/flash_wide.cu's backward: rows of a block (queries for dQ, keys for
#: dK/dV) and tile splits (warps) of a block
WIDE_BR, WIDE_SPLITS = 16, 4


def emulated_wide_flash_bwd(q, k, v, do, lse, delta, causal, key_mask,
                            passes=3):
    """``csrc/flash_wide.cu``'s dQ and dK/dV with their products emulated.
    A streamed tile is 32 keys (dQ) or 32 queries (dK/dV, a block of 16 keys
    at a time, from the block's first key under a causal mask). Per tile, S
    and dP are the sums of their 128-column slabs' split-TF32 products, in
    slab order (keys as rows for dK/dV), then P and dS; per output group of
    128 columns the tile's dQ_g, or dV_g = P^T dO_g and dK_g = dS^T Q_g, in
    fresh accumulators, added in float32 to its split's total (split = the
    tile's index mod 4); the splits' totals are added in split order. Every
    group uses the one S, P and dS of a tile."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = 1.0 / D ** 0.5
    qf, kf, vf, gf = (t.permute(0, 2, 1, 3) for t in (q, k, v, do))
    lse4, dl4 = lse.reshape(B, H, Tq, 1), delta.reshape(B, H, Tq, 1)
    masked = torch.zeros(B, 1, Tq, Tk, dtype=torch.bool)
    if key_mask is not None:
        masked = masked | (key_mask[:, None, None, :] <= 0)
    if causal:
        masked = masked | (torch.arange(Tq)[:, None] < torch.arange(Tk)[None, :])
    groups = [slice(c0, c0 + WIDE_GW) for c0 in range(0, D, WIDE_GW)]

    def scores(a, b):
        s = torch.zeros(a.shape[:-1] + b.shape[-2:-1])
        for cs in groups:
            s = s + split_mm(a[..., cs], b[..., cs].transpose(-1, -2), passes)
        return s

    def fold(parts):
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    # dQ: key tiles over every query row (a tile past a row's last key
    # adds exactly 0)
    parts = [torch.zeros(B, H, Tq, D) for _ in range(WIDE_SPLITS)]
    for kt, kb in enumerate(range(0, Tk, WIDE_FK)):
        ks = slice(kb, kb + WIDE_FK)
        s = scores(qf, kf[:, :, ks]) * scale
        p = torch.where(masked[..., ks] | (s <= tfa.NEG), torch.zeros_like(s),
                        torch.exp(s - lse4))
        ds = p * (scores(gf, vf[:, :, ks]) - dl4) * scale
        part = parts[kt % WIDE_SPLITS]
        for cs in groups:
            part[..., cs] = part[..., cs] + split_mm(ds, kf[:, :, ks, cs],
                                                     passes)
    dq = fold(parts)
    # dK/dV: a block of 16 keys at a time, keys as the rows
    dk, dv = torch.zeros(B, H, Tk, D), torch.zeros(B, H, Tk, D)
    for k0 in range(0, Tk, WIDE_BR):
        ks = slice(k0, k0 + WIDE_BR)
        pk = [torch.zeros(B, H, min(Tk, k0 + WIDE_BR) - k0, D)
              for _ in range(WIDE_SPLITS)]
        pv = [torch.zeros_like(t) for t in pk]
        for it, qb in enumerate(range(k0 if causal else 0, Tq, WIDE_FK)):
            qs = slice(qb, qb + WIDE_FK)
            st = scores(kf[:, :, ks], qf[:, :, qs]) * scale
            mt = masked[:, :, qs, ks].transpose(-1, -2)
            lt, dlt = (x[:, :, qs].transpose(-1, -2) for x in (lse4, dl4))
            pt = torch.where(mt | (st <= tfa.NEG), torch.zeros_like(st),
                             torch.exp(st - lt))
            dst = torch.where(mt, torch.zeros_like(st),
                              pt * (scores(vf[:, :, ks], gf[:, :, qs]) - dlt)
                              * scale)
            for cs in groups:
                i = it % WIDE_SPLITS
                pv[i][..., cs] = pv[i][..., cs] + split_mm(
                    pt, gf[:, :, qs, cs], passes)
                pk[i][..., cs] = pk[i][..., cs] + split_mm(
                    dst, qf[:, :, qs, cs], passes)
        dk[:, :, ks], dv[:, :, ks] = fold(pk), fold(pv)
    return tuple(t.permute(0, 2, 1, 3) for t in (dq, dk, dv))


@pytest.mark.parametrize("causal,masked", [(True, False), (False, True),
                                           (True, True)])
@pytest.mark.parametrize("D", [160, 256, 512])
def test_wide_split_tf32_backward_holds_float32_tolerance(D, causal, masked):
    q, k, v, km = _inputs(100, D, masked, seed=D + 5 * causal + masked)
    do = torch.from_numpy(np.random.default_rng(D + 1).standard_normal(
        q.shape).astype(np.float32))
    out, lse = tfa.flash_fwd_plain(q, k, v, causal, key_mask=km)
    delta = tfa.bwd_delta(out, do)
    rq = tfa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, km)
    rk, rv = tfa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, km)
    got = emulated_wide_flash_bwd(q, k, v, do, lse, delta, causal, km)
    for g, r in zip(got, (rq, rk, rv)):
        torch.testing.assert_close(g, r, rtol=0, atol=FLASH_TOL)
    # one TF32 pass misses float32's tolerance at these head dims too
    one = emulated_wide_flash_bwd(q, k, v, do, lse, delta, causal, km,
                                  passes=1)
    err1 = max(float((g - r).abs().max()) for g, r in zip(one, (rq, rk, rv)))
    assert err1 > FLASH_TOL, err1
    if masked:
        assert not any(g[1].any() for g in got)
