"""Flash attention: the forward and its backward.

Counterpart of the flash half of ``deeplearning4j_tpu/ops/pallas_kernels.py``
(``_flash_forward``, ``_flash_backward``, ``flash_attention``,
``masked_attention`` and their ``custom_vjp`` rules). On CUDA tensors the
forward launches ``csrc/flash_fwd.cu`` and the backward the two kernels of
``csrc/flash_bwd.cu`` (dQ, then dK/dV), at every sequence length and every
head dim (above 128 the three kernels of ``csrc/flash_wide.cu``): the TPU's
length gates (``_MIN_SEQ``, ``_PBWD_MIN_SEQ``) are not carried over, and a
crossover is for H100 measurements to set. :func:`flash_plan` picks each
launch's kernel, width, column groups, tile splits and shared memory. On CPU
tensors every wrapper runs its plain version.

The JAX conventions are kept exactly: logits scaled by ``1/sqrt(D)``,
masked logits ``-1e30`` (not ``-inf``), ``p = 0`` where the logit is
``<= -1e30``, ``l`` clamped at ``1e-20`` so a fully masked row outputs 0,
``lse = m + log(l)``; the backward recomputes ``P = exp(S - lse)`` (0 where
masked), takes ``delta = rowsum(dO * O)`` from the saved output in its stored
dtype, and applies the scale once, inside ``dS``. Layouts are the JAX
package's: q, k, v, out and their gradients ``[B, T, H, D]``, lse and delta
``[B * H, Tq]`` float32.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import _cuda

NEG = -1e30
#: head dims the kernels are instantiated at; a head dim between two is
#: padded with zeros inside the kernel to the next
FLASH_WIDTHS = (16, 32, 64, 128)
#: the most dynamic shared memory an H100 block may have
SMEM_PER_BLOCK = 232_448
#: tile sizes of the kernels (csrc/flash_fwd.cu, csrc/flash_bwd.cu)
_FWD_BQ, _FWD_BK, _BWD_ROWS = 32, 32, 64
#: csrc/flash_wide.cu (D > 128): output rows of a block, rows of a streamed
#: tile (keys, or queries for dK/dV), columns of a slab and of an output
#: group, tile splits (warps) of a block
_WIDE_BR, _WIDE_BT, _WIDE_GW, _WIDE_SPLITS = 16, 32, 128, 4


class FlashPlan(NamedTuple):
    width: int   #: the instantiated head dim (<= 128), or a group's columns
    splits: int  #: tile splits (warps) of a block: the forward's key
    #: splits, the wide backward's key or query splits; else 1
    smem: int    #: dynamic shared memory of a block, bytes
    groups: int  #: output-column groups: 1, or ceil(D / 128) (flash_wide.cu)
    scale: float  #: the logit scale, 1 / sqrt(D) of the true D


@functools.lru_cache(maxsize=None)
def flash_plan(kernel: str, D: int, BH: int, Tq: int, sms: int) -> FlashPlan:
    """The launch plan of ``kernel`` (``"fwd"``, ``"dq"`` or ``"dkv"``) at
    head dim ``D``, ``BH = B * H`` and ``Tq`` query rows on a card of ``sms``
    SMs; the C side follows it and refuses shared-memory bytes (above 128
    also a split count) that differ from its instantiation's. Any
    ``D >= 1``.

    Up to 128 the width is the least of :data:`FLASH_WIDTHS` that holds
    ``D`` and ``groups`` is 1 (``flash_fwd.cu``, ``flash_bwd.cu``). The
    forward takes 2 key splits when the grid gives every SM 2 blocks or more,
    else 4 (twice the warps in flight); at width 128 always 2, since 4 splits
    of double-buffered 32-key tiles would need 270 KB. Rows are padded to
    ``width + 4`` floats. Above 128 the three kernels of ``flash_wide.cu``
    run with ``groups = ceil(D / 128)`` output-column groups of width 128.
    A block's 4 warps (``splits``, at every grid) each take a split of the
    streamed 32-row tiles (keys for the forward and dQ, queries for dK/dV)
    and a staging area of their own: 128-column slabs of the block's 16 rows
    and of a tile, rows padded to 132 floats. The area does not grow with
    ``D``, so the plan fits a block at every head dim."""
    if kernel not in ("fwd", "dq", "dkv"):
        raise ValueError(f"unknown flash kernel {kernel!r}")
    if D < 1:
        raise ValueError(f"flash_plan: head dim must be >= 1, got {D}")
    scale = 1.0 / (D ** 0.5)
    if D > FLASH_WIDTHS[-1]:
        groups = -(-D // _WIDE_GW)
        # a warp's area: slabs of the block's rows (Q; or Q and dO; or K
        # and V) and of a tile (K and V; or K and V; or Q and dO), dK/dV also
        # the tile's lse and delta
        rows = (_WIDE_BR if kernel == "fwd" else 2 * _WIDE_BR) + 2 * _WIDE_BT
        floats = rows * (_WIDE_GW + 4) + (2 * _WIDE_BT if kernel == "dkv" else 0)
        return FlashPlan(_WIDE_GW, _WIDE_SPLITS, 4 * _WIDE_SPLITS * floats,
                         groups, scale)
    width = next(w for w in FLASH_WIDTHS if w >= D)
    ld = width + 4
    if kernel == "fwd":
        blocks = BH * -(-Tq // _FWD_BQ)
        splits = 2 if width > 64 or blocks >= 2 * sms else 4
        # K and V tiles [2][splits][BK][ld], the key mask [2][splits][BK],
        # the scaled query [BQ][ld] at width 128 (else one row)
        floats = (4 * splits * _FWD_BK * ld + 2 * splits * _FWD_BK
                  + (_FWD_BQ if width > 64 else 1) * ld)
        return FlashPlan(width, splits, 4 * floats, 1, scale)
    tile = 16 if width >= 128 else 32  # rows of a streamed tile
    if kernel == "dq":
        # Q and dO rows [64][ld] each; K, V tiles [2][tile][ld]; mask [2][tile]
        floats = 2 * _BWD_ROWS * ld + 4 * tile * ld + 2 * tile
    elif kernel == "dkv":
        # K, V rows [64][ld]; mask [64]; Q, dO tiles [2][tile][ld]; lse and
        # delta [2][tile]
        floats = 2 * _BWD_ROWS * ld + _BWD_ROWS + 4 * tile * ld + 4 * tile
    return FlashPlan(width, 1, 4 * floats, 1, scale)


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, key_mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the kernel's math over the whole score matrix."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = 1.0 / (D ** 0.5)
    qf = q.to(torch.float32) * scale
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k.to(torch.float32))
    neg = torch.tensor(NEG, dtype=torch.float32, device=q.device)
    if key_mask is not None:
        s = torch.where(key_mask.to(torch.float32)[:, None, None, :] > 0, s, neg)
    if causal:
        cm = (torch.arange(Tq, device=q.device)[:, None]
              >= torch.arange(Tk, device=q.device)[None, :])
        s = torch.where(cm, s, neg)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s <= NEG, torch.zeros_like(s), torch.exp(s - m))
    l_safe = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-20)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l_safe, v.to(torch.float32))
    lse = (m + torch.log(l_safe))[..., 0].reshape(B * H, Tq)
    return out.to(q.dtype), lse


@_cuda.counted
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, key_mask: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward returning ``(out [B,Tq,H,D], lse [B*H,Tq])``.

    q ``[B, Tq, H, D]``, k and v ``[B, Tk, H, D]``, one dtype (float32 or
    bfloat16); ``key_mask`` an optional ``[B, Tk]`` {0,1} mask. On CUDA
    tensors this launches ``csrc/flash_fwd.cu`` (``csrc/flash_wide.cu``
    above D = 128; any D, any lengths); on CPU tensors it runs the plain
    version."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_fwd needs q, k, v as [B, T, H, D]")
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if k.shape != (B, Tk, H, D) or v.shape != k.shape:
        raise ValueError(f"flash_fwd shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) \
            or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_fwd needs one float32/bfloat16 dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if key_mask is not None and key_mask.shape != (B, Tk):
        raise ValueError(f"key_mask must be [B, Tk] = {(B, Tk)}, got "
                         f"{tuple(key_mask.shape)}")
    devices = {q.device, k.device, v.device}
    if key_mask is not None:
        devices.add(key_mask.device)
    if len(devices) != 1:
        raise ValueError("flash_fwd operands must share one device")
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal, key_mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: unsupported device {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_fwd needs contiguous q, k, v")
    km = None
    if key_mask is not None:
        km = key_mask.to(torch.float32).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((B * H, Tq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    plan = flash_plan("fwd", D, B * H, Tq, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    lib, fn, dims = _entry("fwd", plan)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if km is None else km.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, H, Tq, Tk, D, *dims, plan.smem, plan.scale, int(causal),
            int(q.dtype == torch.bfloat16), _cuda.stream_handle())
    _cuda.check(rc, lib, "flash_fwd launch")
    flash_fwd.launches += 1
    return out, lse


def _check_bwd(name: str, q, k, v, do, lse, delta, key_mask) -> None:
    """Operand checks shared by the two backward wrappers."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"{name} needs q, k, v as [B, T, H, D]")
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if k.shape != (B, Tk, H, D) or v.shape != k.shape or do.shape != q.shape:
        raise ValueError(f"{name} shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, do "
                         f"{tuple(do.shape)}")
    if not (q.dtype == k.dtype == v.dtype == do.dtype) \
            or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} needs one float32/bfloat16 dtype for q, k, "
                        f"v, do, got {q.dtype}, {k.dtype}, {v.dtype}, "
                        f"{do.dtype}")
    for t, what in ((lse, "lse"), (delta, "delta")):
        if t.shape != (B * H, Tq) or t.dtype != torch.float32:
            raise ValueError(f"{name}: {what} must be float32 [B*H, Tq] = "
                             f"{(B * H, Tq)}, got {t.dtype} {tuple(t.shape)}")
    if key_mask is not None and key_mask.shape != (B, Tk):
        raise ValueError(f"{name}: key_mask must be [B, Tk] = {(B, Tk)}, got "
                         f"{tuple(key_mask.shape)}")
    devices = {t.device for t in (q, k, v, do, lse, delta)}
    if key_mask is not None:
        devices.add(key_mask.device)
    if len(devices) != 1:
        raise ValueError(f"{name} operands must share one device")
    if q.device.type == "cpu":
        return
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if not all(t.is_contiguous() for t in (q, k, v, do, lse, delta)):
        raise ValueError(f"{name} needs contiguous operands")


def bwd_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` in float32 as ``[B * H, Tq]``, from ``out``
    in its stored dtype (PyTorch ops, outside the kernels, as the JAX
    package computes it in XLA)."""
    B, Tq, H, _ = out.shape
    d = (do.to(torch.float32) * out.to(torch.float32)).sum(dim=-1)
    return d.permute(0, 2, 1).reshape(B * H, Tq).contiguous()


def _plain_p_ds(q, k, v, do, lse, delta, causal, key_mask):
    """``P`` and ``dS`` ``[B, H, Tq, Tk]`` in float32, the kernels' math over
    the whole score matrix."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = 1.0 / (D ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    neg = torch.tensor(NEG, dtype=torch.float32, device=q.device)
    if key_mask is not None:
        s = torch.where(key_mask.to(torch.float32)[:, None, None, :] > 0, s, neg)
    if causal:
        cm = (torch.arange(Tq, device=q.device)[:, None]
              >= torch.arange(Tk, device=q.device)[None, :])
        s = torch.where(cm, s, neg)
    lse4 = lse.reshape(B, H, Tq, 1)
    p = torch.where(s <= NEG, torch.zeros_like(s), torch.exp(s - lse4))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.to(torch.float32),
                      v.to(torch.float32))
    ds = p * (dp - delta.reshape(B, H, Tq, 1)) * scale
    return p, ds


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, key_mask=None):
    """Plain version of the dQ kernel."""
    _, ds = _plain_p_ds(q, k, v, do, lse, delta, causal, key_mask)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.to(torch.float32)).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, key_mask=None):
    """Plain version of the dK/dV kernel."""
    p, ds = _plain_p_ds(q, k, v, do, lse, delta, causal, key_mask)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(torch.float32))
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.to(torch.float32))
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_plain(q, k, v, out, lse, do, causal, key_mask=None):
    """Plain version of :func:`flash_bwd`: ``(dq, dk, dv)``."""
    delta = bwd_delta(out, do)
    dq = flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, key_mask)
    return (dq, *flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal,
                                     key_mask))


#: each kernel's C entry, (library, symbol): up to D = 128, and above it
_ENTRIES = {"fwd": (("flash_fwd", "flash_fwd"), ("flash_wide", "flash_wide_fwd")),
            "dq": (("flash_bwd", "flash_bwd_dq"), ("flash_wide", "flash_wide_dq")),
            "dkv": (("flash_bwd", "flash_bwd_dkv"),
                    ("flash_wide", "flash_wide_dkv"))}
#: pointers each C entry takes before B: q, k, v, the key mask, out and lse;
#: or q, k, v, dO, lse, delta, the key mask and dQ (dK and dV)
_POINTERS = {"fwd": 6, "dq": 8, "dkv": 9}


@functools.lru_cache(maxsize=None)
def _entry(kernel: str, plan: FlashPlan):
    """``(library, C function, the ints it takes between D and the shared
    memory bytes)`` for ``plan``: ``flash_fwd.cu`` takes the width and the
    key splits, ``flash_bwd.cu`` the width, ``flash_wide.cu`` the column
    groups and the tile splits (the signatures are the same otherwise)."""
    wide = plan.groups > 1
    lib, sym = _ENTRIES[kernel][wide]
    if wide:
        dims = (plan.groups, plan.splits)
    else:
        dims = (plan.width, plan.splits) if kernel == "fwd" else (plan.width,)
    argtypes = ([_cuda.PTR] * _POINTERS[kernel] + [_cuda.INT] * (6 + len(dims))
                + [_cuda.FLOAT, _cuda.INT, _cuda.INT, _cuda.PTR])
    return lib, _cuda.function(lib, sym, argtypes), dims


def _mask_operand(key_mask):
    return None if key_mask is None else key_mask.to(torch.float32).contiguous()


@_cuda.counted
def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 causal: bool, key_mask: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """dQ ``[B, Tq, H, D]`` in q's dtype. On CUDA tensors this launches the
    dQ kernel of ``csrc/flash_bwd.cu`` (of ``csrc/flash_wide.cu`` above
    D = 128); on CPU tensors it runs the plain
    version."""
    _check_bwd("flash_bwd_dq", q, k, v, do, lse, delta, key_mask)
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, key_mask)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    km = _mask_operand(key_mask)
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    plan = flash_plan("dq", D, B * H, Tq, 0)
    lib, fn, dims = _entry("dq", plan)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            None if km is None else km.data_ptr(), dq.data_ptr(), B, H, Tq,
            Tk, D, *dims, plan.smem, plan.scale,
            int(causal), int(q.dtype == torch.bfloat16),
            _cuda.stream_handle())
    _cuda.check(rc, lib, "flash_bwd_dq launch")
    flash_bwd_dq.launches += 1
    return dq


@_cuda.counted
def flash_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  causal: bool, key_mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dK, dV)`` ``[B, Tk, H, D]`` in k's dtype. On CUDA tensors this
    launches the dK/dV kernel of ``csrc/flash_bwd.cu`` (of
    ``csrc/flash_wide.cu`` above D = 128); on CPU tensors it
    runs the plain version."""
    _check_bwd("flash_bwd_dkv", q, k, v, do, lse, delta, key_mask)
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, key_mask)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    km = _mask_operand(key_mask)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    plan = flash_plan("dkv", D, B * H, Tq, 0)
    lib, fn, dims = _entry("dkv", plan)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            None if km is None else km.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, H, Tq, Tk, D, *dims, plan.smem, plan.scale, int(causal),
            int(q.dtype == torch.bfloat16), _cuda.stream_handle())
    _cuda.check(rc, lib, "flash_bwd_dkv launch")
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
              causal: bool, key_mask: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The attention backward ``(dq, dk, dv)`` from the forward's saved
    ``out`` and ``lse``: ``delta`` in PyTorch, then the dQ and the dK/dV
    wrappers (two kernel launches on CUDA tensors)."""
    if out.shape != q.shape or out.dtype != q.dtype:
        raise ValueError(f"flash_bwd: out must match q, got {out.dtype} "
                         f"{tuple(out.shape)}")
    delta = bwd_delta(out, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, key_mask)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, key_mask)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward ``flash_fwd``, backward ``flash_bwd`` from the saved q, k, v,
    out and lse (the ``custom_vjp`` of the JAX entry points). The key mask
    and ``lse`` take no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal):
        out, lse = flash_fwd(q, k, v, causal, key_mask=key_mask)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, key_mask, out, lse)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, key_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, dout.contiguous(),
                               ctx.causal, key_mask)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tiled attention ``(out, lse)``, differentiable in q, k and v."""
    return _FlashAttention.apply(q, k, v, None, causal)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     key_mask: torch.Tensor, causal: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention with a ``[B, Tk]`` {0,1} key mask: masked keys get ``-1e30``
    logits, and rows whose keys are all masked output 0. ``(out, lse)``,
    differentiable in q, k and v."""
    return _FlashAttention.apply(q, k, v, key_mask, causal)
