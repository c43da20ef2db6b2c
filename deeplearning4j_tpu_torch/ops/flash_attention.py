"""Flash-attention forward.

Counterpart of the forward half of ``deeplearning4j_tpu/ops/pallas_kernels.py``
(``_flash_forward``, ``flash_attention``, ``masked_attention``). Both entry
points reach one kernel, ``csrc/flash_fwd.cu``, on CUDA tensors, at every
sequence length: the TPU's length gate (``_MIN_SEQ``) is not carried over,
and a crossover is for H100 measurements to set. On CPU tensors they run the
plain version.

The JAX conventions are kept exactly: logits scaled by ``1/sqrt(D)``,
masked logits ``-1e30`` (not ``-inf``), ``p = 0`` where the logit is
``<= -1e30``, ``l`` clamped at ``1e-20`` so a fully masked row outputs 0,
``lse = m + log(l)``. Layouts are the JAX package's: q, k, v and out
``[B, T, H, D]``, lse ``[B * H, Tq]`` float32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _cuda

NEG = -1e30
_HEAD_DIMS = (32, 64)


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


_ARGS = [_cuda.PTR, _cuda.PTR, _cuda.PTR, _cuda.PTR, _cuda.PTR, _cuda.PTR,
         _cuda.INT, _cuda.INT, _cuda.INT, _cuda.INT, _cuda.INT, _cuda.FLOAT,
         _cuda.INT, _cuda.INT, _cuda.PTR]


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, key_mask: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward returning ``(out [B,Tq,H,D], lse [B*H,Tq])``.

    q ``[B, Tq, H, D]``, k and v ``[B, Tk, H, D]``, one dtype (float32 or
    bfloat16); ``key_mask`` an optional ``[B, Tk]`` {0,1} mask. On CUDA
    tensors this launches ``csrc/flash_fwd.cu`` (D of 32 or 64; any
    lengths); on CPU tensors it runs the plain version."""
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
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_fwd kernel takes head dims {_HEAD_DIMS}, got {D}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_fwd needs contiguous q, k, v")
    km = None
    if key_mask is not None:
        km = key_mask.to(torch.float32).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((B * H, Tq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    fn = _cuda.function("flash_fwd", "flash_fwd", _ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if km is None else km.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, H, Tq, Tk, D, 1.0 / (D ** 0.5), int(causal),
            int(q.dtype == torch.bfloat16), _cuda.stream_handle())
    _cuda.check(rc, "flash_fwd", "flash_fwd launch")
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tiled attention forward: ``(out, lse)``."""
    return flash_fwd(q, k, v, causal)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     key_mask: torch.Tensor, causal: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention with a ``[B, Tk]`` {0,1} key mask: masked keys get ``-1e30``
    logits, and rows whose keys are all masked output 0. ``(out, lse)``."""
    return flash_fwd(q, k, v, causal, key_mask=key_mask)
