"""Int8 weight quantization for the serving path.

Counterpart of ``deeplearning4j_tpu/ops/quant.py``. At pin time
(:func:`quantize_tree`) every large floating matrix leaf becomes a
:class:`QuantizedLeaf`: int8 codes plus float32 symmetric per-output-channel
scales (absmax / 127 over every axis but the last). The codes are the JAX
package's exactly: round half to even, clip to +-127, scale 1 for an
all-zero channel.

:func:`quantized_matmul` is the matmul seam of the decode step. A quantized
weight goes through :func:`int8_matmul`, whose CUDA kernel
(``csrc/int8_matmul.cu``) applies the per-channel scale to the float32
accumulator and never writes a dequantized weight to device memory. A dense
weight takes a plain ``torch.matmul``, as the JAX package leaves it to XLA.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from . import _cuda

#: leaves smaller than this stay dense: biases, norm scales and tiny heads
MIN_QUANT_ELEMS = 1024


class QuantizedLeaf(NamedTuple):
    """One int8-quantized weight: ``q`` int8 codes in the weight's shape,
    ``scale`` float32 per output channel (last axis)."""

    q: torch.Tensor
    scale: torch.Tensor


def is_quantized(leaf: Any) -> bool:
    return isinstance(leaf, QuantizedLeaf)


def quantize_per_channel(w: torch.Tensor) -> QuantizedLeaf:
    """Symmetric per-output-channel (last axis) int8 quantization.

    Computed on the CPU (it runs at pin time, off the serving path), so the
    codes do not depend on the device's division and rounding: a quotient
    one ulp either side of .5 would otherwise round to another code."""
    wf = w.detach().to("cpu", torch.float32)
    absmax = wf.abs().amax(dim=tuple(range(wf.ndim - 1)))
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QuantizedLeaf(q=q.to(w.device), scale=scale.to(w.device))


def dequantize_leaf(leaf: QuantizedLeaf, dtype=torch.float32) -> torch.Tensor:
    return (leaf.q.to(torch.float32) * leaf.scale).to(dtype)


def _eligible(a: Any, min_elems: int) -> bool:
    return (isinstance(a, torch.Tensor) and a.ndim >= 2
            and a.numel() >= min_elems and a.is_floating_point())


def _map_tree(fn, tree):
    """Apply ``fn`` to every leaf of a list/dict tree; a QuantizedLeaf is a
    leaf."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    elif is_quantized(tree):
        yield tree.q
        yield tree.scale
    elif isinstance(tree, torch.Tensor):
        yield tree


def quantize_tree(tree, min_elems: int = MIN_QUANT_ELEMS):
    """Quantize every eligible leaf (floating, ndim >= 2, size >=
    ``min_elems``) of a list/dict param tree; the rest stays as it is."""
    return _map_tree(
        lambda a: quantize_per_channel(a) if _eligible(a, min_elems) else a,
        tree)


def dequantize_tree(tree, dtype=torch.float32):
    """A dense tree from a quantized one."""
    return _map_tree(
        lambda a: dequantize_leaf(a, dtype) if is_quantized(a) else a, tree)


def gather_rows(w, idx: torch.Tensor) -> torch.Tensor:
    """Row gather (embedding lookup) that understands :class:`QuantizedLeaf`:
    int8 rows are gathered first and scaled after."""
    if is_quantized(w):
        return w.q[idx].to(torch.float32) * w.scale
    return w[idx]


def tree_param_bytes(tree) -> int:
    """Resident bytes of a (possibly quantized) param tree."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


# ------------------------------------------------------------ dequant-free matmul
def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """The plain version of the kernel: ``(x @ float(q)) * scale`` in
    float32."""
    return torch.matmul(x.to(torch.float32), q.to(torch.float32)) * scale


#: the kernel's output tile (csrc/int8_matmul.cu): BN columns, BM rows of x
INT8_BN, INT8_BM = 64, 4


def int8_matmul_plan(M: int, K: int, N: int, sms: int) -> Tuple[int, int]:
    """``(kc, slices)``: the kernel's split of K into ``slices`` slices of
    ``kc`` rows (the last may be shorter), chosen so that the grid of
    ``ceil(N / BN) * ceil(M / BM) * slices`` blocks reaches ``sms``. Slice
    ``s`` covers rows ``[s * kc, min(K, (s + 1) * kc))``."""
    tiles = -(-N // INT8_BN) * -(-M // INT8_BM)
    if tiles >= sms or K <= 1:
        return max(K, 1), 1
    kc = max(1, (K * tiles) // sms)
    return kc, -(-K // kc)


_ARGS = [_cuda.PTR] * 6 + [_cuda.INT] * 6 + [_cuda.PTR]
#: per (device, stream, M, K, N): the plan, the float32 partials [S, M, N]
#: and the per-tile arrival counters (zero between launches: the last block
#: of a tile resets its own). Reusing them is safe on one stream, where
#: launches run in order; decode calls a handful of shapes every step.
_plans: Dict[tuple, tuple] = {}
_MAX_PLANS = 256


def _launch_plan(dev: int, stream: int, M: int, K: int, N: int) -> tuple:
    key = (dev, stream, M, K, N)
    plan = _plans.get(key)
    if plan is None:
        device = torch.device("cuda", dev)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        kc, slices = int8_matmul_plan(M, K, N, sms)
        part = counters = None
        if slices > 1:
            part = torch.empty((slices, M, N), dtype=torch.float32,
                               device=device)
            counters = torch.zeros(-(-N // INT8_BN) * -(-M // INT8_BM),
                                   dtype=torch.int32, device=device)
        if len(_plans) >= _MAX_PLANS:
            _plans.clear()
        plan = _plans[key] = (kc, slices, part, counters)
    return plan


@_cuda.counted
def int8_matmul(x: torch.Tensor, q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """``out[m, n] = scale[n] * sum_k x[m, k] * q[k, n]`` in float32.

    x ``[M, K]`` float32 or bfloat16, q ``[K, N]`` int8, scale ``[N]``
    float32, all contiguous on one device. On CUDA tensors this launches
    ``csrc/int8_matmul.cu`` (any M, K, N; K split per
    :func:`int8_matmul_plan`); on CPU tensors it runs the plain version."""
    if x.ndim != 2 or q.ndim != 2 or scale.ndim != 1:
        raise ValueError(f"int8_matmul needs x [M,K], q [K,N], scale [N]; got "
                         f"{tuple(x.shape)}, {tuple(q.shape)}, {tuple(scale.shape)}")
    M, K = x.shape
    if q.shape[0] != K or scale.shape[0] != q.shape[1]:
        raise ValueError(f"int8_matmul shape mismatch: x {tuple(x.shape)}, "
                         f"q {tuple(q.shape)}, scale {tuple(scale.shape)}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32 \
            or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int8_matmul needs float32/bfloat16 x, int8 q, float32 "
                        f"scale; got {x.dtype}, {q.dtype}, {scale.dtype}")
    if not (x.device == q.device == scale.device):
        raise ValueError("int8_matmul operands must share one device")
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    if not (x.is_contiguous() and q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("int8_matmul needs contiguous operands")
    N = q.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    stream = _cuda.stream_handle()
    kc, slices, part, counters = _launch_plan(x.device.index, stream, M, K, N)
    fn = _cuda.function("int8_matmul", "int8_matmul", _ARGS)
    rc = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            None if counters is None else counters.data_ptr(),
            M, K, N, kc, slices, int(x.dtype == torch.bfloat16), stream)
    _cuda.check(rc, "int8_matmul", "int8_matmul launch")
    _cuda.count(int8_matmul)
    return out


def quantized_matmul(x: torch.Tensor, w, *,
                     compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ w`` where ``w`` may be a :class:`QuantizedLeaf` or a dense
    tensor; the output is float32. Leading axes of ``x`` are flattened into
    the kernel's M."""
    cd = compute_dtype or x.dtype
    if not is_quantized(w):
        return torch.matmul(x.to(cd), w.to(cd)).to(torch.float32)
    lead = x.shape[:-1]
    x2 = x.to(cd).reshape(-1, x.shape[-1]).contiguous()
    return int8_matmul(x2, w.q, w.scale).reshape(*lead, w.q.shape[-1])
