"""Global dtype policy and device resolution for the PyTorch port.

Counterpart of ``deeplearning4j_tpu/common.py``: parameters are kept in
``param_dtype`` (float32 by default) while matmul compute may run in
``compute_dtype``. The default policy is all-float32, as in the JAX package.

Float32 matmuls in this package are full float32: every entry point calls
:func:`resolve_device`, which turns TF32 off for cuBLAS and cuDNN. TF32
keeps about three decimal digits, which is not the float32 the JAX
reference computes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class DtypePolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32
    # None = derived defaults, as in the JAX package
    reduction_dtype: Optional[torch.dtype] = None
    grad_accum_dtype: Optional[torch.dtype] = None


_POLICY = DtypePolicy()
_UNSET = object()


def get_policy() -> DtypePolicy:
    return _POLICY


def set_policy(param_dtype=None, compute_dtype=None, output_dtype=None,
               reduction_dtype=_UNSET, grad_accum_dtype=_UNSET) -> DtypePolicy:
    """Update the global policy. The three storage/compute dtypes keep their
    current value when None; the two reduction knobs use an explicit unset
    sentinel because None means "derive the default" for them."""
    global _POLICY
    _POLICY = DtypePolicy(
        param_dtype=param_dtype or _POLICY.param_dtype,
        compute_dtype=compute_dtype or _POLICY.compute_dtype,
        output_dtype=output_dtype or _POLICY.output_dtype,
        reduction_dtype=(_POLICY.reduction_dtype if reduction_dtype is _UNSET
                         else reduction_dtype),
        grad_accum_dtype=(_POLICY.grad_accum_dtype if grad_accum_dtype is _UNSET
                          else grad_accum_dtype),
    )
    return _POLICY


def accum_dtype(operand_dtype: torch.dtype) -> Optional[torch.dtype]:
    """The policy's ``grad_accum_dtype`` when it widens the operands, else
    None (already-wide operands keep their dtype)."""
    g = _POLICY.grad_accum_dtype
    if g is None or torch.finfo(operand_dtype).bits >= torch.finfo(g).bits:
        return None
    return g


def at_least_f32(dtype: torch.dtype) -> torch.dtype:
    """float32 for bf16/f16 activations, otherwise the dtype unchanged."""
    return dtype if torch.finfo(dtype).bits >= 32 else torch.float32


_NAMED_POLICIES = {
    "float32": DtypePolicy(),
    "bfloat16": DtypePolicy(compute_dtype=torch.bfloat16),
}


def resolve_policy(name: str) -> DtypePolicy:
    """Named policy for the config's ``dtype`` field."""
    key = str(name).lower()
    if key not in _NAMED_POLICIES:
        raise ValueError(f"Unknown dtype policy '{name}'. "
                         f"Known: {sorted(_NAMED_POLICIES)}")
    return _NAMED_POLICIES[key]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means CUDA. Raises when
    CUDA is asked for and there is none; the CPU is used only when the
    caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
