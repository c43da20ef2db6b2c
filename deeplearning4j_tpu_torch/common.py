"""Dtype policy and device resolution for the PyTorch port.

Counterpart of ``deeplearning4j_tpu/common.py``: parameters are kept in
``param_dtype`` (float32 by default) while matmul and convolution compute
may run in ``compute_dtype`` and activations flow in ``output_dtype``. Two
knobs set the precision of reductions:

* ``reduction_dtype``: the dtype of batch-norm statistics
  (:meth:`DtypePolicy.stat_dtype`); None means at least float32.
* ``grad_accum_dtype``: the output dtype of the policy-routed dense and
  convolution contractions (:func:`accum_dtype`), which also fixes their
  weight gradients' dtype; None leaves the operands' dtype.

The four named policies a config may name (``GlobalConf.dtype``) are
``float32``, ``bfloat16`` (bf16 compute, float32 activations),
``bfloat16_full`` (bf16 compute and activations) and
``bfloat16_flagship`` (``bfloat16_full`` with bf16 batch-norm statistics
and float32 weight-gradient accumulation). Parameters, updater state, batch
norm's running state and every loss stay float32 under each.

The JAX package reads the policy once, when it traces a program. Eager
PyTorch reads it at every call, so the override is per context
(:mod:`contextvars`): :func:`override_policy` installs a named policy for
the current thread's block only, and a serving thread and a training thread
whose configs name different policies never see each other's. Outside any
override the process-wide policy of :func:`set_policy` holds.

Float32 matmuls in this package are full float32: every entry point calls
:func:`resolve_device`, which turns TF32 off for cuBLAS and cuDNN. TF32
keeps about three decimal digits, which is not the float32 the JAX
reference computes.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32
    # None = derived defaults, as in the JAX package
    reduction_dtype: Optional[torch.dtype] = None
    grad_accum_dtype: Optional[torch.dtype] = None

    def stat_dtype(self, x_dtype: torch.dtype) -> torch.dtype:
        """Dtype of normalization statistics over an ``x_dtype`` tensor: the
        explicit ``reduction_dtype`` when set, else at least float32. A
        float64 tensor is never reduced in a narrower dtype."""
        if self.reduction_dtype is not None:
            bits = torch.finfo(x_dtype).bits
            if bits > torch.finfo(self.reduction_dtype).bits and bits > 32:
                return x_dtype
            return self.reduction_dtype
        return at_least_f32(x_dtype)


_POLICY = DtypePolicy()
#: the policy of the current context's override (None: the global one)
_OVERRIDE: contextvars.ContextVar = contextvars.ContextVar(
    "dl4j_dtype_policy", default=None)
_UNSET = object()


def get_policy() -> DtypePolicy:
    """The policy in force here: the context's override, else the global
    one."""
    return _OVERRIDE.get() or _POLICY


def _dtype_name(d: Optional[torch.dtype]) -> Optional[str]:
    return None if d is None else str(d).replace("torch.", "")


def policy_key() -> tuple:
    """Hashable identity of the policy in force: the storage and compute
    dtypes and both reduction knobs, by name."""
    pol = get_policy()
    return tuple(_dtype_name(d) for d in (
        pol.param_dtype, pol.compute_dtype, pol.output_dtype,
        pol.reduction_dtype, pol.grad_accum_dtype))


def effective_policy_key(conf_dtype: Optional[str]) -> tuple:
    """The key of a network's captured programs: a config that names a
    policy pins them to it whatever the ambient policy; otherwise they
    follow the policy in force."""
    return (conf_dtype,) if conf_dtype else (None,) + policy_key()


def set_policy(param_dtype=None, compute_dtype=None, output_dtype=None,
               reduction_dtype=_UNSET, grad_accum_dtype=_UNSET) -> DtypePolicy:
    """Update the policy in force: the global one, or the context's
    override inside :func:`override_policy` (until the block ends, as in
    the JAX package). The three storage/compute dtypes keep their current
    value when None; the two reduction knobs use an explicit unset sentinel
    because None means "derive the default" for them."""
    global _POLICY
    cur = get_policy()
    new = DtypePolicy(
        param_dtype=param_dtype or cur.param_dtype,
        compute_dtype=compute_dtype or cur.compute_dtype,
        output_dtype=output_dtype or cur.output_dtype,
        reduction_dtype=(cur.reduction_dtype if reduction_dtype is _UNSET
                         else reduction_dtype),
        grad_accum_dtype=(cur.grad_accum_dtype if grad_accum_dtype is _UNSET
                          else grad_accum_dtype),
    )
    if _OVERRIDE.get() is not None:
        _OVERRIDE.set(new)
    else:
        _POLICY = new
    return new


def accum_dtype(operand_dtype: torch.dtype) -> Optional[torch.dtype]:
    """The policy's ``grad_accum_dtype`` when it widens the operands, else
    None (already-wide operands keep their dtype)."""
    g = get_policy().grad_accum_dtype
    if g is None or torch.finfo(operand_dtype).bits >= torch.finfo(g).bits:
        return None
    return g


def at_least_f32(dtype: torch.dtype) -> torch.dtype:
    """float32 for bf16/f16 activations, otherwise the dtype unchanged."""
    return dtype if torch.finfo(dtype).bits >= 32 else torch.float32


_NAMED_POLICIES = {
    "float32": DtypePolicy(),
    "bfloat16": DtypePolicy(compute_dtype=torch.bfloat16),
    "bfloat16_full": DtypePolicy(compute_dtype=torch.bfloat16,
                                 output_dtype=torch.bfloat16),
    "bfloat16_flagship": DtypePolicy(compute_dtype=torch.bfloat16,
                                     output_dtype=torch.bfloat16,
                                     reduction_dtype=torch.bfloat16,
                                     grad_accum_dtype=torch.float32),
}


def resolve_policy(name: str) -> DtypePolicy:
    """Named policy for the config's ``dtype`` field."""
    key = str(name).lower()
    if key not in _NAMED_POLICIES:
        raise ValueError(f"Unknown dtype policy '{name}'. "
                         f"Known: {sorted(_NAMED_POLICIES)}")
    return _NAMED_POLICIES[key]


@contextlib.contextmanager
def override_policy(name: Optional[str]):
    """Run the block under the named policy in this context only (other
    threads keep theirs); None leaves the policy in force."""
    if not name:
        yield
        return
    token = _OVERRIDE.set(resolve_policy(name))
    try:
        yield
    finally:
        _OVERRIDE.reset(token)


def wrap_with_policy(fn, name: Optional[str]):
    """``fn`` run under the named policy (``fn`` itself when name is
    None)."""
    if not name:
        return fn

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with override_policy(name):
            return fn(*args, **kwargs)
    return wrapped


def under_conf_policy(method):
    """A method of a network (or of an object serving one, through its
    ``conf``) run under the policy its config names, whatever the ambient
    one: the counterpart of the JAX package wrapping every traced program
    of a network with :func:`wrap_with_policy`. The config is read at each
    call, so a config edited after construction is followed."""
    @functools.wraps(method)
    def wrapped(self, *args, **kwargs):
        return wrap_with_policy(method, self.conf.global_conf.dtype)(
            self, *args, **kwargs)
    return wrapped


def bf16_matmul_policy() -> DtypePolicy:
    """bfloat16 compute, float32 params and activations."""
    return set_policy(compute_dtype=torch.bfloat16)


def full_bf16_policy() -> DtypePolicy:
    """bfloat16 compute and activations; float32 params, updater state,
    normalization statistics and losses."""
    return set_policy(compute_dtype=torch.bfloat16,
                      output_dtype=torch.bfloat16, reduction_dtype=None,
                      grad_accum_dtype=None)


def flagship_bf16_policy() -> DtypePolicy:
    """``bfloat16_flagship``: :func:`full_bf16_policy` with bf16 batch-norm
    statistics and float32 weight-gradient accumulation."""
    return set_policy(compute_dtype=torch.bfloat16,
                      output_dtype=torch.bfloat16,
                      reduction_dtype=torch.bfloat16,
                      grad_accum_dtype=torch.float32)


def host_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array; bfloat16 (which numpy lacks) widens
    to float32, exactly."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


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
