"""Gradient updaters, learning-rate schedules, and gradient normalization.

Counterpart of ``deeplearning4j_tpu/nn/updaters.py``, function by function.
Each is a plain function on tensors; schedules return a float32 scalar
tensor on the CPU (a 0-dim tensor combines with tensors on any device), and
the update math runs in float32, as in the JAX package. Under every named
dtype policy the parameters, and so the updater state, stay float32:
:func:`grads_to_param_dtype` is the one cast between a gradient and its
update.

Update sign convention: ``updater_step(...)`` returns the *step to subtract*
from the parameter (``param_new = param - step``), as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

Tensor = torch.Tensor


def _f32(x) -> Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


# --------------------------------------------------------------------------- schedules
def effective_lr(base_lr: float, policy: Optional[str], iteration,
                 decay: float = 0.0, power: float = 0.0, steps: float = 1.0,
                 schedule: Optional[dict] = None,
                 max_iterations: int = 1) -> Tensor:
    """Learning rate at ``iteration`` per DL4J LearningRatePolicy semantics,
    as a float32 scalar."""
    it = _f32(iteration)
    p = (policy or "none").lower()
    if p in ("none", "fixed"):
        return _f32(base_lr)
    if p == "exponential":
        return base_lr * torch.pow(_f32(decay), it)
    if p == "inverse":
        return base_lr / torch.pow(1.0 + decay * it, _f32(power))
    if p == "poly":
        return base_lr * torch.pow(1.0 - it / max(max_iterations, 1), _f32(power))
    if p == "sigmoid":
        return base_lr / (1.0 + torch.exp(-decay * (it - steps)))
    if p == "step":
        return base_lr * torch.pow(_f32(decay), torch.floor(it / steps))
    if p == "schedule":
        # piecewise-constant {iteration: lr}: lr of the largest key <= iteration
        lr = _f32(base_lr)
        for k in sorted((schedule or {}).keys(), key=int):
            lr = torch.where(it >= int(k), _f32((schedule or {})[k]), lr)
        return lr
    if p == "cosine":
        # half-cosine from base_lr to ~0 over max_iterations
        frac = torch.clamp(it / max(max_iterations, 1), 0.0, 1.0)
        return base_lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
    if p == "warmup_cosine":
        # linear warmup over `steps` iterations, then cosine to max_iterations
        warm = torch.clamp_min(_f32(steps), 1.0)
        warm_lr = base_lr * it / warm
        frac = torch.clamp((it - warm) / torch.clamp_min(max_iterations - warm, 1.0),
                           0.0, 1.0)
        cos_lr = base_lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return torch.where(it < warm, warm_lr, cos_lr)
    raise ValueError(f"Unknown lr policy '{policy}'")


def scheduled_value(base: float, schedule: Optional[dict], iteration) -> Tensor:
    """Momentum-after style schedules: ``{iteration: value}``."""
    val = _f32(base)
    if schedule:
        it = _f32(iteration)
        for k in sorted(schedule.keys(), key=int):
            val = torch.where(it >= int(k), _f32(schedule[k]), val)
    return val


# --------------------------------------------------------------------------- updaters
@dataclasses.dataclass(frozen=True)
class UpdaterSpec:
    """Resolved per-layer updater hyperparameters."""

    name: str = "sgd"
    momentum: float = 0.9
    momentum_schedule: Optional[dict] = None
    rho: float = 0.95              # adadelta
    rms_decay: float = 0.95
    adam_mean_decay: float = 0.9
    adam_var_decay: float = 0.999
    epsilon: float = 1e-8


def updater_init(spec: UpdaterSpec, param: Tensor) -> Dict[str, Tensor]:
    """Zero state of the updater for one parameter."""
    n = spec.name.lower()

    def z():
        return torch.zeros_like(param, dtype=param.dtype).detach()

    if n in ("sgd", "none", "noop"):
        return {}
    if n in ("nesterovs", "nesterov", "momentum"):
        return {"v": z()}
    if n == "adam":
        return {"m": z(), "v": z()}
    if n == "adagrad":
        return {"h": z()}
    if n == "rmsprop":
        return {"g2": z()}
    if n == "adadelta":
        return {"msg": z(), "msdx": z()}
    if n == "adamax":
        return {"m": z(), "u": z()}
    if n == "lars":
        return {"v": z()}
    if n == "lamb":
        return {"m": z(), "v": z()}
    raise ValueError(f"Unknown updater '{spec.name}'")


def updater_step(spec: UpdaterSpec, grad: Tensor, state: dict, lr: Tensor,
                 iteration) -> Tuple[Tensor, dict]:
    """One update: ``(step, new_state)``."""
    n = spec.name.lower()
    eps = spec.epsilon
    if n in ("none", "noop"):
        return torch.zeros_like(grad), state
    if n == "sgd":
        return lr * grad, state
    if n in ("nesterovs", "nesterov", "momentum"):
        # v = mu*v_prev - lr*g; applied delta = -mu*v_prev + (1+mu)*v,
        # returned here as the subtractend (step = -delta)
        mu = scheduled_value(spec.momentum, spec.momentum_schedule, iteration)
        v_prev = state["v"]
        v = mu * v_prev - lr * grad
        step = mu * v_prev - (1 + mu) * v
        return step, {"v": v}
    if n == "adam":
        b1, b2 = spec.adam_mean_decay, spec.adam_var_decay
        t = _f32(iteration) + 1.0
        m = b1 * state["m"] + (1 - b1) * grad
        v = b2 * state["v"] + (1 - b2) * grad * grad
        alpha = lr * torch.sqrt(1 - torch.pow(_f32(b2), t)) \
            / (1 - torch.pow(_f32(b1), t))
        return alpha * m / (torch.sqrt(v) + eps), {"m": m, "v": v}
    if n == "adamax":
        b1, b2 = spec.adam_mean_decay, spec.adam_var_decay
        t = _f32(iteration) + 1.0
        m = b1 * state["m"] + (1 - b1) * grad
        u = torch.maximum(b2 * state["u"], torch.abs(grad))
        return lr / (1 - torch.pow(_f32(b1), t)) * m / (u + eps), {"m": m, "u": u}
    if n == "adagrad":
        h = state["h"] + grad * grad
        return lr * grad / (torch.sqrt(h) + eps), {"h": h}
    if n == "rmsprop":
        d = spec.rms_decay
        g2 = d * state["g2"] + (1 - d) * grad * grad
        return lr * grad / torch.sqrt(g2 + eps), {"g2": g2}
    if n == "adadelta":
        rho = spec.rho
        msg = rho * state["msg"] + (1 - rho) * grad * grad
        dx = grad * torch.sqrt(state["msdx"] + eps) / torch.sqrt(msg + eps)
        msdx = rho * state["msdx"] + (1 - rho) * dx * dx
        return dx, {"msg": msg, "msdx": msdx}
    if n in ("lars", "lamb"):
        # trust-ratio updaters need the parameter value
        raise ValueError(f"'{n}' needs the param value: call "
                         "updater_step_with_param")
    raise ValueError(f"Unknown updater '{spec.name}'")


def _safe_norm(x: Tensor) -> Tensor:
    return torch.sqrt(torch.sum(x.to(torch.float32) ** 2) + 1e-12)


def updater_step_with_param(spec: UpdaterSpec, grad: Tensor, param: Tensor,
                            state: dict, lr: Tensor,
                            iteration) -> Tuple[Tensor, dict]:
    """Like :func:`updater_step`, for updaters whose math needs the
    parameter itself (LARS/LAMB layerwise trust ratios); every other updater
    falls through to :func:`updater_step`."""
    n = spec.name.lower()
    eps = spec.epsilon
    if n == "lars":
        mu = scheduled_value(spec.momentum, spec.momentum_schedule, iteration)
        w_norm = _safe_norm(param)
        g_norm = _safe_norm(grad)
        one = torch.ones((), dtype=torch.float32, device=grad.device)
        trust = torch.where(g_norm > 0, w_norm / g_norm, one)
        trust = torch.where(w_norm > 0, trust, one)
        v = mu * state["v"] + lr * trust * grad
        return v, {"v": v}
    if n == "lamb":
        b1, b2 = spec.adam_mean_decay, spec.adam_var_decay
        t = _f32(iteration) + 1.0
        m = b1 * state["m"] + (1 - b1) * grad
        v = b2 * state["v"] + (1 - b2) * grad * grad
        m_hat = m / (1 - torch.pow(_f32(b1), t))
        v_hat = v / (1 - torch.pow(_f32(b2), t))
        update = m_hat / (torch.sqrt(v_hat) + eps)
        w_norm = _safe_norm(param)
        u_norm = _safe_norm(update)
        one = torch.ones((), dtype=torch.float32, device=grad.device)
        trust = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm, one)
        return lr * trust * update, {"m": m, "v": v}
    return updater_step(spec, grad, state, lr, iteration)


# ------------------------------------------------------------- gradient normalization
def grads_to_param_dtype(grads, params):
    """Cast each layer's gradients to its parameters' dtypes: the updater
    state and the parameter deltas follow the parameter dtype."""
    return [{n: g.to(p[n].dtype) for n, g in gl.items()}
            for gl, p in zip(grads, params)]


def normalize_gradients(grads: dict, kind: Optional[str],
                        threshold: float) -> dict:
    """Per-layer gradient normalization or clipping, applied before the
    updater; ``grads`` is one layer's ``{param_name: grad}``."""
    if not kind or kind.lower() in ("none",):
        return grads
    k = kind.lower()
    if k == "renormalizel2perlayer":
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()) + 1e-12)
        return {n: g / norm for n, g in grads.items()}
    if k == "renormalizel2perparamtype":
        return {n: g / torch.sqrt(torch.sum(g * g) + 1e-12)
                for n, g in grads.items()}
    if k == "clipelementwiseabsolutevalue":
        t = threshold
        return {n: torch.clamp(g, -t, t) for n, g in grads.items()}
    if k == "clipl2perlayer":
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()) + 1e-12)
        scale = torch.clamp_max(threshold / norm, 1.0)
        return {n: g * scale for n, g in grads.items()}
    if k == "clipl2perparamtype":
        out = {}
        for n, g in grads.items():
            norm = torch.sqrt(torch.sum(g * g) + 1e-12)
            out[n] = g * torch.clamp_max(threshold / norm, 1.0)
        return out
    raise ValueError(f"Unknown gradient normalization '{kind}'")
