"""The recurrent engine: the LSTM cell over a sequence, and its gradient.

Counterpart of ``deeplearning4j_tpu/ops/lstm.py``. Gate order is input,
forget, cell (g), output; the Graves peepholes tap ``c_{t-1}`` on the i and f
gates and ``c_t`` on the o gate; a per-step mask (``> 0`` means live) holds
``h`` and ``c`` on masked steps and still writes them out.

- :func:`lstm_scan` is the plain oracle (one input matmul over all steps,
  then a recurrent matmul per step) and :func:`lstm_fused` the per-step
  ``[B, F+H] x [F+H, 4H]`` form, both in plain PyTorch.
- :func:`lstm_fwd` and :func:`lstm_bwd` are the wrappers of the cell
  kernels of ``csrc/lstm.cu``, with the argument and result contracts
  of the JAX package's ``_pallas_forward`` and ``_pallas_backward``. On CUDA
  tensors they launch the kernels at any ``T >= 1``, ``H`` and ``F``, with
  float32 or bfloat16 operands (one dtype for all of a call's inputs); on CPU
  tensors they run :func:`lstm_fwd_plain` and :func:`lstm_bwd_plain`, which
  compute the kernel bodies' math. Either way the work is in float32 (the
  JAX kernels' ``promote(x.dtype, float32)``): the forward returns ``ys``
  and ``cs`` in ``x``'s dtype and ``h``, ``c`` in ``h0``'s, the backward
  ``dx`` in ``x``'s dtype and ``dW``, ``db``, ``dpeep``, ``dh0``, ``dc0`` in
  float32. Each counts its launches in ``.launches``.
- :class:`LSTMCell` is the ``torch.autograd.Function`` over the two (the JAX
  package's ``custom_vjp``): the forward saves ``ys`` and ``cs``; the
  backward rebuilds the per-step ``h_{t-1}``/``c_{t-1}`` by shifting them
  with ``h0``/``c0`` in front.
- :func:`lstm_sequence` is the seam layers call. A standard cell (tanh with
  sigmoid gates) goes through :class:`LSTMCell`, its operands cast to the
  policy's compute dtype and its outputs to the output dtype, as the JAX
  adapter casts them. A cell with other
  activations runs :func:`lstm_fused`: the JAX package computes that cell
  outside any Pallas kernel too (its kernels' backward is derived for the
  standard cell alone), so this is the reference's own route for it.

The TPU kernels' block size, VMEM budget, padding of T to a block and
dispatch thresholds have no counterpart: the CUDA kernels take the sequence
as it is.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..common import accum_dtype, get_policy
from . import _cuda

Tensor = torch.Tensor
STANDARD_ACT, STANDARD_GATE = "tanh", "sigmoid"


def _mm(a: Tensor, b: Tensor, dtype) -> Tensor:
    adt = accum_dtype(dtype)
    if adt is None:
        return torch.matmul(a, b)
    return torch.matmul(a.to(adt), b.to(adt)).to(dtype)


# ------------------------------------------------------------ plain engines
def lstm_scan(params: dict, x: Tensor, act, gate_act, h0: Tensor, c0: Tensor,
              peephole: bool, mask: Optional[Tensor]):
    """Reference oracle: the input contraction for all steps at once, then
    the recurrent matmul per step. ``x [B, T, F] -> (ys [B, T, H], (h, c))``."""
    pol = get_policy()
    cd, od = pol.compute_dtype, pol.output_dtype
    w, rw, b = (params[k].to(cd) for k in ("W", "RW", "b"))
    xw = _mm(x.to(cd), w, cd) + b
    h, c = h0, c0
    ys = []
    for t in range(x.shape[1]):
        z = (xw[:, t] + _mm(h.to(cd), rw, cd)).to(od)
        zi, zf, zg, zo = torch.chunk(z, 4, dim=-1)
        if peephole:
            zi = zi + c * params["pI"].to(od)
            zf = zf + c * params["pF"].to(od)
        i, f, g = gate_act(zi), gate_act(zf), act(zg)
        c_new = f * c + i * g
        if peephole:
            zo = zo + c_new * params["pO"].to(od)
        h_new = gate_act(zo) * act(c_new)
        if mask is not None:
            m = mask[:, t, None] > 0
            h_new = torch.where(m, h_new, h)
            c_new = torch.where(m, c_new, c)
        h, c = h_new, c_new
        ys.append(h)
    return torch.stack(ys, dim=1), (h, c)


def lstm_fused(params: dict, x: Tensor, act, gate_act, h0: Tensor, c0: Tensor,
               peephole: bool, mask: Optional[Tensor]):
    """One ``[B, F+H] x [F+H, 4H]`` matmul per step over the concatenated
    weights, the four gate activations applied on the ``[B, 4, H]`` view.
    Same contract as :func:`lstm_scan`; the route of cells with activations
    other than tanh/sigmoid."""
    pol = get_policy()
    cd, od = pol.compute_dtype, pol.output_dtype
    wcat = torch.cat([params["W"], params["RW"]], dim=0).to(cd)
    b = params["b"].to(od)
    B, hidden = x.shape[0], params["RW"].shape[0]
    if peephole:
        zeros_h = torch.zeros_like(params["pI"])
        # rows (pI, pF, 0, 0): the o-gate peephole taps c_new, added below
        p_if = torch.stack([params["pI"], params["pF"], zeros_h, zeros_h]
                           ).to(od)
        p_o = params["pO"].to(od)
    cell_gate = (torch.arange(4, device=x.device) == 2).reshape(1, 4, 1)
    h, c = h0, c0
    ys = []
    for t in range(x.shape[1]):
        xh = torch.cat([x[:, t].to(cd), h.to(cd)], dim=-1)
        z4 = (_mm(xh, wcat, cd).to(od) + b).reshape(B, 4, hidden)
        if peephole:
            z4 = z4 + c[:, None, :] * p_if
        g4 = torch.where(cell_gate, act(z4), gate_act(z4))
        i, f, g, o = g4[:, 0], g4[:, 1], g4[:, 2], g4[:, 3]
        c_new = f * c + i * g
        if peephole:
            o = gate_act(z4[:, 3] + c_new * p_o)
        h_new = o * act(c_new)
        if mask is not None:
            m = mask[:, t, None] > 0
            h_new = torch.where(m, h_new, h)
            c_new = torch.where(m, c_new, c)
        h, c = h_new, c_new
        ys.append(h)
    return torch.stack(ys, dim=1), (h, c)


# ------------------------------------------------- the kernels' plain math
def _wd(t: Tensor) -> Tensor:
    """The kernels' working dtype: float32, or wider when given wider (as
    the JAX kernels promote to at least float32)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _gates(z: Tensor, c: Tensor, peep: Optional[Tensor], H: int):
    zi, zf, zg, zo = z[:, :H], z[:, H:2 * H], z[:, 2 * H:3 * H], z[:, 3 * H:]
    if peep is not None:
        zi = zi + c * peep[0]
        zf = zf + c * peep[1]
    i, f, g = torch.sigmoid(zi), torch.sigmoid(zf), torch.tanh(zg)
    c_new = f * c + i * g
    if peep is not None:
        zo = zo + c_new * peep[2]
    return i, f, g, torch.sigmoid(zo), c_new


def lstm_fwd_plain(x_t: Tensor, wcat: Tensor, b: Tensor,
                   peep: Optional[Tensor], h0: Tensor, c0: Tensor,
                   m_t: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The forward kernel's math in float32 (:func:`_wd`): ``x_t [T, B, F]``, ``wcat
    [F+H, 4H]``, ``b [1, 4H]``, ``peep [3, H]`` (rows pI, pF, pO) or None,
    ``h0``/``c0 [B, H]``, ``m_t [T, B]`` -> ``(ys, cs [T, B, H], h, c)``;
    ``ys``/``cs`` in ``x_t``'s dtype, ``h``/``c`` in ``h0``'s, the carries
    never rounded."""
    H = h0.shape[-1]
    w, bb = _wd(wcat), _wd(b.reshape(-1))
    pp = None if peep is None else _wd(peep)
    h, c = _wd(h0), _wd(c0)
    ys, cs = [], []
    for t in range(x_t.shape[0]):
        z = torch.cat([_wd(x_t[t]), h], dim=-1) @ w + bb
        _, _, _, o, c_new = _gates(z, c, pp, H)
        h_new = o * torch.tanh(c_new)
        m = (m_t[t] > 0)[:, None]
        h = torch.where(m, h_new, h)
        c = torch.where(m, c_new, c)
        ys.append(h)
        cs.append(c)
    od = x_t.dtype
    return (torch.stack(ys).to(od), torch.stack(cs).to(od), h.to(h0.dtype),
            c.to(h0.dtype))


def lstm_bwd_plain(x_t: Tensor, hprev: Tensor, cprev: Tensor, wcat: Tensor,
                   b: Tensor, peep: Optional[Tensor], dys: Tensor, dht: Tensor,
                   dct: Tensor, m_t: Tensor):
    """The backward kernel's math in float32, in reverse time: recompute the
    gates from ``hprev``/``cprev [T, B, H]`` (``h``/``c`` before each step),
    form ``dz_t [B, 4H]`` with ``dh`` seeded from ``dht`` and ``dc`` from
    ``dct``, and carry ``dh_{t-1} = dz_t RW^T (+ the masked pass-through)``.
    Then ``dW = sum_t [x_t, hprev_t]^T dz_t``, ``db``, ``dpeep`` and ``dx =
    dz W_x^T``. Returns ``(dx [T, B, F], dW [F+H, 4H], db [1, 4H], dpeep
    [3, H], dh0, dc0 [B, H])``, ``dx`` in ``x_t``'s dtype and the rest in
    float32 (or wider); ``dpeep`` is zeros without peepholes."""
    T, B, F = x_t.shape
    H = hprev.shape[-1]
    w, bb = _wd(wcat), _wd(b.reshape(-1))
    pp = None if peep is None else _wd(peep)
    dh, dc = _wd(dht), _wd(dct)
    dzs = [None] * T
    dpeep = torch.zeros(3, H, dtype=w.dtype, device=x_t.device)
    for t in range(T - 1, -1, -1):
        cp = _wd(cprev[t])
        z = torch.cat([_wd(x_t[t]), _wd(hprev[t])], dim=-1) @ w + bb
        i, f, g, o, c_new = _gates(z, cp, pp, H)
        tc = torch.tanh(c_new)
        # masked steps froze state in the forward: their gradient passes
        # straight through to t-1 and the gates see zero
        live = (m_t[t] > 0)[:, None]
        dh_t = dh + _wd(dys[t])
        zero = torch.zeros_like(dh_t)
        dh_act = torch.where(live, dh_t, zero)
        dh_skip = torch.where(live, zero, dh_t)
        dc_act = torch.where(live, dc, zero)
        dc_skip = torch.where(live, zero, dc)
        dzo = dh_act * tc * o * (1.0 - o)
        dc_t = dc_act + dh_act * o * (1.0 - tc * tc)
        if pp is not None:
            dc_t = dc_t + dzo * pp[2]
        dzi = dc_t * g * i * (1.0 - i)
        dzf = dc_t * cp * f * (1.0 - f)
        dzg = dc_t * i * (1.0 - g * g)
        dz = torch.cat([dzi, dzf, dzg, dzo], dim=-1)
        dzs[t] = dz
        dh = dz @ w[F:].t() + dh_skip
        dc = dc_t * f + dc_skip
        if pp is not None:
            dc = dc + dzi * pp[0] + dzf * pp[1]
            dpeep += torch.stack([(dzi * cp).sum(0), (dzf * cp).sum(0),
                                  (dzo * c_new).sum(0)])
    dz = torch.stack(dzs).reshape(T * B, 4 * H)
    xs = _wd(x_t).reshape(T * B, F)
    hs = _wd(hprev).reshape(T * B, H)
    dw = torch.cat([xs.t() @ dz, hs.t() @ dz], dim=0)
    dx = (dz @ w[:F].t()).reshape(T, B, F).to(x_t.dtype)
    return dx, dw, dz.sum(0)[None], dpeep, dh, dc


# ------------------------------------------------------------ the kernels
_FWD_ARGS = ([_cuda.PTR] * 14 + [_cuda.INT] * 5 + [_cuda.INT] * 5
             + [_cuda.LONG, _cuda.INT, _cuda.PTR])
_BWD_ARGS = ([_cuda.PTR] * 10 + [_cuda.PTR] * 6 + [_cuda.PTR] * 3
             + [_cuda.INT] * 9 + [_cuda.LONG] * 2 + [_cuda.INT, _cuda.PTR])
#: the operand dtypes the CUDA kernels take
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _check_args(name: str, x_t: Tensor, h0: Tensor, wcat: Tensor, b: Tensor,
                peep: Optional[Tensor], m_t: Tensor, others) -> Tuple[int, ...]:
    if x_t.ndim != 3:
        raise ValueError(f"{name}: x_t must be [T, B, F], got {tuple(x_t.shape)}")
    T, B, F = x_t.shape
    H = h0.shape[-1]
    if T < 1 or B < 1 or H < 1:
        raise ValueError(f"{name}: needs T, B, H >= 1, got T={T} B={B} H={H}")
    want = {"h0": (h0, (B, H)), "wcat": (wcat, (F + H, 4 * H)),
            "b": (b, (1, 4 * H)), "m_t": (m_t, (T, B)), **others}
    if peep is not None:
        want["peep"] = (peep, (3, H))
    for key, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} must be {shape}, got "
                             f"{tuple(t.shape)}")
    tensors = [x_t, h0, wcat, b, m_t] + [t for t, _ in others.values()]
    if peep is not None:
        tensors.append(peep)
    if any(t.device != x_t.device for t in tensors):
        raise ValueError(f"{name}: operands must share one device")
    if x_t.device.type == "cuda":
        if x_t.dtype not in KERNEL_DTYPES or any(t.dtype != x_t.dtype
                                                 for t in tensors):
            raise TypeError(f"{name}: the CUDA kernel takes operands of one "
                            "dtype, float32 or bfloat16; got "
                            f"{sorted({str(t.dtype) for t in tensors})}")
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError(f"{name}: the CUDA kernel needs contiguous "
                             "operands")
    elif x_t.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {x_t.device}")
    return T, B, F, H


def _ptr(t: Optional[Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


@_cuda.counted
def lstm_fwd(x_t: Tensor, wcat: Tensor, b: Tensor, peep: Optional[Tensor],
             h0: Tensor, c0: Tensor, m_t: Tensor
             ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The LSTM cell forward over ``T`` steps; contract of
    :func:`lstm_fwd_plain`. On CUDA tensors (contiguous, all float32 or all
    bfloat16) this launches ``lstm_fwd`` of ``csrc/lstm.cu`` with the
    shape's :func:`lstm_plan` (for ``T > 1`` the hoisted input product, then
    the recurrence; for ``T = 1`` one step); on CPU tensors it runs the
    plain version."""
    T, B, F, H = _check_args("lstm_fwd", x_t, h0, wcat, b, peep, m_t,
                             {"c0": (c0, tuple(h0.shape))})
    if x_t.device.type == "cpu":
        return lstm_fwd_plain(x_t, wcat, b, peep, h0, c0, m_t)
    bf = x_t.dtype == torch.bfloat16
    f32 = dict(dtype=torch.float32, device=x_t.device)
    plan = lstm_plan(T, B, F, H, x_t.dtype)
    ys = torch.empty(T, B, H, dtype=x_t.dtype, device=x_t.device)
    cs = torch.empty_like(ys)
    h = torch.empty_like(h0)
    c = torch.empty_like(h0)
    # zx = x W_x + b for every row, read by the recurrence; with bf16 the
    # float32 h (and, unless the c carry is in shared memory, c) of every
    # step, which the recurrence reads back unrounded
    zx = torch.empty(T, B, 4 * H, **f32) if plan["route"] else None
    hf = torch.empty(T, B, H, **f32) if bf and plan["route"] else None
    cf = (torch.empty(T, B, H, **f32)
          if bf and plan["route"] and not plan["c_shared"] else None)
    fn = _cuda.function("lstm", "lstm_fwd", _FWD_ARGS)
    rc = fn(x_t.data_ptr(), wcat.data_ptr(), b.data_ptr(), _ptr(peep),
            h0.data_ptr(), c0.data_ptr(), m_t.data_ptr(), _ptr(zx),
            ys.data_ptr(), cs.data_ptr(), h.data_ptr(), c.data_ptr(),
            _ptr(hf), _ptr(cf), T, B, F, H, int(peep is not None),
            plan["route"], plan["units"], plan["rows"], plan["w_shared"],
            plan["c_shared"], plan["smem"], int(bf), _cuda.stream_handle())
    _cuda.check(rc, "lstm", "lstm_fwd launch")
    _cuda.count(lstm_fwd)
    return ys, cs, h, c


@_cuda.counted
def lstm_bwd(x_t: Tensor, hprev: Tensor, cprev: Tensor, wcat: Tensor,
             b: Tensor, peep: Optional[Tensor], dys: Tensor, dht: Tensor,
             dct: Tensor, m_t: Tensor):
    """The LSTM cell backward in reverse time; contract of
    :func:`lstm_bwd_plain`. On CUDA tensors (contiguous, all float32 or all
    bfloat16) this launches ``lstm_bwd`` of ``csrc/lstm.cu`` (the hoisted
    gate product, the recurrence, then the tail's products, all on the
    stream); on CPU tensors it runs the plain version."""
    T, B, F = x_t.shape
    H = hprev.shape[-1]
    _check_args("lstm_bwd", x_t, dht, wcat, b, peep, m_t, {
        "hprev": (hprev, (T, B, H)), "cprev": (cprev, (T, B, H)),
        "dys": (dys, (T, B, H)), "dct": (dct, (B, H)), "dht": (dht, (B, H))})
    if x_t.device.type == "cpu":
        return lstm_bwd_plain(x_t, hprev, cprev, wcat, b, peep, dys, dht,
                              dct, m_t)
    f32 = dict(dtype=torch.float32, device=x_t.device)
    plan = lstm_bwd_plan(T, B, F, H, peep is not None, x_t.dtype)
    dx = torch.empty_like(x_t)
    dw = torch.empty(F + H, 4 * H, **f32)
    db = torch.empty(1, 4 * H, **f32)
    dpeep = torch.zeros(3, H, **f32)
    dh0 = torch.empty(B, H, **f32)
    dc0 = torch.empty(B, H, **f32)
    # scratch: z, then dz, for every row (the tail reads dz); the peephole
    # products each (row, unit) accumulates over time, [B, 3H]; the tail's
    # per-slice partial sums
    zdz = torch.empty(T, B, 4 * H, **f32)
    pacc = torch.empty(B, 3 * H, **f32)
    part = torch.empty(max(1, plan["scratch"]), **f32)
    fn = _cuda.function("lstm", "lstm_bwd", _BWD_ARGS)
    rc = fn(x_t.data_ptr(), hprev.data_ptr(), cprev.data_ptr(),
            wcat.data_ptr(), b.data_ptr(), _ptr(peep), dys.data_ptr(),
            dht.data_ptr(), dct.data_ptr(), m_t.data_ptr(),
            dx.data_ptr(), dw.data_ptr(), db.data_ptr(), dpeep.data_ptr(),
            dh0.data_ptr(), dc0.data_ptr(), zdz.data_ptr(), pacc.data_ptr(),
            part.data_ptr(), T, B, F, H, int(peep is not None),
            plan["units"], plan["rows"], plan["w_shared"], plan["c_shared"],
            plan["smem"], plan["scratch"], int(x_t.dtype == torch.bfloat16),
            _cuda.stream_handle())
    _cuda.check(rc, "lstm", "lstm_bwd launch")
    _cuda.count(lstm_bwd)
    return dx, dw, db, dpeep, dh0, dc0


@functools.lru_cache(maxsize=256)
def _fwd_plan(device: int, route: int, B: int, F: int, H: int,
              bf: bool) -> dict:
    out = (ctypes.c_longlong * 8)()
    fn = _cuda.function("lstm", "lstm_plan", [_cuda.INT] * 5 + [_cuda.PTR])
    # the plan depends on T only through the route: 2 stands for any T > 1
    _cuda.check(fn(1 + route, B, F, H, int(bf), ctypes.addressof(out)),
                "lstm", "lstm_plan")
    keys = ("route", "units", "blocks", "rows", "smem", "w_shared",
            "c_shared", "max_blocks")
    return dict(zip(keys, list(out)))


def lstm_plan(T: int, B: int, F: int, H: int,
              dtype: torch.dtype = torch.float32) -> dict:
    """The forward's launch on the current card, worked out once a shape and
    handed to the kernel, which only checks it: the route (1: ``T > 1``, the
    hoisted product and the cooperative recurrence; 0: ``T = 1``, one
    ordinary launch of the step), hidden units per block (``max(2, ceil(H /
    SMs))``), blocks, batch rows staged per pass, shared memory, whether the
    weight columns and the c carry sit in shared memory, and the most
    co-resident blocks, for operands of ``dtype``. CUDA only."""
    return dict(_fwd_plan(torch.cuda.current_device(), int(T > 1), B, F, H,
                          dtype == torch.bfloat16))


@functools.lru_cache(maxsize=256)
def _bwd_plan(device: int, T: int, B: int, F: int, H: int,
              peephole: bool, bf: bool) -> dict:
    out = (ctypes.c_longlong * 9)()
    fn = _cuda.function("lstm", "lstm_bwd_plan",
                        [_cuda.INT] * 6 + [_cuda.PTR])
    _cuda.check(fn(T, B, F, H, int(peephole), int(bf),
                   ctypes.addressof(out)), "lstm", "lstm_bwd_plan")
    keys = ("units", "blocks", "rows", "smem", "w_shared", "c_shared",
            "max_blocks", "tail_blocks", "scratch")
    return dict(zip(keys, list(out)))


def lstm_bwd_plan(T: int, B: int, F: int, H: int, peephole: bool = True,
                  dtype: torch.dtype = torch.float32) -> dict:
    """The backward's launch on the current card, worked out once a shape
    and handed to the kernel, which only checks it: the recurrence's units
    per block (``max(2, ceil(H / SMs))``), blocks, batch rows of dz_t
    staged per pass, shared memory, whether RW's rows and the carries sit
    in shared memory, the most co-resident blocks, the tail's blocks and its
    scratch floats, for operands of ``dtype``. CUDA only."""
    return dict(_bwd_plan(torch.cuda.current_device(), T, B, F, H,
                          bool(peephole), dtype == torch.bfloat16))


# ------------------------------------------------------------ the gradient
class LSTMCell(torch.autograd.Function):
    """``(x_t, wcat, b, peep, h0, c0, m_t) -> (ys, h, c)`` through
    :func:`lstm_fwd`, with :func:`lstm_bwd` as its backward. ``peep`` may be
    None (no peepholes; its gradient is then None). The mask takes no
    gradient. The gradients return in their inputs' dtypes, as the JAX
    ``custom_vjp`` returns them (the kernel's float32 ``dW`` of bf16 ``wcat``
    rounds to bf16 there too)."""

    @staticmethod
    def forward(ctx, x_t, wcat, b, peep, h0, c0, m_t):
        ys, cs, h, c = lstm_fwd(x_t, wcat, b, peep, h0, c0, m_t)
        ctx.save_for_backward(x_t, wcat, b, peep, h0, c0, m_t, ys, cs)
        return ys, h, c

    @staticmethod
    def backward(ctx, dys, dht, dct):
        x_t, wcat, b, peep, h0, c0, m_t, ys, cs = ctx.saved_tensors
        # h_{t-1}/c_{t-1} per step: the saved outputs shifted by one with
        # the initial state in front
        hprev = torch.cat([h0[None], ys[:-1]], dim=0)
        cprev = torch.cat([c0[None], cs[:-1]], dim=0)

        def dense(g, like):
            return (torch.zeros_like(like) if g is None
                    else g.to(like.dtype).contiguous())

        dx, dw, db, dp, dh0, dc0 = lstm_bwd(
            x_t, hprev, cprev, wcat, b, peep, dense(dys, ys), dense(dht, h0),
            dense(dct, c0), m_t)
        return (dx, dw.to(wcat.dtype), db.to(b.dtype),
                None if peep is None else dp.to(peep.dtype),
                dh0.to(h0.dtype), dc0.to(c0.dtype), None)


def is_standard_cell(act_name, gate_name) -> bool:
    """True for the cell the kernels compute: tanh with sigmoid gates."""
    return (str(act_name or STANDARD_ACT).lower() == STANDARD_ACT
            and str(gate_name or STANDARD_GATE).lower() == STANDARD_GATE)


def lstm_sequence(params: dict, x: Tensor, act, gate_act, h0: Tensor,
                  c0: Tensor, peephole: bool, mask: Optional[Tensor], *,
                  act_name: Optional[str] = STANDARD_ACT,
                  gate_name: Optional[str] = STANDARD_GATE):
    """The recurrent entry point layers call (full sequences, TBPTT chunks
    and single steps alike): ``x [B, T, F] -> (ys [B, T, H], (h, c))``.
    A standard cell runs the kernels through :class:`LSTMCell`, every operand
    (the initial state and the mask too) in the policy's compute dtype and
    the results in its output dtype, as the JAX adapter runs its Pallas
    kernels; another cell runs :func:`lstm_fused`."""
    if not is_standard_cell(act_name, gate_name):
        return lstm_fused(params, x, act, gate_act, h0, c0, peephole, mask)
    pol = get_policy()
    cd, od = pol.compute_dtype, pol.output_dtype
    wcat = torch.cat([params["W"], params["RW"]], dim=0).to(cd).contiguous()
    b = params["b"].to(cd)[None]
    peep = (torch.stack([params["pI"], params["pF"], params["pO"]]).to(cd)
            if peephole else None)
    B, T = x.shape[0], x.shape[1]
    x_t = x.transpose(0, 1).to(cd).contiguous()
    m_t = (mask.transpose(0, 1).to(cd).contiguous() if mask is not None
           else torch.ones(T, B, dtype=cd, device=x.device))
    ys, h, c = LSTMCell.apply(x_t, wcat, b, peep, h0.to(cd).contiguous(),
                              c0.to(cd).contiguous(), m_t)
    return ys.transpose(0, 1).to(od), (h.to(od), c.to(od))
