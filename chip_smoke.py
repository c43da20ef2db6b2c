#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Imports nothing of JAX and nothing of ``deeplearning4j_tpu``. In order:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel under ``deeplearning4j_tpu_torch/csrc`` with
   ``nvcc`` for ``sm_90a`` (one process per source, in parallel) and times
   the build;
3. holds each kernel against its plain PyTorch version on the card at the
   main paths' shapes and at edge shapes, with a stated tolerance, and times
   the kernel, the plain version and one PyTorch library call computing the
   same function (for the LSTM kernels ``torch.nn.LSTM``, cuDNN, which has
   no peepholes);
4. serves full-width ``transformer_lm(256)`` (random weights from a seed,
   int8 at rest) through ``InferenceServer`` on the card: 8 concurrent
   ``/v1/generate`` requests over the paged KV cache and one ``/v1/predict``
   of ``[2, 512]`` ids. It checks the answers against a CPU reference and
   that every serving kernel was launched by this traffic;
5. trains full-width ``transformer_lm(256)`` through
   ``MultiLayerNetwork.fit`` for 5 steps at B = 16, T = 256 (one-hot ids from
   a numpy seed, y = x, Adam at 3e-4) on the card and, from the same initial
   weights, on the CPU; checks each step's loss against the CPU run, that the
   loss falls, and the exact launch counts of the training kernels; then
   times train steps and profiles one (device time by kernel, idle share);
   then runs full-width ``transformer_lm(256, width=512)`` twice, at 4
   heads of 128 and at 2 heads of 256 (``csrc/flash_wide.cu``): one
   ``output`` and 2 ``fit`` steps at B = 4, T = 128 each against the CPU
   from the same weights, with exact flash launch counts;
6. serves full-width ``char_rnn_lstm(64, hidden=200)`` (random weights from
   a seed, float32): 8 concurrent ``/v1/generate`` requests over the LSTM
   decode engine and one ``/v1/stream`` session of 64 steps in two requests,
   then ``/v1/stream/reset``; checks every token and output against the CPU
   ``rnn_time_step`` and the exact launches of each path; profiles the
   generate traffic once more;
7. trains the same model (RMSProp at 0.01) through TBPTT ``fit``: 2
   batches of [32, 200, 64] one-hot ids (y = x), 8 chunks of 50, on the card and from the same
   weights on the CPU; checks every chunk's loss and the exact launch counts
   (``lstm_fwd`` 16, ``lstm_bwd`` 16, ``sm_xent`` 8); times chunks (wall,
   device time and idle share a chunk) and profiles one batch, with
   ``lstm_fwd``'s device time split into its hoisted input product and its
   recurrence, and ``lstm_bwd``'s into its hoisted gate product, its
   recurrence and its tail;
8. reads the profiler's device time of every main-path kernel row and its
   library call, and of ``lstm_fwd``'s two and ``lstm_bwd``'s three parts a
   call at the training shapes;
9. prints one JSON line describing each kernel, then
   ``{"ok": true, "device": {...}}`` as the last line.

Any failed check exits non-zero without the last line. Without CUDA it
exits non-zero before printing anything. Full results also go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import http.client
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from deeplearning4j_tpu_torch.keras_server import InferenceServer
from deeplearning4j_tpu_torch.keras_server.serve_profile import (
    device_time_by_kernel)
from deeplearning4j_tpu_torch.models import char_rnn_lstm, transformer_lm
from deeplearning4j_tpu_torch.nn.inference import PredictFn
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import _cuda
from deeplearning4j_tpu_torch.ops import lstm as lstm_ops
from deeplearning4j_tpu_torch.ops.flash_attention import (
    bwd_delta, flash_bwd_dkv, flash_bwd_dkv_plain, flash_bwd_dq,
    flash_bwd_dq_plain, flash_fwd, flash_fwd_plain)
from deeplearning4j_tpu_torch.ops.paged_attention import (
    paged_gather, paged_gather_plain)
from deeplearning4j_tpu_torch.ops.quant import (
    dequantize_leaf, int8_matmul, int8_matmul_plain, int8_matmul_plan,
    quantize_per_channel)
from deeplearning4j_tpu_torch.ops.softmax_xent import (
    sm_xent_plan, softmax_cross_entropy, softmax_cross_entropy_plain)

SEED = 1234
#: the training phase: the JAX package's LM bench geometry
TRAIN_B, TRAIN_T, TRAIN_V, TRAIN_STEPS = 16, 256, 256, 5
#: the recurrent path: full-width char_rnn_lstm (BASELINE config 3, the JAX
#: package's bench geometry), 2 batches of T = 200 = 4 TBPTT chunks of 50
RNN_V, RNN_H, RNN_B, RNN_T, RNN_CHUNK, RNN_BATCHES = 64, 200, 32, 200, 50, 2
RNN_DECODE_B = 8
#: the wide phase: full-width transformer_lm(256, width=512), 4 heads of 128
WIDE_WIDTH, WIDE_B, WIDE_T, WIDE_STEPS = 512, 4, 128, 2
#: the D > 128 phase: full-width transformer_lm(256, width=512, n_heads=2),
#: 2 heads of 256 (csrc/flash_wide.cu), at the wide phase's B and T
WIDE2_HEADS = 2
#: head dims the flash checks add to the main paths' 64: the kernel widths
#: 16 and 128, dims padded to a width (8, 12 -> 16; 40 -> 64), and dims above
#: 128 (flash_wide.cu's column groups: 2, 2 and 4)
FLASH_EDGE_DIMS = (8, 12, 16, 40, 128, 160, 256, 512)
#: RMSProp rate of the training phase. At the config's own 0.1 the loss
#: diverges (4.2 -> 44 in 8 chunks) and the card and the CPU drift 2e-4
#: apart (PERF.md, Findings); at 0.01 the run stays stable. Widths unchanged.
RNN_LR = 0.01
#: published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
#: (row, kernel call, library call) whose device time the profiler reads
#: after every other measurement (see measure_device_times)
DEVICE_TIMED: list = []
#: (row, wrapper, its arguments, its parts, the row's key) of the training
#: chunks, whose device time the profiler splits into lstm_fwd's and
#: lstm_bwd's parts after every other measurement
LSTM_SPLIT: list = []
#: lstm_bwd's parts by kernel: the hoisted gate product, the recurrence, the
#: tail's products and the sum of their slices (csrc/lstm.cu)
LSTM_BWD_PARTS = {"hoisted": ("lstm_z_kernel",),
                  "recurrence": ("lstm_bwd_kernel",),
                  "tail": ("lstm_tail_kernel", "lstm_sum_kernel")}
#: lstm_fwd's parts by kernel at T > 1: the hoisted input product and the
#: recurrence
LSTM_FWD_PARTS = {"hoisted": ("lstm_fwd_x_kernel",),
                  "recurrence": ("lstm_fwd_kernel",)}
#: the card's name and power limit, as nvidia-smi prints them
CARD = ""


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back calls,
    from CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 50) -> float:
    """Mean device time of one call of ``fn`` in ms from ``torch.profiler``
    over ``iters`` calls, after a warm-up: the device time a recorded event
    (kernels, copies) times the events a call makes, the median of three
    sessions. Unlike :func:`time_ms` it leaves out the host's time between
    launches, which dominates a kernel of a few microseconds."""
    for _ in range(3):
        fn()
    # a profiler session may record none or only a part of the device
    # events (seen on the H100: 44 of 50 launches of an 8 us kernel, a third
    # of a flash kernel's), so the time is taken a recorded event; the
    # events a call makes come from the fullest session, rounded
    got = []  # (device events, device us)
    for _ in range(8):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(device_time_by_kernel(prof).values())
        events = sum(e.count for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0 and events > 0:
            got.append((events, us))
            if len(got) == 3:
                per_call = max(1, round(max(n for n, _ in got) / iters))
                return sorted(us / n * per_call / 1e3 for n, us in got)[1]
        else:
            print("device_ms: the profiler saw no device time; again",
                  flush=True)
    fail(f"the profiler saw device time in {len(got)} of eight sessions")


def device_ms_by_kernel(fn, iters: int = 20) -> dict:
    """Device ms a call of ``fn`` by kernel (the profiler's name), as
    :func:`device_ms` takes it: each kernel's time a recorded event times
    the events a call makes (from the fullest of three sessions), the median
    of the three."""
    for _ in range(3):
        fn()
    sessions = []
    for _ in range(8):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        per = {}
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            if us and e.count:
                per[e.key] = (e.count, float(us))
        if per:
            sessions.append(per)
            if len(sessions) == 3:
                break
    if len(sessions) < 3:
        fail(f"the profiler saw device time in {len(sessions)} of eight "
             "sessions")
    out = {}
    for key in set().union(*sessions):
        seen = [s[key] for s in sessions if key in s]
        per_call = max(1, round(max(n for n, _ in seen) / iters))
        times = sorted(us / n for n, us in seen)
        out[key] = times[len(times) // 2] * per_call / 1e3
    return out


def kernel_parts(by_kernel: dict, parts: dict) -> dict:
    """Device time of a wrapper's parts (``LSTM_BWD_PARTS``,
    ``LSTM_FWD_PARTS``) from times by kernel name."""
    return {part: sum(v for k, v in by_kernel.items()
                      if any(n in k for n in names))
            for part, names in parts.items()}


def ptxas_report(log: str) -> list:
    """One line a kernel from nvcc's ``-Xptxas -v`` output: the kernel with
    its template arguments (read from the mangled name), registers, spills."""
    out, name, spill = [], "", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line.strip()
            p = name.find("_kernelI")
            if p >= 0:  # e.g. ...19flash_bwd_dq_kernelIfLi64EEEv...
                start = p
                while start > 0 and (name[start - 1].islower()
                                     or name[start - 1] == "_"):
                    start -= 1
                args = name[p + len("_kernelI"):].split("EEv")[0]
                dtype = "bf16" if "bfloat16" in args else "float"
                ints = re.findall(r"Li(\d+)E", args + "E")
                name = f"{name[start:p]}_kernel<{', '.join([dtype, *ints])}>"
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            regs = line.split("Used")[-1].split(",")[0].strip()
            out.append(f"{name}: {regs}; {spill}")
    return out


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    """Least time in ms the card could take and what bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def report(rows: list, name: str, shape: dict, err: float, tol: float,
           ms: float, plain_ms: float, library_ms, nbytes: float, ops: float,
           extra: dict = None):
    bound_ms, bound_by = bound(nbytes, ops)
    row = {"name": name, "shape": shape, "max_abs_err": err, "tol": tol,
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, **(extra or {})}
    rows.append(row)
    print(f"{name} {shape}: max_abs_err={err:.3e} (tol {tol:.0e}) "
          f"ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms={library_ms} "
          f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}, "
          f"{100 * row['bound_ms'] / ms:.1f}% of it)"
          + (f" [{row['card']}]" if "card" in row else ""), flush=True)
    if not err <= tol:
        fail(f"{name} {shape} disagrees with its plain version: "
             f"{err} > {tol}")
    return row


def measure_device_times() -> None:
    """``device_ms`` and ``library_device_ms`` of the rows queued in
    ``DEVICE_TIMED``. Run after every other timing: the profiler is left
    attached to the process once used, and could slow later launches."""
    for row, kernel, library in DEVICE_TIMED:
        row["device_ms"] = device_ms(kernel)
        row["library_device_ms"] = None if library is None \
            else device_ms(library)
        print(f"{row['name']} {row['shape']}: device_ms="
              f"{row['device_ms']:.5f} library_device_ms="
              f"{row['library_device_ms']} (torch.profiler, mean per call)",
              flush=True)
    # lstm_fwd's and lstm_bwd's parts at the training chunks' shapes
    for row, fn, args, parts, key in LSTM_SPLIT:
        got = kernel_parts(device_ms_by_kernel(lambda: fn(**args)), parts)
        row[key] = {**got, "total": sum(got.values())}
        print(f"{row['name']} {row['shape']}: device ms a call by part: "
              + ", ".join(f"{k} {v:.5f}" for k, v in row[key].items()),
              flush=True)


def check_int8(rows: list, dev) -> None:
    g = torch.Generator(device="cpu").manual_seed(SEED)
    # float32 sums in another order than cuBLAS: ~K * 2^-24 relative
    tol = 1e-4
    for M in (4, 8, 16):
        for K, N in ((256, 768), (256, 256), (256, 1024), (1024, 256)):
            x = torch.randn(M, K, generator=g).to(dev)
            leaf = quantize_per_channel(
                (torch.randn(K, N, generator=g) * 0.05).to(dev))
            wd = dequantize_leaf(leaf)
            out = int8_matmul(x, leaf.q, leaf.scale)
            ref = int8_matmul_plain(x, leaf.q, leaf.scale)
            again = int8_matmul(x, leaf.q, leaf.scale)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            if not torch.equal(out, again):
                fail(f"int8_matmul M={M} K={K} N={N} differs from run to run")
            kc, slices = int8_matmul_plan(
                M, K, N, torch.cuda.get_device_properties(dev)
                .multi_processor_count)

            def kernel(x=x, leaf=leaf):
                return int8_matmul(x, leaf.q, leaf.scale)

            def library(x=x, wd=wd):
                return torch.matmul(x, wd)

            row = report(rows, "int8_matmul", {"M": M, "K": K, "N": N}, err,
                         tol, time_ms(kernel),
                         time_ms(lambda: int8_matmul_plain(x, leaf.q,
                                                           leaf.scale)),
                         time_ms(library),
                         M * K * 4 + K * N + N * 4 + M * N * 4, 2 * M * K * N,
                         {"card": CARD, "plan": {"kc": kc, "slices": slices}})
            DEVICE_TIMED.append((row, kernel, library))
    x = torch.randn(16, 256, generator=g).to(dev).to(torch.bfloat16)
    leaf = quantize_per_channel(torch.randn(256, 768, generator=g).to(dev))
    err = float((int8_matmul(x, leaf.q, leaf.scale)
                 - int8_matmul_plain(x, leaf.q, leaf.scale)).abs().max())
    print(f"int8_matmul bf16 x: max_abs_err={err:.3e}", flush=True)
    if not err <= 1e-3:
        fail(f"int8_matmul with bfloat16 x disagrees: {err}")


def check_gather(rows: list, dev) -> None:
    g = torch.Generator(device="cpu").manual_seed(SEED)
    n_pages, ps, H, D, P = 16 * 32, 16, 4, 64, 32
    pool = torch.randn(n_pages + 1, ps, H, D, generator=g).to(dev)
    for cap in (8, 16):
        table = torch.randint(0, n_pages + 1, (cap, P), generator=g,
                              dtype=torch.int32)
        table[:, -3:] = 0  # trash page rows are gathered like any other
        table = table.to(dev)
        out = paged_gather(pool, table)
        ref = paged_gather_plain(pool, table)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            fail(f"paged_gather cap={cap} is not bitwise equal to index_select")
        flat = table.reshape(-1).long()
        nbytes = 2 * cap * P * ps * H * D * 4 + cap * P * 4

        def kernel(table=table):
            return paged_gather(pool, table)

        def library(flat=flat):
            return pool.index_select(0, flat)

        row = report(rows, "paged_gather",
                     {"n_pages": n_pages, "ps": ps, "H": H, "D": D,
                      "cap": cap, "P": P}, 0.0, 0.0, time_ms(kernel),
                     time_ms(lambda: paged_gather_plain(pool, table)),
                     time_ms(library), nbytes, 0)
        DEVICE_TIMED.append((row, kernel, library))


def check_flash(rows: list, dev) -> None:
    """Kernel 1 at the serving path's shapes (predict [2, 512], and B = 8),
    at the training path's (B 16, T 256), and at edge shapes: a ragged
    T = 100 with a key mask that fully masks one batch row, and bfloat16."""
    g = torch.Generator(device="cpu").manual_seed(SEED)
    # float32 online softmax against the one-pass plain version
    tol = 2e-5
    H, D = 4, 64
    for B, T in ((2, 512), (8, 512), (TRAIN_B, TRAIN_T)):
        q, k, v = (torch.randn(B, T, H, D, generator=g).to(dev)
                   for _ in range(3))
        out, lse = flash_fwd(q, k, v, True)
        ro, rl = flash_fwd_plain(q, k, v, True)
        again = flash_fwd(q, k, v, True)
        torch.cuda.synchronize()
        err = max(float((out - ro).abs().max()), float((lse - rl).abs().max()))
        if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
            fail(f"flash_fwd B={B} T={T} differs from run to run")
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        pairs = B * H * T * (T + 1) / 2
        nbytes, ops = 4 * B * T * H * D * 4 + B * H * T * 4, 4 * D * pairs

        def kernel(q=q, k=k, v=v):
            return flash_fwd(q, k, v, True)

        def library(qt=qt, kt=kt, vt=vt):
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

        # the kernel runs both products as three TF32 passes on the tensor
        # cores: its bound is that work at the TF32 peak; the float32 bound
        # (the same products on the CUDA cores) is kept beside it
        f32_ms, f32_by = bound(nbytes, ops)
        tc_ms, tc_by = bound(nbytes, 3 * ops, TF32_OPS_PER_S)
        row = report(rows, "flash_fwd", {"B": B, "T": T, "H": H, "D": D,
                                         "causal": True}, err, tol,
                     time_ms(kernel, iters=20),
                     time_ms(lambda: flash_fwd_plain(q, k, v, True), iters=20),
                     time_ms(library, iters=20), nbytes, ops,
                     {"card": CARD, "bound_ms": tc_ms, "bound_by": tc_by,
                      "bound_f32_ms": f32_ms, "bound_f32_by": f32_by})
        DEVICE_TIMED.append((row, kernel, library))
    # the wide phases' shapes (4 heads of 128; 2 heads of 256, flash_wide.cu),
    # timed beside their bounds, and bitwise the same from run to run. Every
    # width is held to the same bound: float32 work as three TF32 passes at
    # the tensor cores' peak
    for H_, D in ((H, 128), (WIDE2_HEADS, WIDE_WIDTH // WIDE2_HEADS)):
        B, T = WIDE_B, WIDE_T
        q, k, v = (torch.randn(B, T, H_, D, generator=g).to(dev)
                   for _ in range(3))
        out, lse = flash_fwd(q, k, v, True)
        again = flash_fwd(q, k, v, True)
        ro, rl = flash_fwd_plain(q, k, v, True)
        err = max(float((out - ro).abs().max()), float((lse - rl).abs().max()))
        if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
            fail(f"flash_fwd B={B} T={T} D={D} differs from run to run")
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        pairs = B * H_ * T * (T + 1) / 2
        nbytes, ops = 4 * B * T * H_ * D * 4 + B * H_ * T * 4, 4 * D * pairs

        def kernel(q=q, k=k, v=v):
            return flash_fwd(q, k, v, True)

        def library(qt=qt, kt=kt, vt=vt):
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

        f32_ms, f32_by = bound(nbytes, ops)
        tc_ms, tc_by = bound(nbytes, 3 * ops, TF32_OPS_PER_S)
        row = report(rows, "flash_fwd", {"B": B, "T": T, "H": H_, "D": D,
                                         "causal": True}, err, tol,
                     time_ms(kernel, iters=20),
                     time_ms(lambda: flash_fwd_plain(q, k, v, True), iters=20),
                     time_ms(library, iters=20), nbytes, ops,
                     {"card": CARD, "bound_ms": tc_ms, "bound_by": tc_by,
                      "bound_f32_ms": f32_ms, "bound_f32_by": f32_by})
        DEVICE_TIMED.append((row, kernel, library))
    # edge shapes: a ragged length, a key mask with a fully masked batch row,
    # Tq != Tk, every kernel width and padded head dims, bfloat16; each also
    # bitwise the same from run to run
    tol_bf16 = 2e-2
    cases = [(2, 100, 100, 64, False, True, torch.float32),
             (2, 100, 100, 64, True, True, torch.float32),
             (2, 130, 130, 64, True, False, torch.bfloat16)]
    cases += [(2, 100, 100, D, D not in (12, 16), D == 16, torch.float32)
              for D in FLASH_EDGE_DIMS]
    cases += [(2, 77, 200, 128, False, True, torch.float32),
              (2, 100, 100, 128, True, True, torch.float32),
              (2, 130, 130, 128, True, True, torch.bfloat16),
              (2, 100, 100, 12, True, True, torch.bfloat16),
              (2, 77, 200, 256, False, True, torch.float32),
              (2, 130, 130, 160, True, True, torch.bfloat16),
              (2, 100, 100, 256, False, True, torch.bfloat16),
              (2, 100, 100, 512, True, True, torch.bfloat16)]
    for B, Tq, Tk, D, causal, masked, dt in cases:
        H = 4 if D <= 128 else 2
        q = torch.randn(B, Tq, H, D, generator=g).to(dev).to(dt)
        k, v = (torch.randn(B, Tk, H, D, generator=g).to(dev).to(dt)
                for _ in range(2))
        km = None
        if masked:
            km = (torch.rand(B, Tk, generator=g) > 0.3).float()
            km[1] = 0.0  # every query row of batch 1 sees no key at all
            km = km.to(dev)
        out, lse = flash_fwd(q, k, v, causal, key_mask=km)
        again = flash_fwd(q, k, v, causal, key_mask=km)
        ro, rl = flash_fwd_plain(q, k, v, causal, key_mask=km)
        torch.cuda.synchronize()
        err = max(float((out.float() - ro.float()).abs().max()),
                  float((lse - rl).abs().max()))
        t = tol if dt == torch.float32 else tol_bf16
        shape = {"B": B, "Tq": Tq, "Tk": Tk, "H": H, "D": D,
                 "causal": causal, "masked": masked, "dtype": str(dt)}
        print(f"flash_fwd {shape}: max_abs_err={err:.3e} (tol {t:.0e})",
              flush=True)
        if not err <= t:
            fail(f"flash_fwd {shape} disagrees with its plain version: {err}")
        if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
            fail(f"flash_fwd {shape} differs from run to run")
        if masked and out[1].any():
            fail(f"flash_fwd {shape}: a fully masked batch row is not 0")


#: sm_xent's shapes on the main paths: the transformer's training step and
#: char_rnn's TBPTT chunk (both a warp a row)
XENT_TIMED = ((TRAIN_B * TRAIN_T, TRAIN_V), (RNN_B * RNN_CHUNK, RNN_V))


def check_xent(rows: list, dev) -> None:
    """Kernel 4 at the training paths' shapes ([4096, 256] float32 logits,
    and char_rnn's [1600, 64]), at a vocab of 50,257 (a block a row), at
    the widest and the narrowest row a warp takes besides, and with bfloat16
    logits; each bitwise the same from run to run. Its yardstick is
    ``F.cross_entropy`` with probability targets, forward and backward."""
    g = torch.Generator(device="cpu").manual_seed(SEED)
    # loss: float32 row sums of up to 50,257 terms in another order; grad:
    # one float32 rounding, or one bfloat16 ulp at magnitudes up to 1
    for N, C, dt, loss_tol, grad_tol in (
            (TRAIN_B * TRAIN_T, TRAIN_V, torch.float32, 1e-5, 1e-6),
            (RNN_B * RNN_CHUNK, RNN_V, torch.float32, 1e-5, 1e-6),
            (64, 50257, torch.float32, 1e-5, 1e-6),
            (64, 2048, torch.float32, 1e-5, 1e-6),
            (65, 2049, torch.float32, 1e-5, 1e-6),
            (1601, 33, torch.float32, 1e-5, 1e-6),
            (TRAIN_B * TRAIN_T, TRAIN_V, torch.bfloat16, 1e-5, 4e-3)):
        x = (torch.randn(N, C, generator=g) * 3).to(dev).to(dt)
        # labels in the logits' dtype, the instantiation mcxent launches
        y = F.one_hot(torch.randint(0, C, (N,), generator=g), C).to(dev).to(dt)
        loss, grad = softmax_cross_entropy(x, y)
        again = softmax_cross_entropy(x, y)
        rl, rg = softmax_cross_entropy_plain(x, y)
        torch.cuda.synchronize()
        if not (torch.equal(loss, again[0]) and torch.equal(grad, again[1])):
            fail(f"sm_xent N={N} C={C} {dt} differs from run to run")
        lerr = float((loss - rl).abs().max())
        gerr = float((grad.float() - rg.float()).abs().max())
        print(f"sm_xent N={N} C={C} {dt}: loss max_abs_err={lerr:.3e} (tol "
              f"{loss_tol:.0e}), grad max_abs_err={gerr:.3e} (tol "
              f"{grad_tol:.0e})", flush=True)
        if not (lerr <= loss_tol and gerr <= grad_tol):
            fail(f"sm_xent N={N} C={C} {dt} disagrees with its plain version")
        xl = x.float().clone().requires_grad_(True)
        yl = y.float()

        def kernel(x=x, y=y):
            return softmax_cross_entropy(x, y)

        def library(xl=xl, yl=yl):
            return torch.autograd.grad(
                F.cross_entropy(xl, yl, reduction="sum"), xl)

        elt = x.element_size()
        plan = sm_xent_plan(N, C, dt)
        row = report(rows, "sm_xent", {"N": N, "C": C, "dtype": str(dt)},
                     max(lerr, gerr), max(loss_tol, grad_tol),
                     time_ms(kernel),
                     time_ms(lambda: softmax_cross_entropy_plain(x, y)),
                     time_ms(library) if dt == torch.float32 else None,
                     3 * N * C * elt + N * 4, 6 * N * C,
                     {"card": CARD, "plan": plan._asdict()})
        if (N, C) in XENT_TIMED and dt == torch.float32:
            DEVICE_TIMED.append((row, kernel, library))


def check_flash_bwd(rows: list, dev) -> None:
    """Kernels 2 and 3 at the training path's shape (B 16, T 256, 4 heads
    of 64, causal, float32), at the wide phase's (B 4, T 128, 4 heads of
    128) and at edge shapes: not causal, a ragged T = 100, a key mask that
    fully masks one batch row, every kernel width and padded head dims, and
    bfloat16; each bitwise the same from run to run. Their yardstick is the
    backward of ``scaled_dot_product_attention``."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 1)
    # float32 sums in another order than the plain version's matmuls; one
    # bfloat16 ulp at magnitudes below 8
    tol, tol_bf16 = 2e-5, 3.2e-2
    wide2_d = WIDE_WIDTH // WIDE2_HEADS
    timed = {(TRAIN_B, TRAIN_T, 64), (WIDE_B, WIDE_T, 128),
             (WIDE_B, WIDE_T, wide2_d)}
    cases = [(TRAIN_B, TRAIN_T, 4, 64, True, False, torch.float32),
             (WIDE_B, WIDE_T, 4, 128, True, False, torch.float32),
             (WIDE_B, WIDE_T, WIDE2_HEADS, wide2_d, True, False,
              torch.float32),
             (2, 100, 4, 64, False, True, torch.float32),
             (2, 100, 4, 64, True, True, torch.float32),
             (2, 100, 4, 32, True, False, torch.float32),
             (2, 256, 4, 64, False, False, torch.float32),
             (2, 128, 4, 64, True, False, torch.bfloat16)]
    cases += [(2, 100, 4 if D <= 128 else 2, D, D not in (12, 16),
               D in (16, 512), torch.float32) for D in FLASH_EDGE_DIMS]
    cases += [(2, 100, 4, 128, True, True, torch.float32),
              (2, 100, 4, 128, False, False, torch.bfloat16),
              (2, 100, 4, 8, True, True, torch.bfloat16),
              (2, 100, 4, 40, False, False, torch.bfloat16),
              (2, 100, 2, 160, False, True, torch.bfloat16),
              (2, 128, 2, 256, True, False, torch.bfloat16),
              (2, 100, 2, 512, True, True, torch.bfloat16)]
    for B, T, H, D, causal, masked, dt in cases:
        q, k, v, do = (torch.randn(B, T, H, D, generator=g).to(dev).to(dt)
                       for _ in range(4))
        km = None
        if masked:
            km = (torch.rand(B, T, generator=g) > 0.3).float()
            km[1] = 0.0  # every query row of batch 1 sees no key at all
            km = km.to(dev)
        out, lse = flash_fwd(q, k, v, causal, key_mask=km)
        delta = bwd_delta(out, do)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, km)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, km)
        dq2 = flash_bwd_dq(q, k, v, do, lse, delta, causal, km)
        dk2, dv2 = flash_bwd_dkv(q, k, v, do, lse, delta, causal, km)
        rq = flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, km)
        rk, rv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, km)
        torch.cuda.synchronize()
        eq = float((dq.float() - rq.float()).abs().max())
        ekv = max(float((dk.float() - rk.float()).abs().max()),
                  float((dv.float() - rv.float()).abs().max()))
        t = tol if dt == torch.float32 else tol_bf16
        shape = {"B": B, "T": T, "H": H, "D": D, "causal": causal,
                 "masked": masked, "dtype": str(dt)}
        if not (torch.equal(dq, dq2) and torch.equal(dk, dk2)
                and torch.equal(dv, dv2)):
            fail(f"flash_bwd {shape} differs from run to run")
        if (B, T, D) not in timed:
            print(f"flash_bwd {shape}: dq max_abs_err={eq:.3e}, dk/dv "
                  f"max_abs_err={ekv:.3e} (tol {t:.1e})", flush=True)
            if not (eq <= t and ekv <= t):
                fail(f"flash_bwd {shape} disagrees with its plain version")
            continue
        qt, kt, vt = (a.transpose(1, 2).contiguous().requires_grad_(True)
                      for a in (q, k, v))
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        dot = do.transpose(1, 2).contiguous()

        def library(ot=ot, qt=qt, kt=kt, vt=vt, dot=dot):
            return torch.autograd.grad(ot, (qt, kt, vt), dot,
                                       retain_graph=True)

        lib_ms = time_ms(library, iters=20)
        pairs = B * H * (T * (T + 1) / 2 if causal else T * T)
        row = B * T * H * D * 4
        stats = B * H * T * 4
        # every product as three TF32 passes on the tensor cores: the bound
        # is that work at the TF32 peak; the float32 bound (the same products
        # on the CUDA cores) is kept beside it
        for name, nbytes, ops, kernel, plain in (
                ("flash_bwd_dq", 5 * row + 2 * stats, 6 * D * pairs,
                 lambda q=q, k=k, v=v, do=do, lse=lse, delta=delta, c=causal,
                 m=km: flash_bwd_dq(q, k, v, do, lse, delta, c, m),
                 lambda: flash_bwd_dq_plain(q, k, v, do, lse, delta, causal,
                                            km)),
                ("flash_bwd_dkv", 6 * row + 2 * stats, 8 * D * pairs,
                 lambda q=q, k=k, v=v, do=do, lse=lse, delta=delta, c=causal,
                 m=km: flash_bwd_dkv(q, k, v, do, lse, delta, c, m),
                 lambda: flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal,
                                             km))):
            f32_ms, f32_by = bound(nbytes, ops)
            tc_ms, tc_by = bound(nbytes, 3 * ops, TF32_OPS_PER_S)
            r = report(rows, name, shape,
                       eq if name == "flash_bwd_dq" else ekv, t,
                       time_ms(kernel, iters=20), time_ms(plain, iters=20),
                       lib_ms, nbytes, ops,
                       {"card": CARD, "bound_ms": tc_ms, "bound_by": tc_by,
                        "bound_f32_ms": f32_ms, "bound_f32_by": f32_by})
            DEVICE_TIMED.append((r, kernel, library))


def _lstm_args(dev, g, T, B, F, H, peephole, masked):
    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    m = torch.ones(T, B)
    if masked:
        m = (torch.rand(T, B, generator=g) > 0.3).float()
        m[:, 0] = 0.0  # a batch row masked at every step
    return dict(x_t=r(T, B, F), wcat=r(F + H, 4 * H, scale=0.1),
                b=r(1, 4 * H, scale=0.1),
                peep=r(3, H, scale=0.3) if peephole else None,
                h0=r(B, H, scale=0.5), c0=r(B, H, scale=0.5), m_t=m.to(dev))


def _cudnn_lstm(dev, T, B, F, H):
    """``torch.nn.LSTM`` (cuDNN) at the same shape: the yardstick. It
    computes the cell without peepholes."""
    mod = torch.nn.LSTM(F, H).to(dev)
    x = torch.randn(T, B, F, device=dev, requires_grad=True)
    h0 = torch.zeros(1, B, H, device=dev)

    def fwd():
        with torch.no_grad():
            return mod(x, (h0, h0))

    def fwd_bwd():
        y, _ = mod(x, (h0, h0))
        return torch.autograd.grad(y.sum(), [x] + list(mod.parameters()))

    return fwd, fwd_bwd


def lstm_work(T, B, F, H):
    """(bytes, operations) of lstm_fwd and of lstm_bwd: each input read once
    and each output written once (float32); the gate matmuls at 2 operations
    a multiply-add and ~20 (forward) or ~40 (backward) elementwise
    operations per cell and step."""
    K = F + H
    w = 4 * (K * 4 * H + 4 * H + 3 * H)
    fwd_b = 4 * (T * B * F + T * B + 4 * B * H + 2 * T * B * H) + w
    fwd_o = 2 * T * B * K * 4 * H + 20 * T * B * H
    bwd_b = 4 * (T * B * (F + 3 * H) + T * B + 4 * B * H + T * B * F) + 2 * w
    bwd_o = (2 * T * B * K * 4 * H * 2 + 2 * T * B * H * 4 * H
             + 2 * T * B * F * 4 * H + 40 * T * B * H)
    return fwd_b, fwd_o, bwd_b, bwd_o


def check_lstm(rows: list, dev) -> None:
    """Kernels 5 and 6 at the recurrent path's shapes: a TBPTT chunk of each
    char_rnn layer (T 50, B 32, F 64 and 200, H 200, peepholes; the second
    with a ragged mask that holds one batch row at every step), a decode step
    (T 1, B 8) and a streamed step (T 1, B 1); and at edge shapes: no
    peepholes, H = 37. The backward gets nonzero dh/dc seeds and is run twice
    to check it bitwise."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 2)
    # forward: float32 dot products over F + H terms in another order
    fwd_tol = 2e-5
    # backward: dW sums T * B = 1,600 rows in another order than the plain
    # version's matmul, so each output is held to 1e-4 of its own largest
    # entry, plus 1e-5
    bwd_atol, bwd_rtol = 1e-5, 1e-4
    cases = [(RNN_CHUNK, RNN_B, RNN_V, RNN_H, True, False),
             (RNN_CHUNK, RNN_B, RNN_H, RNN_H, True, True),
             (1, RNN_DECODE_B, RNN_V, RNN_H, True, False),
             (1, RNN_DECODE_B, RNN_H, RNN_H, True, False),
             (1, 1, RNN_V, RNN_H, True, False),
             (RNN_CHUNK, RNN_B, RNN_V, RNN_H, False, True),
             (7, 3, 5, 37, True, True)]
    for T, B, F, H, peephole, masked in cases:
        a = _lstm_args(dev, g, T, B, F, H, peephole, masked)
        out = lstm_ops.lstm_fwd(**a)
        fagain = lstm_ops.lstm_fwd(**a)
        ref = lstm_ops.lstm_fwd_plain(**a)
        torch.cuda.synchronize()
        ferr = max(float((o - r).abs().max()) for o, r in zip(out, ref))
        if not all(torch.equal(x, y) for x, y in zip(out, fagain)):
            fail(f"lstm_fwd {T, B, F, H} differs from run to run")
        if masked and not torch.equal(out[0][:, 0],
                                      a["h0"][0].expand(T, H)):
            fail(f"lstm_fwd {T, B, F, H}: a fully masked row moved")
        ys, cs = ref[0], ref[1]
        dys, dht, dct = (torch.randn(*s, generator=g).to(dev)
                         for s in ((T, B, H), (B, H), (B, H)))
        ba = dict(x_t=a["x_t"], hprev=torch.cat([a["h0"][None], ys[:-1]]),
                  cprev=torch.cat([a["c0"][None], cs[:-1]]), wcat=a["wcat"],
                  b=a["b"], peep=a["peep"], dys=dys, dht=dht, dct=dct,
                  m_t=a["m_t"])
        bout = lstm_ops.lstm_bwd(**ba)
        bref = lstm_ops.lstm_bwd_plain(**ba)
        again = lstm_ops.lstm_bwd(**ba)
        torch.cuda.synchronize()
        berrs = [float((o - r).abs().max()) for o, r in zip(bout, bref)]
        btols = [bwd_atol + bwd_rtol * float(r.abs().max()) for r in bref]
        shape = {"T": T, "B": B, "F": F, "H": H, "peephole": peephole,
                 "masked": masked}
        print(f"lstm {shape}: fwd max_abs_err={ferr:.3e} (tol {fwd_tol:.0e}); "
              "bwd max_abs_err (dx, dW, db, dpeep, dh0, dc0) = "
              f"{[f'{e:.2e}' for e in berrs]} against "
              f"{[f'{t:.2e}' for t in btols]}", flush=True)
        if not ferr <= fwd_tol:
            fail(f"lstm_fwd {shape} disagrees with its plain version: {ferr}")
        if not all(e <= t for e, t in zip(berrs, btols)):
            fail(f"lstm_bwd {shape} disagrees with its plain version")
        if not all(torch.equal(x, y) for x, y in zip(bout, again)):
            fail(f"lstm_bwd {shape} differs from run to run")
        if (F, H) == (5, 37) or not peephole:
            continue
        lib_f, lib_fb = _cudnn_lstm(dev, T, B, F, H)
        iters = 20 if T > 1 else 100
        fb, fo, bb, bo = lstm_work(T, B, F, H)
        shape["plan"] = lstm_ops.lstm_plan(T, B, F, H)
        shape["bwd_plan"] = lstm_ops.lstm_bwd_plan(T, B, F, H, peephole)
        def kernel(a=a):
            return lstm_ops.lstm_fwd(**a)

        row = report(rows, "lstm_fwd", shape, ferr, fwd_tol,
                     time_ms(kernel, iters=iters),
                     time_ms(lambda: lstm_ops.lstm_fwd_plain(**a), iters=5),
                     time_ms(lib_f, iters=iters), fb, fo, {"card": CARD})
        # every main-path shape: decode and stream steps (a few microseconds
        # of device) and the training chunks
        DEVICE_TIMED.append((row, kernel, lib_f))
        if T > 1:
            LSTM_SPLIT.append((row, lstm_ops.lstm_fwd, a, LSTM_FWD_PARTS,
                               "fwd_parts_ms"))
        worst = max(range(6), key=lambda i: berrs[i] / btols[i])

        def bkernel(ba=ba):
            return lstm_ops.lstm_bwd(**ba)

        row = report(rows, "lstm_bwd", shape, berrs[worst], btols[worst],
                     time_ms(bkernel, iters=iters),
                     time_ms(lambda: lstm_ops.lstm_bwd_plain(**ba), iters=5),
                     time_ms(lib_fb, iters=iters), bb, bo)
        if T > 1:  # the backward runs in training only
            DEVICE_TIMED.append((row, bkernel, lib_fb))
            LSTM_SPLIT.append((row, lstm_ops.lstm_bwd, ba, LSTM_BWD_PARTS,
                               "bwd_parts_ms"))


def post(port: int, path: str, body: dict):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def serve(kernels) -> dict:
    """The main path: generate and predict through the HTTP server."""
    V = 256
    conf = transformer_lm(V)
    net = MultiLayerNetwork(conf, device="cuda").init(seed=SEED)
    ref_net = MultiLayerNetwork(conf, device="cpu").init(seed=SEED)
    srv = InferenceServer(device="cuda", decode_kv="paged",
                          decode_page_size=16, decode_max_context=512,
                          decode_max_slots=16)
    srv.start()
    try:
        srv.register("lm", net, quant="int8")
        rng = np.random.default_rng(SEED)
        prompts = [rng.integers(0, V, size=int(rng.integers(16, 65))).tolist()
                   for _ in range(8)]
        results = [None] * len(prompts)

        def gen(j):
            results[j] = post(srv.port, "/v1/generate",
                              {"model": "lm", "prompt": prompts[j],
                               "max_new_tokens": 32})

        for fn in kernels:
            fn.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=gen, args=(j,))
                   for j in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        gen_s = time.perf_counter() - t0
        ids = rng.integers(0, V, size=(2, 512)).astype(np.float32)
        t0 = time.perf_counter()
        status, body = post(srv.port, "/v1/predict",
                            {"model": "lm", "inputs": ids.tolist()})
        predict_s = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in kernels}
        st = srv.status()
    finally:
        srv.stop()

    dec = st["decode"]["lm@v1"]
    print(f"serve: 8 x /v1/generate in {gen_s:.3f}s ({dec['steps']} decode "
          f"steps, {dec['tokens']} tokens, peak {dec['peak_active']} slots, "
          f"capacity {dec['capacity']}); /v1/predict [2,512] in "
          f"{predict_s:.3f}s; launches {launches}", flush=True)
    if status != 200:
        fail(f"/v1/predict returned {status}: {body[:500]}")
    pred = np.asarray(json.loads(body)["predictions"], np.float32)
    if pred.shape != (2, 512, V) or not np.isfinite(pred).all():
        fail(f"/v1/predict gave shape {pred.shape} or non-finite values")
    dense_err = float((PredictFn(net, device="cuda")(ids).cpu()
                       - PredictFn(ref_net, device="cpu")(ids)).abs().max())
    print(f"float32 forward [2,512], card vs CPU: max_abs_err={dense_err:.3e}",
          flush=True)
    ref_pf = PredictFn(ref_net, quant="int8", device="cpu")
    perr = float(np.abs(ref_pf(ids).numpy() - pred).max())
    print(f"/v1/predict vs CPU reference: max_abs_err={perr:.3e} (tol 1e-4)",
          flush=True)
    if not perr <= 1e-4:
        fail(f"/v1/predict disagrees with the CPU reference: {perr}")
    worst_gap = 0.0
    for prompt, (code, text) in zip(prompts, results):
        if code != 200:
            fail(f"/v1/generate returned {code}: {text[:500]}")
        lines = [json.loads(l) for l in text.splitlines() if l.strip()]
        done = lines[-1]
        toks = done.get("tokens")
        if not done.get("done") or len(toks) != 32 or len(lines) != 33:
            fail(f"/v1/generate gave {len(lines)} lines, last {done}")
        # the served greedy tokens must be argmax of the CPU full-sequence
        # forward over the same stream, to within float32 noise
        probs = ref_pf(np.asarray([prompt + toks], np.float32)).numpy()[0]
        for t, tok in enumerate(toks):
            p = probs[len(prompt) - 1 + t]
            worst_gap = max(worst_gap, float(p.max() - p[tok]))
    print(f"/v1/generate vs CPU full-sequence oracle: worst argmax gap "
          f"{worst_gap:.3e} (tol 1e-4)", flush=True)
    if not worst_gap <= 1e-4:
        fail(f"/v1/generate tokens are not the reference argmax: {worst_gap}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched by the served traffic")
    # exact: a decode step runs 4 int8 products in each of the 4 blocks plus
    # the head, and gathers K and V pages in each block; the predict runs
    # one attention forward a block
    want = {"int8_matmul": 17 * dec["steps"], "paged_gather": 8 * dec["steps"],
            "flash_fwd": 4}
    if launches != want:
        fail(f"serving launch counts {launches} != expected {want}")
    return {"launches": launches, "generate_s": gen_s, "predict_s": predict_s,
            "decode_steps": dec["steps"], "decode_tokens": dec["tokens"],
            "decode_capacity": dec["capacity"],
            "predict_max_abs_err": perr, "generate_worst_argmax_gap": worst_gap}


def train(kernels) -> dict:
    """The training path: ``MultiLayerNetwork.fit`` on the card against the
    same steps on the CPU, the launch counts of the 5 counted steps, then
    step timing and one profiled step."""
    conf = transformer_lm(TRAIN_V)
    ids = np.random.default_rng(SEED).integers(
        0, TRAIN_V, size=(TRAIN_B, TRAIN_T))
    x = np.eye(TRAIN_V, dtype=np.float32)[ids]
    net = MultiLayerNetwork(conf, device="cuda").init(seed=SEED)
    ref = MultiLayerNetwork(conf, device="cpu").init(seed=SEED)

    for fn in kernels:
        fn.launches = 0
    losses = []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        net.fit(x, x)
        losses.append(net.score_value)
    first_steps_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}

    ref_losses = []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        ref.fit(x, x)
        ref_losses.append(ref.score_value)
    cpu_s = time.perf_counter() - t0
    # float32 on both; sums in another order, amplified by Adam where a
    # gradient entry is near zero
    tol = 1e-4
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    print(f"train: card losses {losses}; CPU losses {ref_losses}; worst "
          f"relative difference {max(rel):.3e} (tol {tol:.0e}); "
          f"{TRAIN_STEPS} steps on the card in {first_steps_s:.3f}s (first "
          f"step included), on the CPU in {cpu_s:.3f}s; launches {launches}",
          flush=True)
    if not all(np.isfinite(losses)) or not max(rel) <= tol:
        fail(f"training losses on the card {losses} disagree with the CPU "
             f"run {ref_losses}")
    if not losses[-1] < losses[0]:
        fail(f"the training loss did not fall: {losses}")
    want = {"softmax_cross_entropy": TRAIN_STEPS,
            "flash_bwd_dq": 4 * TRAIN_STEPS, "flash_bwd_dkv": 4 * TRAIN_STEPS,
            "flash_fwd": 4 * TRAIN_STEPS, "int8_matmul": 0, "paged_gather": 0}
    if launches != want:
        fail(f"training launch counts {launches} != expected {want}")

    # step time: host clock around steps that end in a synchronize
    for _ in range(2):
        net.fit(x, x)
    torch.cuda.synchronize()
    n = 10
    t0 = time.perf_counter()
    for _ in range(n):
        net.fit(x, x)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / n
    tokens_per_s = TRAIN_B * TRAIN_T / (step_ms / 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(x, x)
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t0)
    by_kernel = device_time_by_kernel(prof)
    busy_us = sum(by_kernel.values())
    if busy_us <= 0:
        fail("the profiler saw no device time in the training step")
    result = {
        "losses": losses, "cpu_losses": ref_losses, "worst_rel_diff": max(rel),
        "launches": launches, "step_ms": step_ms, "tokens_per_s": tokens_per_s,
        "profiled_step_ms": prof_ms, "device_us_by_kernel": by_kernel,
        "device_us_total": busy_us,
        "idle_share_unprofiled": 1.0 - busy_us / 1e3 / step_ms,
        "idle_share_profiled": 1.0 - busy_us / 1e3 / prof_ms,
        "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    print(f"train step: {step_ms:.3f} ms wall, {tokens_per_s:.0f} tokens/s "
          f"(B={TRAIN_B}, T={TRAIN_T}); profiled step {prof_ms:.3f} ms, "
          f"device time {busy_us:.1f} us, idle share "
          f"{result['idle_share_unprofiled']:.3f} of the unprofiled step "
          f"({result['idle_share_profiled']:.3f} profiled)", flush=True)
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1]):
        print(f"  train step device time {name}: {us:.1f} us", flush=True)
    return result


def train_wide(kernels, n_heads: int = 4) -> dict:
    """Full-width ``transformer_lm(256, width=512, n_heads=n_heads)``: 4
    heads of 128 (the flash kernels' widest instantiation) or 2 heads of 256
    (``csrc/flash_wide.cu``): one ``output`` and ``WIDE_STEPS`` ``fit`` steps
    on the card against the same calls on the CPU from the same weights,
    with the exact launches of each."""
    conf = transformer_lm(TRAIN_V, width=WIDE_WIDTH, n_heads=n_heads)
    ids = np.random.default_rng(SEED + 4).integers(
        0, TRAIN_V, size=(WIDE_B, WIDE_T))
    x = np.eye(TRAIN_V, dtype=np.float32)[ids]
    net = MultiLayerNetwork(conf, device="cuda").init(seed=SEED)
    ref = MultiLayerNetwork(conf, device="cpu").init(seed=SEED)

    for fn in kernels:
        fn.launches = 0
    out = net.output(x)
    torch.cuda.synchronize()
    out_launches = {fn.__name__: fn.launches for fn in kernels}
    for fn in kernels:
        fn.launches = 0
    losses = []
    for _ in range(WIDE_STEPS):
        net.fit(x, x)
        losses.append(net.score_value)
    fit_launches = {fn.__name__: fn.launches for fn in kernels}

    ref_out = ref.output(x)
    ref_losses = []
    for _ in range(WIDE_STEPS):
        ref.fit(x, x)
        ref_losses.append(ref.score_value)
    # as the serving and training phases: the output within 1e-4 of the CPU
    # forward, each loss within 1e-4 relative of the CPU step
    out_err = float((out.cpu() - ref_out).abs().max())
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    print(f"wide transformer_lm(width={WIDE_WIDTH}, {n_heads} heads of "
          f"{WIDE_WIDTH // n_heads}) B={WIDE_B} "
          f"T={WIDE_T}: output max_abs_err {out_err:.3e} (tol 1e-4); card "
          f"losses {losses}, CPU {ref_losses}, worst relative difference "
          f"{max(rel):.3e} (tol 1e-4); launches output {out_launches}, fit "
          f"{fit_launches}", flush=True)
    if tuple(out.shape) != (WIDE_B, WIDE_T, TRAIN_V) \
            or not bool(torch.isfinite(out).all()) or not out_err <= 1e-4:
        fail(f"wide output {tuple(out.shape)} disagrees with the CPU: {out_err}")
    if not all(np.isfinite(losses)) or not max(rel) <= 1e-4:
        fail(f"wide losses on the card {losses} disagree with the CPU run "
             f"{ref_losses}")
    want_out = {fn.__name__: 0 for fn in kernels}
    want_fit = dict(want_out)
    want_out["flash_fwd"] = 4  # one attention forward a block
    want_fit.update(flash_fwd=4 * WIDE_STEPS, flash_bwd_dq=4 * WIDE_STEPS,
                    flash_bwd_dkv=4 * WIDE_STEPS,
                    softmax_cross_entropy=WIDE_STEPS)
    if out_launches != want_out or fit_launches != want_fit:
        fail(f"wide launch counts output {out_launches} != {want_out} or fit "
             f"{fit_launches} != {want_fit}")
    return {"output_launches": out_launches, "launches": fit_launches,
            "output_max_abs_err": out_err, "losses": losses,
            "cpu_losses": ref_losses, "worst_rel_diff": max(rel)}


class _LossLog:
    """A listener that keeps the loss of every update (one per TBPTT
    chunk); reading it synchronizes, so timed runs go without it."""

    def __init__(self, out: list):
        self.out = out

    def iteration_done(self, model, iteration):
        self.out.append(float(model.score_value))


def _one_hot(ids) -> np.ndarray:
    return np.eye(RNN_V, dtype=np.float32)[np.asarray(ids)]


def serve_lstm(kernels) -> dict:
    """The recurrent serving paths through the HTTP server: 8 concurrent
    /v1/generate sessions over the LSTM decode engine (dense, float32), then
    one /v1/stream session of 64 steps in two requests and its reset; every
    answer against the CPU ``rnn_time_step`` reference, and the launches of
    each path."""
    conf = char_rnn_lstm(RNN_V, hidden=RNN_H, layers=2, tbptt_length=RNN_CHUNK)
    net = MultiLayerNetwork(conf, device="cuda").init(seed=SEED)
    ref = MultiLayerNetwork(conf, device="cpu").init(seed=SEED)
    srv = InferenceServer(device="cuda", decode_max_slots=RNN_DECODE_B)
    srv.start()
    rng = np.random.default_rng(SEED + 3)
    prompts = [rng.integers(0, RNN_V, size=int(rng.integers(8, 33))).tolist()
               for _ in range(8)]
    stream_ids = rng.integers(0, RNN_V, size=(1, 64))
    try:
        srv.register("char", net)
        results = [None] * len(prompts)

        def gen(j):
            results[j] = post(srv.port, "/v1/generate",
                              {"model": "char", "prompt": prompts[j],
                               "max_new_tokens": 32})

        def generate_all():
            threads = [threading.Thread(target=gen, args=(j,))
                       for j in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()

        for fn in kernels:
            fn.launches = 0
        t0 = time.perf_counter()
        generate_all()
        gen_s = time.perf_counter() - t0
        decode_launches = {fn.__name__: fn.launches for fn in kernels}
        dec = srv.status()["decode"]["char@v1"]

        for fn in kernels:
            fn.launches = 0
        outs = []
        t0 = time.perf_counter()
        for part in (stream_ids[:, :32], stream_ids[:, 32:]):
            code, text = post(srv.port, "/v1/stream",
                              {"model": "char", "session": "s1",
                               "inputs": _one_hot(part).tolist()})
            if code != 200:
                fail(f"/v1/stream returned {code}: {text[:500]}")
            lines = [json.loads(l) for l in text.splitlines() if l.strip()]
            if not lines[-1].get("done") or len(lines) != 33:
                fail(f"/v1/stream gave {len(lines)} lines, last {lines[-1]}")
            outs += [np.asarray(l["output"], np.float32)[0]
                     for l in lines[:-1]]
        stream_s = time.perf_counter() - t0
        stream_launches = {fn.__name__: fn.launches for fn in kernels}
        streams_before = srv.status()["streams"]
        code, text = post(srv.port, "/v1/stream/reset",
                          {"model": "char", "session": "s1"})
        streams_after = srv.status()["streams"]

        # the same generate traffic again, profiled: device time by kernel
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            generate_all()
            prof_s = time.perf_counter() - t0
        dec2 = srv.status()["decode"]["char@v1"]
    finally:
        srv.stop()

    if code != 200 or json.loads(text) != {"reset": True} \
            or streams_before != {"char@v1": ["s1"]} \
            or streams_after != {"char@v1": []}:
        fail(f"/v1/stream/reset: {code} {text}; streams {streams_before} -> "
             f"{streams_after}")
    worst_gap, exact = 0.0, 0
    for prompt, (code, text) in zip(prompts, results):
        if code != 200:
            fail(f"/v1/generate (LSTM) returned {code}: {text[:500]}")
        lines = [json.loads(l) for l in text.splitlines() if l.strip()]
        toks = lines[-1].get("tokens")
        if not lines[-1].get("done") or len(toks) != 32 or len(lines) != 33:
            fail(f"/v1/generate (LSTM) gave {len(lines)} lines, last {lines[-1]}")
        # greedy tokens against the CPU rnn_time_step over the same stream
        ref.rnn_clear_previous_state()
        probs = ref.rnn_time_step(_one_hot([prompt + toks])).numpy()[0]
        for t, tok in enumerate(toks):
            p = probs[len(prompt) - 1 + t]
            worst_gap = max(worst_gap, float(p.max() - p[tok]))
            exact += int(p.argmax() == tok)
    ref.rnn_clear_previous_state()
    want_out = ref.rnn_time_step(_one_hot(stream_ids)).numpy()[0]
    stream_err = float(np.abs(np.stack(outs) - want_out).max())
    steps = dec["steps"]
    print(f"serve char_rnn: 8 x /v1/generate in {gen_s:.3f}s ({steps} decode "
          f"steps, {dec['tokens']} tokens, capacity {dec['capacity']}); "
          f"{exact}/{8 * 32} tokens equal to the CPU rnn_time_step argmax, "
          f"worst argmax probability gap {worst_gap:.3e} (tol 1e-4); "
          f"/v1/stream 64 steps in {stream_s:.3f}s, max_abs_err "
          f"{stream_err:.3e} (tol 1e-5); launches decode {decode_launches}, "
          f"stream {stream_launches}", flush=True)
    if not worst_gap <= 1e-4:
        fail(f"LSTM /v1/generate tokens are not the reference argmax: "
             f"{worst_gap}")
    if not stream_err <= 1e-5:
        fail(f"/v1/stream disagrees with the CPU rnn_time_step: {stream_err}")
    want_d = {fn.__name__: 0 for fn in kernels}
    want_s = dict(want_d, lstm_fwd=2 * 64)
    want_d["lstm_fwd"] = 2 * steps
    if decode_launches != want_d or stream_launches != want_s:
        fail(f"LSTM serving launch counts decode {decode_launches} != "
             f"{want_d} or stream {stream_launches} != {want_s}")
    by_kernel = device_time_by_kernel(prof)
    busy_us = sum(by_kernel.values())
    steps2 = dec2["steps"] - steps
    result = {
        "decode_launches": decode_launches, "stream_launches": stream_launches,
        "generate_s": gen_s, "decode_steps": steps,
        "decode_tokens": dec["tokens"], "decode_capacity": dec["capacity"],
        "decode_ms_per_step": 1e3 * gen_s / steps,
        "decode_tokens_per_s": dec["tokens"] / gen_s,
        "generate_exact_argmax": exact, "generate_worst_argmax_gap": worst_gap,
        "stream_s": stream_s, "stream_ms_per_step": 1e3 * stream_s / 64,
        "stream_max_abs_err": stream_err,
        "profiled_generate_s": prof_s, "profiled_decode_steps": steps2,
        "device_us_by_kernel": by_kernel, "device_us_total": busy_us,
        "device_us_per_step": busy_us / max(steps2, 1),
        "idle_share_profiled": 1.0 - busy_us / 1e6 / prof_s}
    print(f"decode char_rnn profiled: {steps2} steps in {prof_s:.3f}s, device "
          f"{busy_us:.1f} us ({result['device_us_per_step']:.1f} us a step), "
          f"idle share {result['idle_share_profiled']:.3f}; by kernel "
          f"{ {k: round(v, 1) for k, v in by_kernel.items()} }", flush=True)
    return result


def train_lstm(kernels) -> dict:
    """The recurrent training path: TBPTT ``fit`` of full-width char_rnn on
    the card against the same chunks on the CPU, the launch counts of the 8
    counted chunks, then chunk timing and one profiled batch."""
    conf = char_rnn_lstm(RNN_V, hidden=RNN_H, layers=2, tbptt_length=RNN_CHUNK,
                         learning_rate=RNN_LR)
    rng = np.random.default_rng(SEED)
    batches = [_one_hot(rng.integers(0, RNN_V, size=(RNN_B, RNN_T)))
               for _ in range(RNN_BATCHES)]
    net = MultiLayerNetwork(conf, device="cuda").init(seed=SEED)
    ref = MultiLayerNetwork(conf, device="cpu").init(seed=SEED)
    losses, ref_losses = [], []
    net.set_listeners(_LossLog(losses))
    ref.set_listeners(_LossLog(ref_losses))
    n_chunks = RNN_BATCHES * (RNN_T // RNN_CHUNK)

    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    for x in batches:
        net.fit(x, x)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    t0 = time.perf_counter()
    for x in batches:
        ref.fit(x, x)
    cpu_s = time.perf_counter() - t0
    # float32 on both; sums in another order, through 8 RMSProp updates
    tol = 1e-4
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    print(f"train char_rnn: card chunk losses {losses}; CPU {ref_losses}; "
          f"worst relative difference {max(rel):.3e} (tol {tol:.0e}); "
          f"{n_chunks} chunks on the card in {first_s:.3f}s (first included), "
          f"on the CPU in {cpu_s:.3f}s; launches {launches}", flush=True)
    if len(losses) != n_chunks or not all(np.isfinite(losses)) \
            or not max(rel) <= tol:
        fail(f"char_rnn chunk losses on the card {losses} disagree with the "
             f"CPU run {ref_losses}")
    want = {fn.__name__: 0 for fn in kernels}
    want.update(lstm_fwd=2 * n_chunks, lstm_bwd=2 * n_chunks,
                softmax_cross_entropy=n_chunks)
    if launches != want:
        fail(f"char_rnn launch counts {launches} != expected {want}")

    net.set_listeners()
    x = batches[0]
    net.fit(x, x)
    torch.cuda.synchronize()
    n = 3
    t0 = time.perf_counter()
    for _ in range(n):
        net.fit(x, x)
    torch.cuda.synchronize()
    chunk_ms = 1e3 * (time.perf_counter() - t0) / (n * RNN_T // RNN_CHUNK)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(x, x)
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t0)
    by_kernel = device_time_by_kernel(prof)
    busy_us = sum(by_kernel.values())
    if busy_us <= 0:
        fail("the profiler saw no device time in the char_rnn batch")
    per_batch = RNN_T // RNN_CHUNK
    # the device time a chunk, by kernel and for lstm_fwd's and lstm_bwd's
    # parts (both layers), read as device_ms does it (time a recorded event
    # x events a batch, median of three sessions): a single profiled session
    # may drop part of the events
    split = device_ms_by_kernel(lambda: net.fit(x, x), iters=2)
    fwd_parts_us, bwd_parts_us = (
        {k: 1e3 * v / per_batch for k, v in kernel_parts(split, parts).items()}
        for parts in (LSTM_FWD_PARTS, LSTM_BWD_PARTS))
    device_us_per_chunk = 1e3 * sum(split.values()) / per_batch
    result = {
        "losses": losses, "cpu_losses": ref_losses, "worst_rel_diff": max(rel),
        "launches": launches, "chunk_ms": chunk_ms,
        "tokens_per_s": RNN_B * RNN_CHUNK / (chunk_ms / 1e3),
        "profiled_batch_ms": prof_ms, "profiled_chunks": per_batch,
        "device_us_by_kernel": by_kernel, "device_us_total": busy_us,
        "idle_share_unprofiled": 1.0 - busy_us / 1e3 / (chunk_ms * per_batch),
        "idle_share_profiled": 1.0 - busy_us / 1e3 / prof_ms,
        "device_us_per_chunk": device_us_per_chunk,
        "idle_share_from_median_device":
            1.0 - device_us_per_chunk / 1e3 / chunk_ms,
        "lstm_fwd_us_per_chunk_by_part": fwd_parts_us,
        "lstm_bwd_us_per_chunk_by_part": bwd_parts_us}
    print(f"train char_rnn chunk: {chunk_ms:.3f} ms wall, "
          f"{result['tokens_per_s']:.0f} tokens/s (B={RNN_B}, T={RNN_CHUNK}); "
          f"profiled batch of {per_batch} chunks {prof_ms:.3f} ms, device time "
          f"{busy_us:.1f} us, idle share "
          f"{result['idle_share_unprofiled']:.3f} unprofiled "
          f"({result['idle_share_profiled']:.3f} profiled); device a chunk "
          f"{device_us_per_chunk:.1f} us (median of three sessions), idle "
          f"share {result['idle_share_from_median_device']:.3f} from it",
          flush=True)
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1]):
        print(f"  char_rnn batch device time {name}: {us:.1f} us", flush=True)
    for name, parts in (("lstm_fwd", fwd_parts_us), ("lstm_bwd", bwd_parts_us)):
        print(f"  {name} device time per chunk (2 layers) by part: "
              + ", ".join(f"{k} {v:.1f} us" for k, v in parts.items()),
              flush=True)
    return result


def main() -> None:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    # full float32 matmuls and convolutions, as the reference computes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    global CARD
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = CARD = smi.splitlines()[0]
    print(card, flush=True)

    t0 = time.perf_counter()
    _cuda.build()
    build_s = time.perf_counter() - t0
    print(f"built {_cuda.sources()} with nvcc for sm_90a in {build_s:.1f}s",
          flush=True)
    for name, log in sorted(_cuda.build_log.items()):
        for entry in ptxas_report(log):
            print(f"  {name}: {entry}", flush=True)

    dev = torch.device("cuda")
    rows: list = []
    check_int8(rows, dev)
    check_gather(rows, dev)
    check_flash(rows, dev)
    check_xent(rows, dev)
    check_flash_bwd(rows, dev)
    check_lstm(rows, dev)

    kernels = (int8_matmul, paged_gather, flash_fwd, softmax_cross_entropy,
               flash_bwd_dq, flash_bwd_dkv, lstm_ops.lstm_fwd,
               lstm_ops.lstm_bwd)
    served = serve(kernels[:3])
    trained = train(kernels[:6])
    wide = train_wide(kernels)
    wide2 = train_wide(kernels, n_heads=WIDE2_HEADS)
    served_rnn = serve_lstm(kernels)
    trained_rnn = train_lstm(kernels)
    measure_device_times()

    # one entry per kernel, at the shape its main path gave it: decode at
    # capacity 8 (M = 8, the widest matmul), predict at B = 2, training at
    # B = 16, T = 256; the flash kernels also carry the numbers of their
    # other paths (training, the wide phase at D = 128) under "by_path"
    train_shape = {"B": TRAIN_B, "T": TRAIN_T, "D": 64}
    wide_shape = {"B": WIDE_B, "T": WIDE_T, "D": 128}
    wide2_shape = {"B": WIDE_B, "T": WIDE_T, "D": WIDE_WIDTH // WIDE2_HEADS}
    rnn_xent = {"N": RNN_B * RNN_CHUNK, "C": RNN_V, "dtype": "torch.float32"}
    main_shape = {"int8_matmul": {"M": 8, "K": 256, "N": 1024},
                  "paged_gather": {"cap": 8},
                  "flash_fwd": {"B": 2, "T": 512, "D": 64},
                  "sm_xent": {"N": TRAIN_B * TRAIN_T, "C": TRAIN_V,
                              "dtype": "torch.float32"},
                  "flash_bwd_dq": train_shape, "flash_bwd_dkv": train_shape}
    rnn_train = {"T": RNN_CHUNK, "B": RNN_B, "F": RNN_V, "H": RNN_H,
                 "peephole": True, "masked": False}
    rnn_paths = {"decode": dict(rnn_train, T=1, B=RNN_DECODE_B),
                 "stream": dict(rnn_train, T=1, B=1), "train": rnn_train}
    main_shape["lstm_fwd"] = main_shape["lstm_bwd"] = rnn_train

    def row_at(name, want):
        return next(r for r in rows if r["name"] == name and all(
            r["shape"].get(k) == v for k, v in want.items()))

    numbers = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms", "shape")
    #: present on some rows only: profiler device times, the flash kernels'
    #: float32 bound, the card of the redesigned kernels' rows, int8_matmul's
    #: and sm_xent's plans, lstm_fwd's and lstm_bwd's parts
    optional = ("device_ms", "library_device_ms", "bound_f32_ms",
                "bound_f32_by", "card", "plan", "bwd_parts_ms", "fwd_parts_ms")

    def nums(row):
        return {**{k: row[k] for k in numbers},
                **{k: row[k] for k in optional if k in row}}

    meta = {
        "int8_matmul": ("deeplearning4j_tpu_torch/csrc/int8_matmul.cu",
                        "deeplearning4j_tpu/ops/quant.py:157"),
        "paged_gather": ("deeplearning4j_tpu_torch/csrc/paged_gather.cu",
                         "deeplearning4j_tpu/ops/paged_attention.py:79"),
        "flash_fwd": ("deeplearning4j_tpu_torch/csrc/flash_fwd.cu",
                      "deeplearning4j_tpu/ops/pallas_kernels.py:180"),
        "sm_xent": ("deeplearning4j_tpu_torch/csrc/sm_xent.cu",
                    "deeplearning4j_tpu/ops/pallas_kernels.py:678"),
        "flash_bwd_dq": ("deeplearning4j_tpu_torch/csrc/flash_bwd.cu",
                         "deeplearning4j_tpu/ops/pallas_kernels.py:519"),
        "flash_bwd_dkv": ("deeplearning4j_tpu_torch/csrc/flash_bwd.cu",
                          "deeplearning4j_tpu/ops/pallas_kernels.py:543"),
        "lstm_fwd": ("deeplearning4j_tpu_torch/csrc/lstm.cu",
                     "deeplearning4j_tpu/ops/lstm.py:486"),
        "lstm_bwd": ("deeplearning4j_tpu_torch/csrc/lstm.cu",
                     "deeplearning4j_tpu/ops/lstm.py:539"),
    }
    line = []
    for fn in kernels:
        fname = fn.__name__
        name = "sm_xent" if fname == "softmax_cross_entropy" else fname
        row = row_at(name, main_shape[name])
        if name.startswith("lstm"):
            # the recurrent path: TBPTT training is the main path of both;
            # the forward also runs in decode and streaming, at T = 1
            by_path = {"decode": served_rnn["decode_launches"][fname],
                       "stream": served_rnn["stream_launches"][fname],
                       "train": trained_rnn["launches"][fname]}
            entry = {"name": name, "route": "cuda", "source": meta[name][0],
                     "replaces": meta[name][1], "launches": by_path["train"],
                     "launches_by_path": by_path,
                     **nums(row)}
            if name == "lstm_fwd":
                entry["by_path"] = {
                    p: {"launches": by_path[p],
                        **nums(row_at(name, shp))}
                    for p, shp in rnn_paths.items()}
            line.append(entry)
            continue
        by_path = {"serve": served["launches"].get(fname, 0),
                   "train": trained["launches"][fname],
                   "wide": wide["output_launches"][fname]
                   + wide["launches"][fname],
                   "wide_d256": wide2["output_launches"][fname]
                   + wide2["launches"][fname],
                   "rnn": trained_rnn["launches"][fname]
                   + served_rnn["decode_launches"][fname]
                   + served_rnn["stream_launches"][fname]}
        entry = {"name": name, "route": "cuda", "source": meta[name][0],
                 "replaces": meta[name][1],
                 "launches": by_path["train" if name in
                                     ("sm_xent", "flash_bwd_dq",
                                      "flash_bwd_dkv") else "serve"],
                 "launches_by_path": by_path,
                 **nums(row)}
        if name == "flash_fwd":
            entry["by_path"] = {
                "serve": {"launches": by_path["serve"],
                          **nums(row)},
                "train": {"launches": by_path["train"],
                          **nums(row_at(name, train_shape))},
                "wide": {"launches": by_path["wide"],
                         **nums(row_at(name, wide_shape))},
                "wide_d256": {"launches": by_path["wide_d256"],
                              **nums(row_at(name, wide2_shape))}}
        elif name.startswith("flash_bwd"):
            entry["by_path"] = {
                "train": {"launches": by_path["train"], **nums(row)},
                "wide": {"launches": by_path["wide"],
                         **nums(row_at(name, wide_shape))},
                "wide_d256": {"launches": by_path["wide_d256"],
                              **nums(row_at(name, wide2_shape))}}
        elif name == "sm_xent":
            entry["by_path"] = {
                "train": {"launches": by_path["train"], **nums(row)},
                "rnn": {"launches": by_path["rnn"],
                        **nums(row_at(name, rnn_xent))}}
        line.append(entry)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "build_s": build_s, "rows": rows,
                   "serve": served, "train": trained, "train_wide": wide,
                   "train_wide_d256": wide2,
                   "serve_rnn": served_rnn,
                   "train_rnn": trained_rnn, "kernels": line,
                   "seconds": time.perf_counter() - t_start}, f, indent=1)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
