"""Where the time goes when the PyTorch port serves ``transformer_lm(256)``.

    python3 -m deeplearning4j_tpu_torch.keras_server.serve_profile

Needs one CUDA card and fails without one (a measurement is never taken on
the CPU in its place). Imports nothing of JAX. Two phases, each run once
unprofiled (for wall times) and once under ``torch.profiler`` (for device
time by kernel):

- decode: ``DecodeEngine`` (paged KV, int8 weights, full-width
  ``transformer_lm(256)``, random weights from a seed) serving 8 sessions
  with prompts of 16-64 ids and 32 new tokens each, the traffic of
  ``chip_smoke.py``; reports wall time per step, TTFT and inter-token gaps,
  tokens per second, device time per step by kernel and the device's idle
  share;
- predict: ``PredictFn`` (int8 at rest) on ``[2, 512]`` ids; reports wall
  and device time per forward and device time by kernel.

Prints one JSON object and writes it to
``chiprun_out/serve_profile.json``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from deeplearning4j_tpu_torch.keras_server.decode import DecodeEngine
from deeplearning4j_tpu_torch.models import transformer_lm
from deeplearning4j_tpu_torch.nn.inference import PredictFn
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import _cuda

SEED = 1234
V = 256
#: kernel-name substrings -> the port's kernels; everything else is PyTorch's
OURS = {"int8_matmul_kernel": "int8_matmul", "paged_gather_kernel": "paged_gather",
        "flash_fwd_kernel": "flash_fwd", "flash_bwd_dq_kernel": "flash_bwd_dq",
        "flash_bwd_dkv_kernel": "flash_bwd_dkv",
        # the flash kernels above head dim 128 (csrc/flash_wide.cu)
        "flash_wide_fwd_kernel": "flash_fwd", "flash_wide_dq_kernel": "flash_bwd_dq",
        "flash_wide_dkv_kernel": "flash_bwd_dkv",
        # a warp a row, or a block a row
        "sm_xent_warp_kernel": "sm_xent", "sm_xent_block_kernel": "sm_xent",
        "lstm_fwd_kernel": "lstm_fwd", "lstm_bwd_kernel": "lstm_bwd",
        # lstm_fwd's hoisted input product before its recurrence, and its
        # one-step route (T = 1: decode, stream)
        "lstm_fwd_x_kernel": "lstm_fwd", "lstm_step_kernel": "lstm_fwd",
        # lstm_bwd's hoisted gate product before its recurrence, and its
        # tail (dW, db, dx, dpeep, then the slices summed) after it
        "lstm_z_kernel": "lstm_bwd", "lstm_tail_kernel": "lstm_bwd",
        "lstm_sum_kernel": "lstm_bwd"}


def device_events(prof):
    """``(name, events, device µs)`` of each device event (kernels and
    copies) among a profile's averages. A ``record_function`` range (the
    port's are named ``dl4j::...``) also shows on the device, as a user
    annotation spanning its kernels: it is left out, or its span would count
    those kernels again, with the gaps between them."""
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or getattr(e, "is_user_annotation", False) \
                or e.key.startswith("dl4j::"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        yield e.key, e.count, float(us or 0.0)


def device_time_by_kernel(prof) -> dict:
    """Device microseconds per kernel family from a profiler run, summed
    over the device events (kernels and copies) alone (:func:`device_events`):
    the profiler also credits a kernel to the PyTorch op that launched it on
    the profiling thread, so a sum over every event counts those kernels
    twice."""
    out: dict = {}
    for key, _, us in device_events(prof):
        if not us:
            continue
        name = next((v for k, v in OURS.items() if k in key), None)
        if name is None:
            name = "memcpy/memset" if "Memcpy" in key or "Memset" in key \
                else "other PyTorch kernels"
        out[name] = out.get(name, 0.0) + us
    return out


def decode_phase(net, profiled: bool):
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, V, size=int(rng.integers(16, 65))).tolist()
               for _ in range(8)]
    eng = DecodeEngine(net, device="cuda", kv="paged", page_size=16,
                       max_context=512, max_slots=16, quant="int8")
    try:
        # one warm session so the first measured step pays no lazy set-up
        eng.submit([1, 2, 3], 2).result(timeout=300)
        steps0 = eng.stats()["steps"]
        prof = None
        if profiled:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sessions = [eng.submit(p, 32) for p in prompts]
        for s in sessions:
            s.result(timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
        steps = eng.stats()["steps"] - steps0
    finally:
        eng.close()
    ttft = [s.t_first - s.t_sched for s in sessions]
    gaps = np.concatenate([np.diff(s.token_times) for s in sessions])
    return {"wall_s": wall, "steps": steps, "wall_ms_per_step": 1e3 * wall / steps,
            "tokens": 32 * len(sessions), "tokens_per_s": 32 * len(sessions) / wall,
            "ttft_ms_p50": 1e3 * float(np.median(ttft)),
            "ttft_ms_max": 1e3 * float(np.max(ttft)),
            "gap_ms_p50": 1e3 * float(np.median(gaps)),
            "gap_ms_p90": 1e3 * float(np.percentile(gaps, 90))}, prof


def predict_phase(net, profiled: bool, reps: int = 10):
    pf = PredictFn(net, quant="int8", device="cuda")
    ids = np.random.default_rng(SEED).integers(0, V, size=(2, 512)).astype(np.float32)
    pf(ids)
    torch.cuda.synchronize()
    prof = None
    if profiled:
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
    t0 = time.perf_counter()
    for _ in range(reps):
        pf(ids)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    return {"reps": reps, "wall_ms_per_forward": 1e3 * wall / reps}, prof


def main() -> None:
    if not torch.cuda.is_available():
        print("serve_profile: no CUDA device", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _cuda.build()
    net = MultiLayerNetwork(transformer_lm(V), device="cuda").init(seed=SEED)
    result = {"card": card}
    for name, phase in (("decode", decode_phase), ("predict", predict_phase)):
        plain, _ = phase(net, profiled=False)
        prof_res, prof = phase(net, profiled=True)
        by_kernel = device_time_by_kernel(prof)
        total_us = sum(by_kernel.values())
        if total_us == 0:
            print("serve_profile: the profiler saw no device time",
                  file=sys.stderr)
            sys.exit(1)
        per = prof_res["steps"] if name == "decode" else prof_res["reps"]
        wall_us = 1e6 * (prof_res["wall_s"] if name == "decode"
                         else prof_res["wall_ms_per_forward"] * per / 1e3)
        plain_us = 1e3 * (plain["wall_ms_per_step"] if name == "decode"
                          else plain["wall_ms_per_forward"])
        result[name] = {
            "unprofiled": plain, "profiled": prof_res,
            "device_us_per_call": {k: v / per for k, v in sorted(by_kernel.items())},
            "device_us_per_call_total": total_us / per,
            # the profiler slows the host, so the profiled share overstates
            # idleness; the unprofiled wall time gives the other estimate
            "device_idle_share_profiled": 1.0 - total_us / wall_us,
            "device_idle_share_unprofiled_wall": 1.0 - total_us / per / plain_us,
        }
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "serve_profile.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
