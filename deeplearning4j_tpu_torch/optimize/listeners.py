"""Training listeners: called on the host between train steps.

Counterpart of ``deeplearning4j_tpu/optimize/listeners.py``. A network calls
``iteration_done(model, iteration)`` after each update with the new
iteration count, and a ``fit_iterator`` epoch calls ``on_epoch_start`` and
``on_epoch_end``. ``model.score_value`` is the last step's loss as a device
scalar read lazily: a listener reads it only when it fires, so a listener
that fires every N iterations costs one host sync every N steps, not one a
step.

``ProfilerListener`` traces a window of iterations with ``torch.profiler``
(the JAX package uses ``jax.profiler``). ``CheckpointListener`` writes
model zips or sharded checkpoints (``utils/sharded_checkpoint.py``).

A listener that reads the network's whole params or updater state when it
fires says so in ``reads_whole`` (``"params"``, ``"updater"``; a listener
that reads them only at some iterations says which in
``reads_whole_at(iteration)``). JAX's arrays are global, so its listeners
read a sharded fit's state whole. A sharded fit of the port holds blocks
between steps (ZeRO, ``dp_tp``, the pipeline's stages; the network names
the placement in ``_held_sharding``), so :func:`fire_iteration_done` runs
the listeners of an iteration inside the placement's whole view when one
of them reads what it holds: every rank takes part in assembling it, the
listeners see the whole state, and the blocks are given back after. In a
process group only rank 0 writes the files (a zip checkpoint, the param
log's rows); the other ranks take part in the gather.
"""
from __future__ import annotations

import contextlib
import glob
import json
import logging
import math
import os
import shutil
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..common import host_numpy

log = logging.getLogger(__name__)


class IterationListener:
    """The listener interface; every hook does nothing by default."""

    #: what the listener reads whole when it fires: "params", "updater"
    reads_whole: tuple = ()

    def iteration_done(self, model, iteration: int) -> None:
        pass

    def on_epoch_start(self, model) -> None:
        pass

    def on_epoch_end(self, model) -> None:
        pass


TrainingListener = IterationListener  # the epoch hooks are included above


def _writes_files() -> bool:
    """Whether this process writes a listener's files: rank 0 of a process
    group, or a process without one."""
    return not (dist.is_available() and dist.is_initialized()
                and dist.get_rank() != 0)


def fire_iteration_done(model, iteration: int) -> None:
    """Every listener's ``iteration_done``. When the network holds blocks
    between steps (``model._held_sharding``) and a listener reads what it
    holds at this iteration, they all fire inside the placement's whole
    view (every rank of the fit calls this, and takes part)."""
    held = getattr(model, "_held_sharding", None)
    parts = set()
    if held is not None:
        for l in model.listeners:
            at = getattr(l, "reads_whole_at", None)
            parts |= set(at(iteration) if at is not None
                         else getattr(l, "reads_whole", ()))
    with (held.whole_view(parts) if parts else contextlib.nullcontext()):
        for listener in model.listeners:
            listener.iteration_done(model, iteration)


class ScoreIterationListener(IterationListener):
    """Log the score every ``print_iterations`` iterations, once through the
    logger (``echo=True`` also prints it)."""

    def __init__(self, print_iterations: int = 10, echo: bool = False):
        self.print_iterations = max(1, print_iterations)
        self.echo = echo

    def iteration_done(self, model, iteration: int) -> None:
        if iteration % self.print_iterations == 0:
            score = model.score_value
            log.info("Score at iteration %d is %s", iteration, score)
            if self.echo:
                print(f"Score at iteration {iteration} is {score}")


class PerformanceListener(IterationListener):
    """Batches and samples a second between reports, every ``frequency``
    iterations; ``batch_size=0`` reads the model's ``last_batch_size``."""

    def __init__(self, frequency: int = 1, report: bool = True,
                 batch_size: int = 0):
        self.frequency = max(1, frequency)
        self.report = report
        self.last_time: Optional[float] = None
        self.last_iter = 0
        self.samples_per_sec = 0.0
        self.batches_per_sec = 0.0
        self.batch_size = batch_size

    def iteration_done(self, model, iteration: int) -> None:
        now = time.perf_counter()
        if self.last_time is not None and iteration % self.frequency == 0:
            dt = now - self.last_time
            iters = iteration - self.last_iter
            if dt > 0 and iters > 0:
                bs = self.batch_size or getattr(model, "last_batch_size", 0)
                self.batches_per_sec = iters / dt
                self.samples_per_sec = self.batches_per_sec * bs
                if self.report:
                    log.info("iteration %d: %.1f batches/sec, "
                             "%.1f samples/sec", iteration,
                             self.batches_per_sec, self.samples_per_sec)
        if iteration % self.frequency == 0:
            self.last_time = now
            self.last_iter = iteration


class CollectScoresIterationListener(IterationListener):
    """``(iteration, score)`` every ``frequency`` iterations."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self.scores: list = []

    def iteration_done(self, model, iteration: int) -> None:
        if iteration % self.frequency == 0:
            self.scores.append((iteration, model.score_value))


class TimeIterationListener(IterationListener):
    """Log the estimated time left every ``frequency`` iterations."""

    def __init__(self, total_iterations: int, frequency: int = 50):
        self.total_iterations = total_iterations
        self.frequency = max(1, frequency)
        self.start = time.perf_counter()

    def iteration_done(self, model, iteration: int) -> None:
        elapsed = time.perf_counter() - self.start
        if iteration > 0 and iteration % self.frequency == 0:
            remaining = elapsed / iteration * (self.total_iterations - iteration)
            log.info("iteration %d/%d, ETA %.0fs", iteration,
                     self.total_iterations, remaining)


class ParamAndGradientIterationListener(IterationListener):
    """Mean magnitudes of every parameter and of its last update, every
    ``iterations`` iterations, as rows (``param_<path>``,
    ``update_<path>``), optionally appended to ``output_file`` as JSON
    lines. It copies the params to the host at every iteration, so that
    each update spans one step. In a process group rank 0 keeps the rows
    and writes the file; the other ranks record nothing."""

    reads_whole = ("params",)

    def __init__(self, iterations: int = 1, output_file: Optional[str] = None,
                 print_mean_magnitudes: bool = True):
        self.iterations = max(1, iterations)
        self.output_file = output_file
        self.print_mean_magnitudes = print_mean_magnitudes
        self._last: Optional[dict] = None
        self.rows: list = []

    @staticmethod
    def _flatten(params, prefix: str = "") -> dict:
        out = {}
        items = (params.items() if isinstance(params, dict)
                 else enumerate(params))
        for k, v in items:
            name = f"{prefix}{k}"
            if isinstance(v, (dict, list, tuple)):
                out.update(ParamAndGradientIterationListener._flatten(
                    v, name + "_"))
            elif isinstance(v, torch.Tensor):
                out[name] = host_numpy(v)
        return out

    def iteration_done(self, model, iteration: int) -> None:
        if not _writes_files():
            return
        flat = self._flatten(getattr(model, "params_list", {}) or {})
        log_now = iteration % self.iterations == 0
        if log_now:
            row = {"iteration": iteration, "score": float(model.score_value)}
            for name, arr in flat.items():
                row[f"param_{name}"] = float(np.mean(np.abs(arr)))
                if self._last is not None and name in self._last \
                        and self._last[name].shape == arr.shape:
                    row[f"update_{name}"] = float(np.mean(np.abs(
                        arr - self._last[name])))
        self._last = {k: v.copy() for k, v in flat.items()}
        if not log_now:
            return
        self.rows.append(row)
        if self.print_mean_magnitudes:
            log.info("iter %d param/update mean magnitudes: %s",
                     iteration, {k: round(v, 6) for k, v in row.items()
                                 if k.startswith(("param_", "update_"))})
        if self.output_file:
            with open(self.output_file, "a") as f:
                f.write(json.dumps(row) + "\n")


class ProfilerListener(IterationListener):
    """A ``torch.profiler`` trace of ``num_iterations`` iterations from the
    one where ``start_iteration`` is reached, written to ``log_dir`` as a
    Chrome trace (``trace.json``). One window by default; with
    ``repeat_every`` each window (in ``log_dir/iter_<n>``) moves
    ``start_iteration`` on by that many iterations when it closes, and the
    next opens at the first iteration at or past it. A window whose
    profiler cannot start (another profiler session is active in the
    process) is skipped and retried at a later iteration. ``windows`` holds
    the traces' directories and ``summaries`` their summaries (trace file,
    iterations, profiled events, device milliseconds)."""

    def __init__(self, log_dir: str, start_iteration: int = 10,
                 num_iterations: int = 5,
                 repeat_every: Optional[int] = None):
        self.log_dir = log_dir
        self.start_iteration = start_iteration
        self.num_iterations = max(1, num_iterations)
        self.repeat_every = repeat_every
        self.windows: list = []
        self.summaries: list = []
        self._active_since: Optional[int] = None
        self._prof = None
        self._dir = None

    def _start(self, iteration: int) -> None:
        sub = (os.path.join(self.log_dir, f"iter_{iteration}")
               if self.repeat_every else self.log_dir)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        try:
            prof.start()
        except RuntimeError as e:
            log.warning("profiler window at iteration %d skipped: %s",
                        iteration, e)
            return
        self._prof, self._dir = prof, sub
        self._active_since = iteration

    def _stop(self, iteration: Optional[int]) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        prof.stop()
        os.makedirs(self._dir, exist_ok=True)
        trace = os.path.join(self._dir, "trace.json")
        prof.export_chrome_trace(trace)
        averages = prof.key_averages()
        device_us = sum(getattr(e, "self_device_time_total", 0.0)
                        for e in averages)
        self.summaries.append({
            "trace": trace,
            "iterations": (None if iteration is None
                           else iteration - self._active_since),
            "events": sum(e.count for e in averages),
            "device_ms": device_us / 1e3})
        self.windows.append(self._dir)
        self._active_since = None
        if self.repeat_every:
            self.start_iteration += self.repeat_every

    def iteration_done(self, model, iteration: int) -> None:
        if self._active_since is None:
            if iteration >= self.start_iteration and \
                    (not self.windows or self.repeat_every):
                self._start(iteration)
        elif iteration - self._active_since >= self.num_iterations:
            # the score is read inside the window, so the trace holds the
            # device work of its last step
            _ = model.score_value
            self._stop(iteration)

    def on_epoch_end(self, model) -> None:
        if self._active_since is not None:
            self._stop(None)


class CheckpointListener(IterationListener):
    """Model zips (with the updater state, so training resumes as it would
    have gone on) every ``every_n_iterations`` iterations and every
    ``every_n_epochs`` epochs, as ``checkpoint_iter_<n>.zip`` and
    ``checkpoint_epoch_<n>.zip`` beside a copy of the newest as
    ``latest.zip``; the ``keep_last`` newest stay, counted across restarts
    from the files in ``directory``. Each file is written to a temporary
    name and renamed, so a crash leaves no truncated zip.

    In a process group rank 0 writes the zips (of the whole state, which
    a sharded fit assembles for it: :func:`fire_iteration_done`); the other
    ranks write nothing. ``sharded=True`` writes sharded checkpoint
    directories (``utils/sharded_checkpoint.py``: each rank of a
    distributed fit writes its own blocks, no gather) as
    ``checkpoint_<tag>``, with a ``LATEST`` file naming the newest."""

    def __init__(self, directory: str, every_n_iterations: Optional[int] = None,
                 every_n_epochs: Optional[int] = 1, keep_last: int = 3,
                 sharded: bool = False):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.every_n_iterations = every_n_iterations
        self.every_n_epochs = every_n_epochs
        self.keep_last = keep_last
        self.sharded = sharded
        #: a zip holds every leaf whole; a sharded save takes the blocks
        self.reads_whole = () if sharded else ("params", "updater")
        pattern = "checkpoint_*" if sharded else "checkpoint_*.zip"
        self._written: list = sorted(
            (p for p in glob.glob(os.path.join(directory, pattern))
             if sharded == os.path.isdir(p)), key=os.path.getmtime)

    def _rotate(self, path: str, remove) -> None:
        if path in self._written:
            self._written.remove(path)
        self._written.append(path)
        while len(self._written) > self.keep_last:
            old = self._written.pop(0)
            try:
                remove(old)
            except OSError:
                log.debug("could not remove rotated checkpoint %s", old,
                          exc_info=True)

    def _save_sharded(self, model, tag: str) -> str:
        from ..utils.sharded_checkpoint import _rank, save_sharded

        path = os.path.join(self.directory, f"checkpoint_{tag}")
        save_sharded(path, model)
        lead = _rank() == 0  # one rank writes the pointer and rotates
        if lead:
            tmp = os.path.join(self.directory, "LATEST.tmp")
            with open(tmp, "w") as f:
                f.write(os.path.basename(path))
            os.replace(tmp, os.path.join(self.directory, "LATEST"))
        self._rotate(path, shutil.rmtree if lead else (lambda p: None))
        return path

    def reads_whole_at(self, iteration: int) -> tuple:
        """What the listener reads whole at ``iteration``: the params and
        updater state when a zip is due."""
        due = (self.every_n_iterations
               and iteration % self.every_n_iterations == 0)
        return self.reads_whole if due else ()

    def _save(self, model, tag: str) -> Optional[str]:
        if self.sharded:
            return self._save_sharded(model, tag)
        path = os.path.join(self.directory, f"checkpoint_{tag}.zip")
        if not _writes_files():
            return None
        from ..utils.model_serializer import write_model

        tmp = path + ".tmp"
        write_model(model, tmp)
        os.replace(tmp, path)
        latest_tmp = os.path.join(self.directory, "latest.zip.tmp")
        shutil.copyfile(path, latest_tmp)
        os.replace(latest_tmp, os.path.join(self.directory, "latest.zip"))
        self._rotate(path, os.remove)
        return path

    def iteration_done(self, model, iteration: int) -> None:
        if self.every_n_iterations and iteration % self.every_n_iterations == 0:
            self._save(model, f"iter_{iteration}")

    def on_epoch_end(self, model) -> None:
        epoch = getattr(model, "epoch", 0)
        if self.every_n_epochs and epoch % self.every_n_epochs == 0:
            self._save(model, f"epoch_{epoch}")

    @staticmethod
    def last_checkpoint(directory: str) -> Optional[str]:
        """``latest.zip`` in ``directory``; else the directory a sharded
        run's ``LATEST`` pointer names (as the JAX package picks it); else
        None."""
        p = os.path.join(directory, "latest.zip")
        if os.path.exists(p):
            return p
        ptr = os.path.join(directory, "LATEST")
        if os.path.exists(ptr):
            with open(ptr) as f:
                cand = os.path.join(directory, f.read().strip())
            if os.path.isdir(cand):
                return cand
        return None


class NanScoreWatcher(IterationListener):
    """Raise ``FloatingPointError`` (or call ``on_invalid(model, iteration,
    score)``) the first step whose score is NaN or infinite. It reads the
    score every step."""

    def __init__(self, on_invalid=None):
        self.on_invalid = on_invalid
        self.triggered = False

    def iteration_done(self, model, iteration: int) -> None:
        s = float(model.score_value)
        if math.isnan(s) or math.isinf(s):
            self.triggered = True
            if self.on_invalid is not None:
                self.on_invalid(model, iteration, s)
            else:
                raise FloatingPointError(
                    f"invalid score {s} at iteration {iteration}")
