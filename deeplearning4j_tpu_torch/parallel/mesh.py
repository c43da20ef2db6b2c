"""The process group and the named mesh of ranks over it.

Counterpart of ``deeplearning4j_tpu/parallel/mesh.py``. The JAX package is
single-controller: one process sees every device, and a ``jax.sharding.Mesh``
names their axes. The port is SPMD over ``torch.distributed``: one process
a rank, every rank running the same program. :func:`init_distributed` joins
the process group (NCCL on the card; gloo only when the caller asks for the
CPU), and :class:`Mesh` lays the group's ranks out on named axes, row-major
as ``np.reshape`` lays devices out, with one process group for each set of
axes (the ranks that differ only along those axes). Axis conventions are the
JAX package's: ``data`` splits the batch, ``sp`` (or any name given to
``sequence_parallel``) the time axis, ``model`` the weights (tensor
parallelism, ``tensor_parallel.py``), ``stage`` the pipeline's stages.

With no process group initialized a mesh of size 1 is a group of one: it has
no process groups and every collective on it is skipped. A mesh of one over
an initialized group (``world_size=1``) has real groups, so its collectives
run (on the card: NCCL kernels).

``build_mesh(axes, devices=[...])`` gives a :class:`DeviceMesh` instead: the
same named axes over a list of devices that one process drives, with no
process group. That is the JAX package's single controller, and what a
sharded serving pin (``nn/inference.py``) and a sharded replica
(``keras_server/replica.py``) are placed on. A device may appear more than
once (``["cuda:0"] * 4`` on a one-card machine, ``["cpu"] * 8`` in the
tests): a slot is told apart by its position in the list, not by its
device. JAX refuses repeated devices (ROADMAP.md §C).
"""
from __future__ import annotations

import itertools
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..common import resolve_device


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     device=None, backend: Optional[str] = None,
                     timeout=None) -> torch.device:
    """Join the process group; returns this rank's device.

    ``coordinator_address`` is ``host:port`` (``tcp://`` is added) or an
    init method (``tcp://...``, ``file://...``); without it the usual
    ``MASTER_ADDR``/``MASTER_PORT`` variables are read. ``num_processes``
    and ``process_id`` default to ``WORLD_SIZE`` and ``RANK``. ``device``
    ``None`` means CUDA (``cuda:LOCAL_RANK``, else the rank modulo the
    card count), which raises without a card; ``"cpu"`` runs on the CPU.
    The backend is NCCL on CUDA and gloo on the CPU unless ``backend``
    names one (gloo on CUDA tensors carries some collectives only).
    ``timeout`` (a ``timedelta``) bounds each collective's wait. A group
    already initialized is kept."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return _rank_device(dev, dist.get_rank())
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None
               else os.environ.get("RANK", 0))
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dev = _rank_device(dev, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    if timeout is not None:
        kw["timeout"] = timeout
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, **kw)
    return dev


def _rank_device(dev: torch.device, rank: int) -> torch.device:
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = os.environ.get("LOCAL_RANK")
    idx = int(local) if local is not None else rank % torch.cuda.device_count()
    return torch.device("cuda", idx)


def world() -> Tuple[int, int]:
    """``(rank, world size)`` of the process group, ``(0, 1)`` without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """Named axes over the ranks of the process group.

    ``shape`` maps each axis to its size (insertion order is the layout
    order, as in ``jax.sharding.Mesh``); ``coords`` is this rank's index
    along each; :meth:`group` gives the process group of a set of axes.
    The mesh must cover the group exactly: a rank outside it would have no
    part in the step."""

    def __init__(self, axes: Dict[str, int]):
        if not axes:
            raise ValueError("a mesh needs at least one axis")
        self.shape: Dict[str, int] = {str(k): int(v) for k, v in axes.items()}
        if any(v < 1 for v in self.shape.values()):
            raise ValueError(f"mesh axis sizes must be >= 1: {self.shape}")
        self.axis_names: Tuple[str, ...] = tuple(self.shape)
        self.size = int(np.prod(list(self.shape.values())))
        self.rank, world_size = world()
        if self.size != world_size:
            raise ValueError(
                f"Mesh needs {self.size} ranks, have {world_size}: the "
                "process group must hold exactly the mesh's ranks "
                "(init_distributed(num_processes=...))")
        #: global ranks laid out on the axes, row-major
        self.ranks = np.arange(self.size).reshape(
            [self.shape[a] for a in self.axis_names])
        where = np.argwhere(self.ranks == self.rank)[0]
        self.coords: Dict[str, int] = {
            a: int(i) for a, i in zip(self.axis_names, where)}
        self.distributed = dist.is_available() and dist.is_initialized()
        self._groups: Dict[frozenset, object] = {}
        if self.distributed:
            self._make_groups()

    def _make_groups(self) -> None:
        # every rank creates every group in one order, as new_group needs
        n = len(self.axis_names)
        for r in range(1, n + 1):
            for axes in itertools.combinations(range(n), r):
                moved = np.moveaxis(self.ranks, list(axes),
                                    list(range(n - len(axes), n)))
                flat = moved.reshape(-1, int(np.prod(
                    [self.ranks.shape[i] for i in axes])))
                key = frozenset(self.axis_names[i] for i in axes)
                for members in flat:
                    members = [int(m) for m in members]
                    g = dist.new_group(members)
                    if self.rank in members:
                        self._groups[key] = g

    def group(self, *axes: str):
        """The process group of this rank's ranks along ``axes`` (all of
        them by default); None on a mesh without a process group."""
        names = frozenset(axes or self.axis_names)
        unknown = names - set(self.axis_names)
        if unknown:
            raise ValueError(f"axes {sorted(unknown)} not in mesh axes "
                             f"{self.axis_names}")
        return self._groups.get(names)

    def axis_size(self, *axes: str) -> int:
        return int(np.prod([self.shape[a] for a in axes])) if axes else 1

    def index(self, *axes: str) -> int:
        """This rank's position in the group of ``axes`` (row-major)."""
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    def global_rank(self, axis: str, index: int) -> int:
        """The global rank at ``index`` along ``axis``, this rank's
        coordinates on the other axes."""
        at = [self.coords[a] if a != axis else index for a in self.axis_names]
        return int(self.ranks[tuple(at)])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


class DeviceMesh:
    """Named axes over a list of devices driven by one process.

    The axis API of :class:`Mesh` (``shape``, ``axis_names``, ``size``,
    :meth:`axis_size`), with ``devices``, the ``torch.device`` of each slot
    laid out row-major on the axes, and ``slots``, the slots' positions in
    the device list laid out alike. It has no process group: what moves
    between slots is a copy from one device to another. Every device must
    exist: a CUDA index beyond the card count raises, as does any CUDA
    device without a card."""

    def __init__(self, axes: Dict[str, int], devices: Sequence):
        if not axes:
            raise ValueError("a mesh needs at least one axis")
        self.shape: Dict[str, int] = {str(k): int(v) for k, v in axes.items()}
        if any(v < 1 for v in self.shape.values()):
            raise ValueError(f"mesh axis sizes must be >= 1: {self.shape}")
        self.axis_names: Tuple[str, ...] = tuple(self.shape)
        self.size = int(np.prod(list(self.shape.values())))
        devices = list(devices)
        if self.size > len(devices):
            raise ValueError(f"Mesh needs {self.size} devices, have "
                             f"{len(devices)}")
        sizes = [self.shape[a] for a in self.axis_names]
        devs = np.empty(self.size, dtype=object)
        for i, d in enumerate(devices[:self.size]):
            devs[i] = _existing_device(d)
        #: the device of each slot, row-major on the axes
        self.devices = devs.reshape(sizes)
        #: each slot's position in the device list, laid out alike
        self.slots = np.arange(self.size).reshape(sizes)

    def axis_size(self, *axes: str) -> int:
        return int(np.prod([self.shape[a] for a in axes])) if axes else 1

    def coords(self, slot: int) -> Dict[str, int]:
        """The coordinates of ``slot`` on the axes."""
        at = np.unravel_index(int(slot), self.slots.shape)
        return {a: int(i) for a, i in zip(self.axis_names, at)}

    def index(self, slot: int, *axes: str) -> int:
        """``slot``'s position along ``axes`` (row-major)."""
        c = self.coords(slot)
        i = 0
        for a in axes:
            i = i * self.shape[a] + c[a]
        return i

    def peers(self, slot: int, *axes: str) -> list:
        """The slots that differ from ``slot`` only along ``axes``, in
        their row-major order along them (``slot`` among them)."""
        c = self.coords(slot)
        at = tuple(slice(None) if a in axes else c[a]
                   for a in self.axis_names)
        sub = self.slots[at]
        kept = [a for a in self.axis_names if a in axes]
        order = [kept.index(a) for a in axes]
        return [int(s) for s in np.transpose(sub, order).reshape(-1)]

    def device_of(self, slot: int) -> torch.device:
        return self.devices.reshape(-1)[int(slot)]

    def lead_slots(self, axis: str) -> list:
        """One slot for each position along ``axis``: the one whose other
        coordinates are all 0."""
        return self.peers(0, axis) if axis in self.shape else [0]

    def __repr__(self) -> str:
        return (f"DeviceMesh({self.shape}, "
                f"{[str(d) for d in self.devices.reshape(-1)]})")


def _existing_device(d) -> torch.device:
    dev = torch.device(d) if not isinstance(d, torch.device) else d
    if dev.type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        idx = 0 if dev.index is None else dev.index
        if idx >= count:
            raise ValueError(f"device {dev} is not there: {count} CUDA "
                             "device(s) are available")
        dev = torch.device("cuda", idx)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def build_mesh(axes: Dict[str, int], devices: Optional[Sequence] = None):
    """A named mesh, e.g. ``build_mesh({"data": 2, "sp": 2})``: over the
    process group's ranks (:class:`Mesh`), or with ``devices`` over that
    list of devices in this process (:class:`DeviceMesh`, its first
    ``prod(axes)`` devices)."""
    if devices is not None:
        return DeviceMesh(axes, devices)
    return Mesh(axes)


def build_hybrid_mesh(ici_axes: Dict[str, int],
                      dcn_axes: Dict[str, int]) -> Mesh:
    """The multi-slice mesh of the JAX package: each axis ``ici * dcn``
    ranks. Keys of ``dcn_axes`` must be a subset of ``ici_axes``. One host
    of cards has no slices, so this is the single-slice mesh with the same
    axis names and product sizes."""
    unknown = set(dcn_axes) - set(ici_axes)
    if unknown:
        raise ValueError(f"dcn_axes {sorted(unknown)} not present in ici_axes "
                         f"{sorted(ici_axes)}")
    return build_mesh({k: int(v) * int(dcn_axes.get(k, 1))
                       for k, v in ici_axes.items()})


def data_parallel_mesh(n: Optional[int] = None,
                       devices: Optional[Sequence] = None) -> Mesh:
    """``{"data": n}``, ``n`` defaulting to the number of ``devices``, or
    without them to the process group's size."""
    n = n or (len(devices) if devices is not None else world()[1])
    return build_mesh({"data": n}, devices)


def batch_sharding(mesh: Mesh):
    """The spec of a batch split on its leading axis over ``data``."""
    from .partition import PartitionSpec
    return PartitionSpec("data")


def replicated(mesh: Mesh):
    from .partition import PartitionSpec
    return PartitionSpec()


def shard_params_for_tp(params_tree, conf, mesh: Mesh,
                        model_axis: str = "model"):
    """A params tree (list- or dict-style) placed by the ``dp_tp`` rules:
    each rank keeps its block of every leaf the Megatron column and row
    splits cut over ``model_axis`` (the spec's contiguous block, as JAX
    lays the sharded array out), and the indivisible or tiny leaves whole.
    Training under this placement is ``ParallelWrapper.sharding("dp_tp")``
    (``tensor_parallel.py``), which writes out the collectives GSPMD
    inserts in JAX."""
    from . import partition
    specs = partition.match_partition_rules(
        partition.dp_tp_rules(model_axis), params_tree, mesh=mesh, conf=conf)
    return partition.device_put(params_tree, mesh, specs)
