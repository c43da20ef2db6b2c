"""Snapshot-pinned inference: the serving seam.

Counterpart of ``deeplearning4j_tpu/nn/inference.py``. :class:`PredictFn`
pins a copy of a network's parameters and layer states on its device, so
serving never sees a later change to the source network and the source
never sees serving. It serves a ``MultiLayerNetwork`` or a
``ComputationGraph``; a graph takes one positional array per declared input
(:attr:`PredictFn.n_inputs`) and returns its one output, or a list when it
declares several.
With ``quant="int8"`` the pinned copy holds int8 codes and per-channel
scales (``ops/quant.py``) and is dequantized on every call, as the JAX
package does inside its compiled program (``inference.py:60``): the weights
at rest are 8-bit, the forward computes on the dequantized float copy.
Every call runs under the dtype policy the network's config names (the
ambient one when it names none), as the JAX ``PredictFn``'s program is
traced under it. :func:`make_predict_fn` decorates the pin's name as the
JAX package does (``serve_predict@v2+int8~r0``).

``sharding="dp_tp"`` (any rule set) with ``mesh=build_mesh(axes,
devices=[...])`` pins the snapshot sharded over that device mesh, one
process driving its devices as the JAX package's single controller does.
The specs come from the partition rules (``parallel/partition.py``) as in
training. The params are sharded **at rest**: each slot of the mesh holds
its block of every split leaf and a copy of every other leaf on its
device, so :attr:`PredictFn.per_device_param_bytes` is the partition
math's bytes a device (int8 codes and scales shard too). They are gathered
**at use**: a call cuts the batch over the ``data`` axis when that axis
divides it (``partition.batch_spec``), and each data slot's lead device
(its other coordinates 0) copies its peers' blocks to itself and
concatenates them, an exact layout change with no arithmetic, then runs
the unchanged forward on its rows; the outputs are joined in row order on
the mesh's first device. A batch the data axis does not divide runs once,
whole, on the first device. So the sharded pin computes each row as the
single-device pin computes it, which is the JAX package's serving bitwise
contract (its module docstring): the gain is resident bytes and data-axis
scale-out, not distributed products, and the gather must not become
sharded compute. On the card every float32 dense product of a pin runs
through ``ops/fixed_matmul.py``, whose answer for a row does not depend on
the row count (cuBLAS's does), so the sharded pin is bitwise the whole pin
at every batch size. One exception is staged, not computed, for the CPU: a
slot whose share is one row runs it beside a copy of itself and keeps the
first row, since a one-row product takes BLAS's matrix-vector route, whose
sums run in another order than the matrix product of a whole batch.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from ..common import resolve_device, wrap_with_policy
from .graph_network import ComputationGraph
from ..ops.fixed_matmul import row_invariant_matmuls
from ..ops.quant import dequantize_tree, quantize_tree, tree_param_bytes

#: the name every serving forward pins under, decorated per version, int8
#: policy and replica by :func:`make_predict_fn`
PREDICT_PROGRAM_NAME = "serve_predict"

#: serving dtype policies: None and "bf16" serve the snapshot at the
#: network's policy dtype; "int8" quantizes the large matrix leaves at pin
#: time
QUANT_MODES = (None, "bf16", "int8")


def copy_tree(tree, device: torch.device):
    """Real copies on ``device`` of a per-layer tree of tensor dicts, params
    or layer states: a list (a ``MultiLayerNetwork``'s, by layer) or a dict
    (a ``ComputationGraph``'s, by vertex)."""
    def copy_dict(p):
        return {k: v.detach().clone().to(device) for k, v in p.items()}
    if isinstance(tree, dict):
        return {n: copy_dict(p) for n, p in tree.items()}
    return [copy_dict(p) for p in tree]


def to_device_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.array(x)).to(device)


def _check_placement(sharding, mesh, device) -> None:
    """JAX's validation of a pin's placement, and the port's own: a
    sharded pin needs a device mesh."""
    if sharding is not None and mesh is None:
        raise ValueError("sharding requires a mesh (parallel.build_mesh)")
    if mesh is not None and device is not None:
        raise ValueError("pass sharding+mesh OR device, not both")
    if mesh is not None and sharding is None:
        raise ValueError("a mesh places a sharded pin: pass sharding= "
                         "(a rule set, e.g. 'dp_tp') with it")
    from ..parallel.partition import is_device_mesh
    if mesh is not None and not is_device_mesh(mesh):
        raise ValueError(
            "a serving pin is placed on a device mesh that one process "
            "drives, build_mesh(axes, devices=[...]); a process-group Mesh "
            "would need every batch broadcast to its ranks")


class PredictFn:
    """A snapshot-pinned forward pass on ``device`` (``None`` means CUDA),
    or sharded by the rule set ``sharding`` over the device mesh ``mesh``
    (the module docstring).

    ``predict_fn(*xs) -> tensor`` on the pin's device, where each input
    carries a leading batch axis: one for a ``MultiLayerNetwork``, one per
    declared input for a ``ComputationGraph`` (a graph with several outputs
    returns a list). Thread-safe: the pinned tensors are only read."""

    def __init__(self, net, quant: Optional[str] = None, device=None,
                 name: str = PREDICT_PROGRAM_NAME, sharding=None, mesh=None):
        net._require_init()
        if quant not in QUANT_MODES:
            raise ValueError(f"quant must be one of {QUANT_MODES}, got {quant!r}")
        _check_placement(sharding, mesh, device)
        self._net = net
        self._name = name
        #: the rule set the pin is sharded by (None: one device)
        self.sharding = sharding
        #: the device mesh of a sharded pin
        self.mesh = mesh
        self.quant = quant if quant == "int8" else None
        #: the pin's device; a sharded pin's first slot's, where calls
        #: answer
        self.device = (mesh.device_of(0) if mesh is not None
                       else resolve_device(device))
        # copies at pin time: a later fit of ``net`` changes neither the
        # served weights nor the served batch-norm statistics (on the CPU,
        # whence a sharded pin is placed)
        home = torch.device("cpu") if mesh is not None else self.device
        self._params = copy_tree(net.params_list, home)
        self._states = copy_tree(net.state_list, self.device)
        self._graph = isinstance(net, ComputationGraph)
        self._n_in = len(net.conf.network_inputs) if self._graph else 1
        self._single_out = (not self._graph
                            or len(net.conf.network_outputs) == 1)
        if self.quant == "int8":
            self._params = quantize_tree(self._params)
        #: the specs of a sharded pin's params (None: one device)
        self.param_specs = None
        if mesh is not None:
            self._pin_sharded(net)
        #: the network's forward under the policy its config names
        self._forward = wrap_with_policy(net._output_pure,
                                         net.conf.global_conf.dtype)
        self._lock = threading.Lock()
        self.calls = 0  #: dispatches served
        #: the batch sizes :meth:`warm` has run, in order
        self.warmed: list = []

    def _pin_sharded(self, net) -> None:
        """The snapshot placed on the mesh by the rule set's specs; the
        layer states copied to each data slot's lead device."""
        from ..parallel import partition
        mesh = self.mesh
        specs = partition.match_partition_rules(
            partition.rules_for(self.sharding), self._params, mesh=mesh,
            conf=net.conf)
        self.param_specs = specs
        self._params = partition.device_put(self._params, mesh, specs)
        partition.record_specs(self.sharding, specs)
        partition.record_param_bytes(self.sharding, self._params, specs, mesh)
        #: the slot that runs each data position's rows
        self._leads = mesh.lead_slots("data")
        self._slot_states = {s: copy_tree(self._states, mesh.device_of(s))
                             for s in self._leads}

    @property
    def name(self) -> str:
        return self._name

    @property
    def n_inputs(self) -> int:
        """Positional input arrays one call takes (1 for a stack)."""
        return self._n_in

    @property
    def param_bytes(self) -> int:
        """Resident bytes of the pinned params (int8 shows the 4x cut); of
        the whole leaves for a sharded pin."""
        return tree_param_bytes(self._params)

    @property
    def per_device_param_bytes(self) -> Optional[int]:
        """Param bytes one device of the mesh holds when sharded (the
        partition math: each leaf's bytes over its shard factor); None for
        a pin on one device."""
        if self.mesh is None:
            return None
        from ..parallel import partition
        return partition.per_device_bytes(self._params, self.param_specs,
                                          self.mesh)

    def slot_param_bytes(self) -> list:
        """The bytes the param tensors each slot of the mesh holds take, in
        slot order (sharded pins)."""
        from ..parallel import partition
        return [partition.slot_bytes(self._params, s)
                for s in range(self.mesh.size)]

    def params_snapshot(self):
        """The pinned params: tensors on the pin's device, or for a sharded
        pin ``partition.MeshLeaf`` leaves holding each slot's tensor (int8
        leaves are ``QuantizedLeaf`` records)."""
        return self._params

    def devices(self) -> list:
        """The devices of the pin, a sharded pin's in slot order."""
        if self.mesh is None:
            return [str(self.device)]
        return [str(d) for d in self.mesh.devices.reshape(-1)]

    def _forward_on(self, params, states, xs):
        if self.quant == "int8":
            params = dequantize_tree(params)
        with row_invariant_matmuls():
            if not self._graph:
                return self._forward(params, states, xs[0])
            outs = self._forward(params, states, xs)
        return outs[0] if self._single_out else outs

    def _run(self, xs):
        if len(xs) != self._n_in:
            raise ValueError(f"model takes {self._n_in} input(s), "
                             f"got {len(xs)}")
        if self.mesh is not None:
            return self._run_sharded(xs)
        xs = [to_device_tensor(x, self.device) for x in xs]
        return self._forward_on(self._params, self._states, xs)

    def _slot_forward(self, slot: int, xs):
        """The forward on ``slot``'s device over the whole params gathered
        there."""
        from ..parallel import partition
        dev = self.mesh.device_of(slot)
        params = partition.gather_whole(self._params, slot)
        return self._forward_on(params, self._slot_states[slot],
                                [to_device_tensor(x, dev) for x in xs])

    def _run_sharded(self, xs):
        from ..parallel import partition
        xs = [x if isinstance(x, torch.Tensor)
              else torch.from_numpy(np.array(x)) for x in xs]
        n = int(xs[0].shape[0])
        if partition.batch_spec(self.mesh, n) == partition.PartitionSpec():
            return self._slot_forward(self._leads[0], xs)
        f = len(self._leads)
        outs = []
        for i, slot in enumerate(self._leads):
            part = [x.chunk(f)[i] for x in xs]
            lone = part[0].shape[0] == 1
            if lone:
                part = [torch.cat([p, p]) for p in part]
            out = self._slot_forward(slot, part)
            if lone:
                out = ([o[:1] for o in out] if isinstance(out, list)
                       else out[:1])
            outs.append(out)
        if isinstance(outs[0], list):
            return [torch.cat([o[j].to(self.device) for o in outs])
                    for j in range(len(outs[0]))]
        return torch.cat([o.to(self.device) for o in outs])

    @torch.no_grad()
    def __call__(self, *xs):
        out = self._run(xs)
        with self._lock:
            self.calls += 1
        return out

    @torch.no_grad()
    def warm(self, *xs) -> None:
        """One forward on an example batch, waited for, so its kernels are
        built and the libraries' algorithms chosen before the pin serves;
        not counted in :attr:`calls`."""
        self._run(xs)
        for d in set(self.devices()):
            if torch.device(d).type == "cuda":
                torch.cuda.synchronize(d)
        with self._lock:
            self.warmed.append(int(np.shape(xs[0])[0]))


def make_predict_fn(net, name: str = PREDICT_PROGRAM_NAME,
                    version: Optional[str] = None,
                    quant: Optional[str] = None, device=None,
                    replica: Optional[int] = None, sharding=None,
                    mesh=None) -> PredictFn:
    """Pin ``net`` for serving on ``device`` (``None`` means CUDA), or
    sharded by the rule set ``sharding`` over the device mesh ``mesh``
    (:class:`PredictFn`). The name gains ``@version``, ``+int8`` and
    ``~r<replica>`` as in the JAX package, so each version's and each
    replica's pin is told apart in status."""
    _check_placement(sharding, mesh, device)
    if version:
        name = f"{name}@{version}"
    if quant == "int8":
        name = f"{name}+int8"
    if replica is not None:
        name = f"{name}~r{replica}"
    return PredictFn(net, quant=quant, device=device, name=name,
                     sharding=sharding, mesh=mesh)
