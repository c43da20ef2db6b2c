"""Sharded checkpoints of a network's training state.

Counterpart of ``deeplearning4j_tpu/utils/sharded_checkpoint.py``. The
zip container (``utils/model_serializer.py``) gathers everything to one
host; a sharded checkpoint lets each rank write its own blocks. The array
state goes through ``torch.distributed.checkpoint`` into ``<dir>/state``
(one ``.distcp`` file a rank and a ``.metadata`` index): params, layer
states and updater state, keyed ``params/<layer>/<name>``,
``states/<layer>/<name>`` and ``updater/<layer>/<name>/<slot>``. Between
the steps of a sharded fit the network names its placement
(``net._held_sharding``), and the placement says what this rank saves of
each leaf (``checkpoint_entry``), with no gather:

* a leaf that ZeRO (``ParallelWrapper`` with ``zero1``, FSDP or ``zero3``,
  ``parallel/compile_seam.py``) or ``dp_tp`` (``parallel/
  tensor_parallel.py``) holds split is saved from the block its rank
  holds, its split dim moved first, under the key
  ``<key>@shard<i>of<n>@dim<d>``, with ``@groups<g>`` where the block is
  the concatenation of its share of ``g`` equal parts of the dim (a
  ``dp_tp`` rank's heads' q, k and v columns of ``Wqkv``);
* a block of a pipeline's stack (``parallel/pipeline_trainer.py``) is
  saved whole by the stage that owns it, and by no other;
* a whole leaf is written by one rank (the ranks that hold it alike are
  deduplicated).

:func:`restore_sharded` reads the blocks of every rank back into whole
tensors, or, given a spec tree and a process-group mesh (``shardings=``,
``mesh=``), onto that sharding: each rank keeps only its block of each
leaf a spec splits, as a sharded fit holds it between steps.

The sidecar is the JAX package's exactly: ``config.json`` (the config
JSON) and ``meta.json`` (``iteration``, ``epoch``, ``step``,
``network_type``), written by rank 0 after the array state has landed,
and removed before a new write. It is the commit marker:
:func:`restore_sharded` refuses array state without it. The JAX package
writes orbax/TensorStore arrays; the port has no orbax and does not
reproduce that layout, so a checkpoint directory is read by the package
that wrote it (ROADMAP.md §C).
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Optional

import torch
import torch.distributed as dist

_PARAMS = "params"
_UPDATER = "updater"
_STATES = "states"
_STATE_DIR = "state"
_CONFIG_FILE = "config.json"
_META_FILE = "meta.json"
_SHARD = re.compile(r"^(.*)@shard(\d+)of(\d+)@dim(\d+)(?:@groups(\d+))?$")


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def _distributed() -> bool:
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def _barrier() -> None:
    if _distributed():
        dist.barrier()


def _items(tree):
    return tree.items() if isinstance(tree, dict) else enumerate(tree)


def shard_suffix(index: int, n: int, dim: int, groups: int = 1) -> str:
    """The key suffix of block ``index`` of ``n`` along ``dim`` (see the
    module docstring)."""
    return f"@shard{index}of{n}@dim{dim}" + (
        f"@groups{groups}" if groups > 1 else "")


def _state_dict(net) -> dict:
    """The network's training state as flat keys -> tensors, as this rank
    saves it: between the steps of a sharded fit, what its placement says
    (a block under a shard key, or nothing where another rank writes the
    leaf)."""
    sh = getattr(net, "_held_sharding", None)
    out = {}

    def put(key, layer, name, t, slot=None):
        entry = ("", t) if sh is None else sh.checkpoint_entry(
            layer, name, t, slot)
        if entry is not None:
            out[key + entry[0]] = entry[1].detach()

    for layer, params in _items(net.params_list):
        for name, t in params.items():
            put(f"{_PARAMS}/{layer}/{name}", layer, name, t)
    for layer, states in _items(net.state_list):
        for name, t in states.items():
            out[f"{_STATES}/{layer}/{name}"] = t.detach()
    for layer, upd in _items(net.updater_state or []):
        for name, slots in upd.items():
            for slot, t in slots.items():
                put(f"{_UPDATER}/{layer}/{name}/{slot}", layer, name, t, slot)
    return out


def _snapshot_sidecar(net, step: Optional[int]) -> dict:
    """The sidecar, taken at save time (an async write lands later, when
    ``net`` may have trained on)."""
    return {"config": net.conf.to_json(),
            "meta": {"iteration": int(getattr(net, "iteration", 0)),
                     "epoch": int(getattr(net, "epoch", 0)),
                     "step": step,
                     "network_type": type(net).__name__}}


def _write_sidecar_payload(directory: str, payload: dict) -> None:
    """Config and bookkeeping JSON beside the array state, written by rank 0
    once the array state is on disk (the commit marker)."""
    if _rank() != 0:
        return
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, _CONFIG_FILE), "w") as f:
        f.write(payload["config"])
    with open(os.path.join(directory, _META_FILE), "w") as f:
        json.dump(payload["meta"], f)


def _begin(directory: str) -> str:
    """Before new array state: rank 0 removes the last save's commit marker
    and array state (a crash mid-write then leaves no sidecar endorsing a
    torn state); every rank waits for it. Returns the state directory."""
    state = os.path.join(directory, _STATE_DIR)
    if _rank() == 0:
        for name in (_CONFIG_FILE, _META_FILE):
            path = os.path.join(directory, name)
            if os.path.exists(path):
                os.remove(path)
        if os.path.exists(state):
            shutil.rmtree(state)
        os.makedirs(state)
    _barrier()
    return state


def _dcp_kwargs() -> dict:
    return {} if dist.is_available() and dist.is_initialized() \
        else {"no_dist": True}


def save_sharded(directory: str, net, *, step: Optional[int] = None) -> str:
    """Write a sharded checkpoint of the network's training state (every
    rank of a distributed fit calls it); saving to the same directory
    again replaces the last one. Returns the directory."""
    import torch.distributed.checkpoint as dcp

    directory = os.path.abspath(directory)
    state = _begin(directory)
    dcp.save(_state_dict(net), checkpoint_id=state, **_dcp_kwargs())
    _write_sidecar_payload(directory, _snapshot_sidecar(net, step))
    return directory


class AsyncShardedSaver:
    """Sharded saves that do not stall training: ``save`` copies the state
    to the host and returns; the write runs on a background thread
    (``torch.distributed.checkpoint.async_save``). One save is in flight at
    a time: a new ``save`` waits for the last one and commits it. Call
    ``wait()`` (or use the object as a context manager) before reading the
    checkpoint or exiting.

    The sidecar, snapshotted at ``save`` time, is written only after
    ``wait`` confirms the array write landed, so a crash mid-save leaves
    array state without a sidecar, which :func:`restore_sharded` refuses.
    In a distributed group the group needs a CPU backend (gloo)."""

    def __init__(self):
        self._future = None
        self._pending: Optional[tuple] = None
        #: saves committed by this saver
        self.committed = 0

    def save(self, directory: str, net, *, step: Optional[int] = None) -> str:
        import torch.distributed.checkpoint as dcp

        directory = os.path.abspath(directory)
        self.wait()
        state = _begin(directory)
        snapshot = {k: t.to("cpu", copy=True)
                    for k, t in _state_dict(net).items()}
        self._future = dcp.async_save(snapshot, checkpoint_id=state,
                                      **_dcp_kwargs())
        self._pending = (directory, _snapshot_sidecar(net, step))
        return directory

    def wait(self) -> None:
        if self._future is not None:
            future, self._future = self._future, None
            future.result()
        if self._pending is not None:
            pending_dir, payload = self._pending
            self._pending = None
            _write_sidecar_payload(pending_dir, payload)
            self.committed += 1

    def close(self) -> None:
        self.wait()

    def __enter__(self) -> "AsyncShardedSaver":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def is_committed(directory: str) -> bool:
    return os.path.exists(os.path.join(directory, _META_FILE))


def _metadata(state_dir: str) -> dict:
    from torch.distributed.checkpoint import FileSystemReader
    return FileSystemReader(state_dir).read_metadata().state_dict_metadata


def _load(state_dir: str, md: dict, keys) -> dict:
    """The stored tensors of ``keys`` (host tensors), read without the
    others."""
    import torch.distributed.checkpoint as dcp
    flat = {k: torch.empty(md[k].size, dtype=md[k].properties.dtype)
            for k in keys}
    if flat:
        dcp.load(flat, checkpoint_id=state_dir, no_dist=True)
    return flat


def _layout(md: dict) -> dict:
    """Each stored leaf's key: ``base -> None`` for a whole leaf, or
    ``base -> (n, dim, groups, {index: key})`` for one saved in blocks."""
    out: dict = {}
    for key in md:
        m = _SHARD.match(key)
        if m is None:
            out[key] = None
            continue
        base, i, n, d = m.group(1), *(int(g) for g in m.groups()[1:4])
        g = int(m.group(5) or 1)
        out.setdefault(base, (n, d, g, {}))[3][i] = key
    return out


def _join(base: str, entry, flat: dict, where: str) -> torch.Tensor:
    """A leaf saved in blocks, whole again: the blocks (dim first)
    concatenated, each of its ``groups`` parts in turn, the dim moved
    back."""
    n, d, g, keys = entry
    if sorted(keys) != list(range(n)):
        raise RuntimeError(f"checkpoint {where}: {base} has blocks "
                           f"{sorted(keys)} of {n}")
    blocks = [flat[keys[i]].chunk(g) for i in range(n)]
    return torch.cat([b[j] for j in range(g) for b in blocks]).movedim(0, d)


def _read_state(state_dir: str) -> dict:
    """Every key of a checkpoint as a whole host tensor: the shard keys of
    all ranks concatenated back along their dim."""
    md = _metadata(state_dir)
    flat = _load(state_dir, md, md)
    return {base: flat[base] if entry is None
            else _join(base, entry, flat, state_dir)
            for base, entry in _layout(md).items()}


def _leaf_keys(net):
    """``(key, layer, name, slot, tensor)`` of every leaf a checkpoint
    holds of ``net``: params and updater slots (slot None for a param),
    then layer states (name prefixed)."""
    trees = ((_PARAMS, net.params_list), (_UPDATER, net.updater_state),
             (_STATES, net.state_list))
    for kind, tree in trees:
        for layer, leaves in _items(tree):
            for name, v in leaves.items():
                slots = v.items() if isinstance(v, dict) else [(None, v)]
                for slot, t in slots:
                    key = f"{kind}/{layer}/{name}" + (
                        "" if slot is None else f"/{slot}")
                    yield key, kind, layer, name, slot, t


@torch.no_grad()
def restore_sharded(directory: str, net=None, *, device=None,
                    shardings=None, mesh=None):
    """Restore a sharded checkpoint into ``net`` (made and initialized if
    it is not) or, with ``net`` None, into a network built from the stored
    config on ``device`` (None means CUDA). Iteration and epoch come from
    the sidecar.

    Without ``shardings`` every leaf comes back whole, bitwise as saved.
    With ``shardings`` (a spec tree over the params, ``PartitionSpec``
    leaves, or one spec for every leaf; it stands where JAX takes a tree of
    ``NamedSharding``) and ``mesh`` (a process-group ``Mesh``; every rank
    calls this) the leaves land on that sharding: each rank keeps only its
    block of each leaf a spec splits (the spec's contiguous block; an
    updater slot of the param's shape is cut as its param; a dim the mesh
    does not divide stays whole), bitwise the saved leaf's slice, and the
    network holds the blocks as a sharded fit holds them between steps
    (``net._held_sharding``, a ``compile_seam.RestoredSharding``). Where a
    leaf was saved in blocks split as the target splits it (the same count
    along the same dim, no groups), a rank reads only its own block;
    otherwise it reads the whole leaf (joining the saved blocks) and keeps
    its block. ``output`` gathers the params whole for each call; any other
    entry point, a fit resuming from the restore among them, first makes
    the network whole on every rank. A device mesh is a serving placement:
    restore whole and pin the network with ``make_predict_fn(net,
    sharding=, mesh=)``."""
    if shardings is not None or mesh is not None:
        if shardings is None or mesh is None:
            raise ValueError("a restore onto a sharding takes both "
                             "shardings= (specs) and mesh= (the process-"
                             "group mesh they place on)")
        from ..parallel.partition import is_device_mesh
        if is_device_mesh(mesh):
            raise ValueError(
                "a device mesh is a serving placement: restore whole "
                "(restore_sharded(directory)) and serve the network "
                "through make_predict_fn(net, sharding=, mesh=)")
    directory = os.path.abspath(directory)
    state_dir = os.path.join(directory, _STATE_DIR)
    # the sidecar is written only after the array write landed: array
    # state without it is a save that crashed mid-write
    if os.path.exists(state_dir) and not is_committed(directory):
        raise RuntimeError(
            f"checkpoint at {directory} has array state but no committed "
            f"sidecar ({_META_FILE}); an async save likely crashed before "
            "wait()/close() — refusing to restore an incomplete checkpoint")
    with open(os.path.join(directory, _META_FILE)) as f:
        meta = json.load(f)
    if net is None:
        with open(os.path.join(directory, _CONFIG_FILE)) as f:
            net = _net_from_config(f.read(), meta, device)
    if not getattr(net, "_initialized", True) or net.updater_state is None:
        net.init()
    md = _metadata(state_dir)
    layout = _layout(md)
    leaves = list(_leaf_keys(net))
    want = {key for key, *_ in leaves}
    missing = sorted(want - set(layout))
    if missing:
        raise RuntimeError(f"checkpoint {directory} has no {missing[0]}")
    extra = set(layout) - want
    if extra:
        raise RuntimeError(f"checkpoint {directory} holds leaves the "
                           f"network lacks: {sorted(extra)[:5]}")
    if shardings is None:
        flat = _load(state_dir, md, md)
        for key, _k, _l, _n, _s, t in leaves:
            entry = layout[key]
            t.copy_(flat[key] if entry is None
                    else _join(key, entry, flat, directory))
    else:
        _restore_onto(state_dir, md, layout, net, leaves, shardings, mesh)
    net.iteration = int(meta.get("iteration", 0))
    net.epoch = int(meta.get("epoch", 0))
    if hasattr(net, "_drop_step_graphs"):
        net._drop_step_graphs()
    return net


def _restore_onto(state_dir, md, layout, net, leaves, shardings, mesh):
    """Each rank's blocks of the leaves ``shardings`` split, the rest
    whole; installs the ``RestoredSharding`` placement."""
    from ..parallel import partition
    from ..parallel.compile_seam import RestoredSharding, _spec_at

    plan = []  # (key, t, slot, (d, axes) or None, own block key or None)
    params = net.params_list
    for key, kind, layer, name, slot, t in leaves:
        at = None
        if kind != _STATES and tuple(t.shape) == tuple(
                params[layer][name].shape):
            spec = partition._resolve(_spec_at(shardings, layer, name),
                                      tuple(t.shape), mesh)
            at = partition.one_split(spec, "restore onto a sharding")
        own = None
        entry = layout[key]
        if at is not None and entry is not None:
            n, d, g, keys = entry
            if (n, d, g) == (mesh.axis_size(*at[1]), at[0], 1):
                own = keys.get(mesh.index(*at[1]))
        plan.append((key, kind, layer, name, slot, t, at, own))
    reads = set()
    for key, *_rest, at, own in plan:
        entry = layout[key]
        reads |= ({own} if own is not None else {key} if entry is None
                  else set(entry[3].values()))
    flat = _load(state_dir, md, sorted(reads))
    blocks = {}
    for key, kind, layer, name, slot, t, at, own in plan:
        if own is not None:
            block = flat[own]
        else:
            entry = layout[key]
            whole = (flat[key] if entry is None
                     else _join(key, entry, flat, state_dir))
            if at is None:
                t.copy_(whole)
                continue
            d, axes = at
            block = whole.movedim(d, 0).chunk(mesh.axis_size(*axes))[
                mesh.index(*axes)].clone()
        blocks[(layer, name, slot)] = (block.to(t.device).contiguous(),
                                       at[0], at[1])
    placement = RestoredSharding(net, mesh, blocks)
    #: which stored keys this rank read: its own blocks only, or whole
    #: leaves (each block of a leaf saved in blocks) too
    placement.reads = {"own_blocks": sum(1 for p in plan if p[-1]),
                       "keys": len(reads)}
    net._held_sharding = placement


def _net_from_config(config_json: str, meta: dict, device):
    if meta.get("network_type") == "ComputationGraph":
        from ..nn.conf.graphconf import ComputationGraphConfiguration
        from ..nn.graph_network import ComputationGraph
        return ComputationGraph(
            ComputationGraphConfiguration.from_json(config_json),
            device=device)
    from ..nn.conf.multilayer import MultiLayerConfiguration
    from ..nn.multilayer import MultiLayerNetwork
    return MultiLayerNetwork(MultiLayerConfiguration.from_json(config_json),
                             device=device)
