"""Named-axis sharding rules: logical tensor axes → mesh placements (the
port of ``repro/sharding.py``).

Every tensor is annotated with *logical* axis names; this module maps them
onto the physical mesh, a :class:`torch.distributed.device_mesh.DeviceMesh`
with named dims (``pod × data × model`` multi-pod, or ``data × model``
single-pod). The mapping is adaptive: a logical axis is only sharded if
its size divides the mesh axis size (starcoder2-7b's 36 heads do not
divide model=16, so heads fall back to replicated and the MLP carries the
tensor parallelism).

Conventions (the reference's):
  "batch"    — data-parallel batch          → ("pod", "data")
  "fsdp"     — parameter FSDP dim           → ("pod", "data")
  "tp"       — tensor-parallel dim (heads / d_ff / experts / vocab) → "model"
  "seq_kv"   — KV-cache sequence dim for decode                     → "model"
  "rows"     — AWP row-parallel d_out dim   → all axes (whole mesh)
  None       — replicated

A spec is a :class:`P`, a tuple with one entry per tensor dim (None, one
mesh axis name, or a tuple of them), the entries JAX's ``PartitionSpec``
holds. :func:`placements` turns it into DTensor placements, one per mesh
dim; :func:`hint` is the counterpart of ``with_sharding_constraint``: the
identity on a plain tensor or without a mesh, a ``redistribute`` on a
DTensor.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch

from repro_torch.quant import QTensor


class P(tuple):
    """A partition spec: ``P(None, "model", ("data", "model"))``. A
    one-name tuple entry is stored as the name, as JAX's ``PartitionSpec``
    normalizes it (``P(("data",), None) == P("data", None)``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return "P" + super().__repr__()


def mesh_axis_names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ())


def mesh_axis_size(mesh, name: str) -> int:
    return int(mesh.shape[mesh_axis_names(mesh).index(name)])


def mesh_coord(mesh, axes) -> int:
    """This rank's flat index over mesh dims ``axes`` (major first)."""
    i = 0
    for a in axes:
        i = i * mesh_axis_size(mesh, a) + mesh.get_local_rank(a)
    return i


def axes_group(mesh, axes):
    """The process group of this rank's ranks along mesh dims ``axes``
    (several dims: the mesh flattened over them, major first, which the
    mesh makes once and keeps)."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Physical meaning of each logical axis for a given mesh (None =
    single device / no constraint mode)."""
    mesh: Optional[Any] = None
    batch_axes: tuple = ("data",)       # ("pod","data") on multi-pod
    tp_axis: Optional[str] = "model"
    fsdp_axes: tuple = ("data",)
    rows_axes: tuple = ("data", "model")

    @staticmethod
    def for_mesh(mesh) -> "ShardingRules":
        if mesh is None:
            return ShardingRules(mesh=None)
        names = mesh_axis_names(mesh)
        batch = tuple(n for n in ("pod", "data") if n in names)
        tp = "model" if "model" in names else None
        rows = tuple(n for n in ("pod", "data", "model") if n in names)
        return ShardingRules(mesh=mesh, batch_axes=batch or ("data",),
                             tp_axis=tp, fsdp_axes=batch or ("data",),
                             rows_axes=rows)

    # -- helpers ----------------------------------------------------------
    def axis_size(self, axes) -> int:
        if self.mesh is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        n = 1
        for a in axes:
            n *= mesh_axis_size(self.mesh, a)
        return n

    def _resolve(self, logical: Optional[str], dim: int):
        """Logical name -> mesh axes, or None when not shardable/divisible."""
        if logical is None or self.mesh is None:
            return None
        table = {
            "batch": self.batch_axes,
            "fsdp": self.fsdp_axes,
            "tp": self.tp_axis,
            "seq_kv": self.tp_axis,
            "rows": self.rows_axes,
        }
        axes = table.get(logical)
        if axes is None:
            return None
        size = self.axis_size(axes)
        if size <= 1 or dim % size != 0:
            return None                      # adaptive fallback: replicate
        return axes

    def spec(self, logical_axes: Sequence[Optional[str]],
             shape: Sequence[int]) -> P:
        assert len(logical_axes) == len(shape), (logical_axes, shape)
        entries, used = [], set()
        for name, dim in zip(logical_axes, shape):
            ax = self._resolve(name, dim)
            # a mesh axis may appear at most once in a spec
            if ax is not None:
                flat = (ax,) if isinstance(ax, str) else tuple(ax)
                if any(a in used for a in flat):
                    ax = None
                else:
                    used.update(flat)
            entries.append(ax)
        return P(*entries)


def placements(mesh, spec: Sequence) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every
    mesh dim that tensor dim ``d``'s entry names, ``Replicate()`` on the
    others. The rules name mesh axes in mesh order, so a dim split over
    several mesh dims is split major-first, as JAX splits it."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in mesh_axis_names(mesh)]
    names = mesh_axis_names(mesh)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            out[names.index(a)] = Shard(d)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec (the counterpart of ``jax.sharding.NamedSharding``):
    where a leaf lives; :attr:`placements` are its DTensor placements."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> list:
        return placements(self.mesh, self.spec)


def rules_for_cell(mesh, family: str, kind: str,
                   global_batch: Optional[int] = None) -> ShardingRules:
    """Family/step-specific physical mapping: every family uses batch over
    (pod, data) + TP over model (the reference's ``rules_for_cell``)."""
    return ShardingRules.for_mesh(mesh)


def qtensor_logical_axes(dense_axes, qt):
    """Per-child logical axes for a packed QTensor leaf: ``dense_axes``
    are the dense leaf's in stored orientation ``(…lead, d_in, d_out)``;
    ``packed``/``scale``/``zero`` get ``(…lead, d_out_ax, d_in_ax)``,
    ``col_scale`` keeps the d_in axis. Returned as a QTensor-of-tuples so
    the axes tree mirrors the param tree node for node."""
    lead = tuple(dense_axes[:-2])
    d_in_ax, d_out_ax = dense_axes[-2], dense_axes[-1]
    return QTensor(
        packed=lead + (d_out_ax, d_in_ax),
        scale=lead + (d_out_ax, d_in_ax),
        zero=lead + (d_out_ax, d_in_ax),
        bits=qt.bits, group_size=qt.group_size, shape=qt.shape,
        col_scale=(lead + (d_in_ax,)) if qt.col_scale is not None else None)


def adapt_logical_axes(logical_tree, params):
    """QTensor-aware param axes: wherever ``params`` holds a packed QTensor
    leaf, expand the dense leaf axes into per-child axes; dense leaves pass
    through untouched."""
    if isinstance(params, QTensor):
        return qtensor_logical_axes(logical_tree, params)
    if isinstance(logical_tree, dict):
        return {k: adapt_logical_axes(logical_tree[k], params[k])
                for k in logical_tree}
    return logical_tree


def _shape(leaf):
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def tree_specs(rules: ShardingRules, logical_tree, shape_tree):
    """Mirror-walk a logical-axes tree against a tree of tensors (or
    shapes) and produce specs; QTensor nodes map per child."""
    if isinstance(logical_tree, dict):
        return {k: tree_specs(rules, logical_tree[k], shape_tree[k])
                for k in logical_tree}
    if isinstance(logical_tree, QTensor):
        qt = logical_tree
        return QTensor(
            packed=rules.spec(qt.packed, _shape(shape_tree.packed)),
            scale=rules.spec(qt.scale, _shape(shape_tree.scale)),
            zero=rules.spec(qt.zero, _shape(shape_tree.zero)),
            bits=qt.bits, group_size=qt.group_size, shape=qt.shape,
            col_scale=(rules.spec(qt.col_scale, _shape(shape_tree.col_scale))
                       if qt.col_scale is not None else None))
    return rules.spec(logical_tree, _shape(shape_tree))


def _map_specs(fn, specs):
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, QTensor):
        return specs._replace(
            packed=fn(specs.packed), scale=fn(specs.scale),
            zero=fn(specs.zero),
            col_scale=None if specs.col_scale is None else fn(specs.col_scale))
    return fn(specs)


def tree_shardings(rules: ShardingRules, logical_tree, shape_tree):
    """A :class:`NamedSharding` for every leaf (None without a mesh)."""
    if rules.mesh is None:
        return None
    specs = tree_specs(rules, logical_tree, shape_tree)
    return _map_specs(lambda s: NamedSharding(rules.mesh, s), specs)


def distribute(x: torch.Tensor, sharding: NamedSharding):
    """``x`` (every rank passes the same whole tensor) as a DTensor placed
    by ``sharding``; each rank keeps its shard."""
    from torch.distributed.tensor import distribute_tensor
    mesh = sharding.mesh
    if mesh.device_type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device(mesh.device_type)
    return distribute_tensor(x.to(dev), mesh, sharding.placements)


def distribute_tree(tree, shardings):
    """Each tensor of ``tree`` placed by its :class:`NamedSharding` from
    ``shardings`` (a tree of :func:`tree_shardings`); QTensor leaves per
    child."""
    if isinstance(tree, dict):
        return {k: distribute_tree(tree[k], shardings[k]) for k in tree}
    if isinstance(tree, QTensor):
        sh = shardings
        return tree._replace(
            packed=distribute(tree.packed, sh.packed),
            scale=distribute(tree.scale, sh.scale),
            zero=distribute(tree.zero, sh.zero),
            col_scale=(None if tree.col_scale is None else
                       distribute(tree.col_scale, sh.col_scale)))
    return distribute(tree, shardings)


def full_tensor(x):
    """The whole tensor of a DTensor (every rank gets it); a plain tensor
    as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def local_block(x, mesh, spec: Sequence, partial_axes: Sequence[str] = ()):
    """This rank's block of ``x`` laid out by ``spec`` on ``mesh`` (a
    ``shard_map`` in-spec). A DTensor is redistributed to that layout, so
    only the rank's own block comes over (nothing moves where it already
    lies so); a plain tensor, which every rank holds whole, is sliced.
    ``partial_axes``: the mesh dims whose ranks compute on different data
    with the block, so its gradient there is a partial sum (reduced in
    backward)."""
    if is_dtensor(x):
        from torch.distributed.tensor import Partial
        pl = placements(mesh, spec)
        grad_pl = list(pl)
        for a in partial_axes:
            grad_pl[mesh_axis_names(mesh).index(a)] = Partial()
        return x.redistribute(mesh, pl).to_local(grad_placements=grad_pl)
    for d, entry in enumerate(spec):
        if entry is None or entry == ():
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        n = 1
        for a in axes:
            n *= mesh_axis_size(mesh, a)
        m = x.shape[d] // n
        x = x.narrow(d, mesh_coord(mesh, axes) * m, m)
    return x


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def opt_logical_axes(opt_name: str, param_logical, param_shapes):
    """Logical axes for optimizer state mirroring the params tree."""
    if opt_name == "adamw":
        return {"m": param_logical, "v": param_logical, "step": ()}

    def leaf(log, shape):
        if len(_shape(shape)) >= 2:
            return {"vr": tuple(log[:-1]), "vc": tuple(log[:-2]) + (log[-1],)}
        return {"v": tuple(log)}

    def rec(log, shp):
        if isinstance(log, dict):
            return {k: rec(log[k], shp[k]) for k in log}
        return leaf(log, shp)

    return {"v": rec(param_logical, param_shapes), "step": ()}


def hint(x: torch.Tensor, rules: Optional[ShardingRules], logical_axes):
    """The counterpart of ``with_sharding_constraint``: identity on a plain
    tensor or without a mesh; a DTensor is redistributed to the spec's
    placements."""
    if rules is None or rules.mesh is None or not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh,
                          placements(x.device_mesh,
                                     rules.spec(logical_axes, x.shape)))


NO_RULES = ShardingRules(mesh=None)

__all__ = ["NO_RULES", "NamedSharding", "P", "ShardingRules",
           "adapt_logical_axes", "axes_group", "distribute", "mesh_coord",
           "distribute_tree", "full_tensor", "hint", "is_dtensor",
           "local_block",
           "mesh_axis_size", "opt_logical_axes", "placements",
           "qtensor_logical_axes", "rules_for_cell", "tree_shardings",
           "tree_specs"]
