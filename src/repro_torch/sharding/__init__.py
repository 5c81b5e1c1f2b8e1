"""The mesh + rules bundle and the port's explicit layout (port of
``repro/sharding/__init__.py``).

``ShardCtx`` carries the mesh, the two rules tables and the process
groups the port needs: the ``model`` group the expert-parallel
all-to-all runs over, the group of the other axes (the data-parallel
replicas of one expert shard) and the group of every token axis (the
whole mesh). The reference lets GSPMD place every leaf by the rules;
the port's runtime applies one placement so far, the expert-parallel
one (``moe.ep == "a2a"`` on a mesh ``expert_parallel_layout`` accepts):
each rank holds ``E / ep`` experts of every expert leaf (its slice of
the leaf's ``expert`` dim over ``model``) and a full copy of every
other leaf. :func:`ep_dims` names the sliced dim of each leaf,
:func:`shard_tree` / :func:`gather_tree` move between the global tree
and a rank's. The reference's ``act()`` constraints have no counterpart
(layout hints that leave the numbers alone).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional

import torch

from repro_torch.sharding.logical import (  # noqa: F401
    ACT_RULES,
    EP_AXIS,
    PARAM_RULES,
    Rules,
    expert_parallel_layout,
    make_rules,
    mesh_shape,
    placements_for,
    spec_for,
    tree_placements,
    tree_specs,
)


def _mesh_ranks(mesh):
    """Global ranks of the mesh's devices, shaped like the mesh
    (row-major over a mapping, as ``init_device_mesh`` lays them)."""
    if isinstance(mesh, Mapping):
        return torch.arange(math.prod(mesh.values())).reshape(
            tuple(mesh.values()))
    return mesh.mesh.cpu()


def _make_groups(mesh) -> dict:
    """``{axes tuple: this rank's group over those axes}`` for the
    ``model`` axis, the other axes and all of them, when the group spans
    more than one rank. Every rank creates every group, in one order
    (``new_subgroups_by_enumeration`` is collective)."""
    import torch.distributed as dist

    names = tuple(mesh_shape(mesh))
    ranks = _mesh_ranks(mesh)
    wanted = [names]
    if EP_AXIS in names and len(names) > 1:
        wanted += [(EP_AXIS,), tuple(a for a in names if a != EP_AXIS)]
    groups = {}
    for axes in wanted:
        idx = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in idx]
        size = math.prod(ranks.shape[i] for i in idx)
        if size == 1:
            continue
        if size == dist.get_world_size():
            groups[axes] = dist.group.WORLD
            continue
        enum = ranks.permute(*rest, *idx).reshape(-1, size).tolist()
        groups[axes], _ = dist.new_subgroups_by_enumeration(enum)
    return groups


@dataclasses.dataclass(frozen=True, eq=False)
class ShardCtx:
    """Mesh + rules + process groups, threaded through the model's
    apply functions and the train step. ``None`` ctx (one process) runs
    the single-device path."""

    mesh: Any
    act_rules: Rules
    param_rules: Rules
    groups: Mapping[tuple, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def for_mesh(cls, mesh, *, cfg=None, **kw) -> "ShardCtx":
        """Rules for ``mesh`` (``kw`` as ``make_rules`` takes them), the
        arch's ``cfg.sharding_overrides`` over the param rules, as the
        reference's launcher applies them; and the process groups when a
        process group is initialised."""
        import torch.distributed as dist

        param_kw = dict(kw)
        if cfg is not None and cfg.sharding_overrides:
            over = dict(cfg.sharding_overrides)
            over.update(kw.get("overrides") or {})
            param_kw["overrides"] = over
        groups = {}
        if dist.is_available() and dist.is_initialized():
            groups = _make_groups(mesh)
        return cls(
            mesh=mesh,
            act_rules=make_rules(mesh, params=False, **kw),
            param_rules=make_rules(mesh, params=True, **param_kw),
            groups=groups,
        )

    @property
    def shape(self) -> dict:
        return mesh_shape(self.mesh)

    def size(self, axes) -> int:
        return math.prod(self.shape[a] for a in axes)

    def group(self, axes):
        """This rank's process group over ``axes`` (None when they span
        one rank)."""
        return self.groups.get(tuple(axes))

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        import torch.distributed as dist

        names = list(self.shape)
        pos = (_mesh_ranks(self.mesh) == dist.get_rank()).nonzero()[0]
        return int(pos[names.index(axis)])

    @property
    def token_axes(self) -> tuple:
        return tuple(self.shape)

    @property
    def replica_axes(self) -> tuple:
        """The axes an expert shard is replicated over."""
        return tuple(a for a in self.shape if a != EP_AXIS)


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over ``group`` (a new tensor; ``t`` itself when
    ``group`` is None)."""
    import torch.distributed as dist

    if group is None:
        return t
    out = t.clone()
    dist.all_reduce(out, op={"sum": dist.ReduceOp.SUM,
                             "max": dist.ReduceOp.MAX}[op], group=group)
    return out


# ---------------------------------------------------------------------------
# the expert-parallel layout of a tree
# ---------------------------------------------------------------------------


def ep_dim(axes: str) -> Optional[int]:
    """The dim of a leaf that the EP layout slices over ``model``: its
    ``expert`` dim when that leads (after the stacked ``layer`` dim) —
    the experts' weights, not the router's ``embed expert``."""
    names = axes.split()
    i = 0
    while i < len(names) and names[i] == "layer":
        i += 1
    return i if i < len(names) and names[i] == "expert" else None


def _map(fn, tree, *others):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, *(o[i] for o in others))
                          for i, v in enumerate(tree))
    return fn(tree, *others)


def param_ep_dims(param_axes):
    """Axes tree -> tree of EP-sliced dims (int or None)."""
    return _map(ep_dim, param_axes)


def state_ep_dims(state, param_dims):
    """EP-sliced dims of a train state (``params``, ``opt_state``,
    ``step``, optional ``residual``): the params' own; each optimizer
    slot of a leaf (Adafactor's ``v_row``/``v_col``/``v``, AdamW's
    ``m``/``v``) keeps the leaf's leading dims, so it slices the same
    dim; steps are replicated."""
    out = {}
    for k, v in state.items():
        if k in ("params", "residual"):
            out[k] = param_dims
        elif k == "opt_state":
            out[k] = {kk: (_map(lambda d, s: {n: d for n in s},
                                param_dims, vv) if kk == "slots"
                           else _map(lambda _: None, vv))
                      for kk, vv in v.items()}
        else:
            out[k] = _map(lambda _: None, v)
    return out


def _ep_size(ctx: ShardCtx) -> int:
    """The ``model`` axis's size; 1 when the mesh has none (then no leaf
    is sliced and the tree moves as it is)."""
    return ctx.shape.get(EP_AXIS, 1)


def shard_tree(tree, dims, ctx: ShardCtx):
    """This rank's slice of a global tree: each leaf with a dim in
    ``dims`` cut to its ``model`` coordinate's contiguous block (a copy
    of its own); other leaves kept as they are."""
    ep = _ep_size(ctx)
    if ep == 1:
        return tree
    m = ctx.coord(EP_AXIS)

    def one(t, d):
        if d is None or not isinstance(t, torch.Tensor):
            return t
        n = t.shape[d] // ep
        return t.narrow(d, m * n, n).clone()

    return _map(one, tree, dims)


def gather_tree(tree, dims, ctx: ShardCtx):
    """The global tree from every rank's slices (collective over
    ``model``; every rank gets the whole tree)."""
    import torch.distributed as dist

    ep = _ep_size(ctx)
    if ep == 1:
        return tree
    group = ctx.group((EP_AXIS,))

    def one(t, d):
        if d is None or not isinstance(t, torch.Tensor):
            return t
        parts = [torch.empty_like(t) for _ in range(ep)]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, dim=d)

    return _map(one, tree, dims)


def global_like(tree, dims, ctx: ShardCtx):
    """Empty global-shaped tensors (on the meta device) for a rank's
    tree: the structure and shapes a checkpoint of it holds."""
    ep = _ep_size(ctx)

    def one(t, d):
        if not isinstance(t, torch.Tensor):
            return t
        shape = list(t.shape)
        if d is not None:
            shape[d] *= ep
        return torch.empty(shape, dtype=t.dtype, device="meta")

    return _map(one, tree, dims)


@dataclasses.dataclass(frozen=True, eq=False)
class TreeLayout:
    """How a rank's tree lies over the mesh: ``dims`` (mirroring the
    tree) names each leaf's EP-sliced dim, None for a replicated leaf.
    A checkpoint holds the global tree: rank 0 writes it and the others
    wait (:meth:`barrier`)."""

    ctx: ShardCtx
    dims: Any

    def shard(self, tree):
        return shard_tree(tree, self.dims, self.ctx)

    def gather(self, tree):
        return gather_tree(tree, self.dims, self.ctx)

    def global_like(self, tree):
        return global_like(tree, self.dims, self.ctx)

    @property
    def writer(self) -> bool:
        import torch.distributed as dist

        return dist.get_rank() == 0

    def barrier(self) -> None:
        import torch.distributed as dist

        dist.barrier()


def train_layout(ctx: Optional[ShardCtx], cfg, dispatch: str, state):
    """The layout of a train state under ``ctx``: expert leaves sliced
    over ``model`` when the MoE layers run expert-parallel (sorted
    dispatch, ``moe.ep == "a2a"``, a mesh that can host it), everything
    else replicated. None without a ctx or a process group."""
    if ctx is None or not ctx.groups:
        return None
    from repro_torch.core.moe import ep_active
    from repro_torch.models.model_zoo import param_axes

    if cfg.moe is not None and dispatch == "sorted" \
            and ep_active(ctx, cfg.moe):
        dims = param_ep_dims(param_axes(cfg))
    else:
        dims = _map(lambda _: None, state["params"])
    return TreeLayout(ctx, state_ep_dims(state, dims))
