"""The mesh + rules bundle and the port's explicit layout (port of
``repro/sharding/__init__.py``).

``ShardCtx`` carries the mesh, the two rules tables and a process group
for every set of the mesh's axes: the ``model`` group the
tensor-parallel collectives and the expert-parallel all-to-all run
over, the data axes' groups (FSDP's gathers and scatters, the gradient
sums), the whole mesh. The reference lets GSPMD place every leaf by the
rules; the port's runtime applies the placement explicitly
(:func:`train_layout`): the reference's ``tree_specs(state_axes(cfg))``
— ``embed`` over ``data`` (FSDP), ``heads``, ``kv_heads``, ``mlp``,
``vocab`` and ``expert`` over ``model`` (tensor parallel), tokens over
the data axes, the MoE expert-parallel under ``moe.ep == "a2a"`` —
or, for a ctx whose ``tensor_parallel`` is False with expert
parallelism (sorted dispatch, a mesh ``expert_parallel_layout``
accepts), each expert leaf's ``expert`` dim over ``model`` and every
other leaf replicated, tokens over every axis. A :class:`TreeLayout` holds each
leaf's spec and moves between the global tree and a rank's
(``shard``, ``gather``); ``sharding/comm.py`` holds the collectives a
step computes with. Serving (:func:`serve_layout`) places the weights
by the same param rules, joined over their FSDP dims once (under the
weight-stationary ``serve_tp`` profile the experts' ``mlp`` stays cut
over the data axes), and the static cache and the paged pools by the
act rules (``batch`` over the data axes, ``cache_seq`` or ``kv_heads``
over ``model``); a :class:`ServePlan` on the ctx tells the model code
how its rows, caches and expert blocks lie. The reference's ``act()``
constraints have no counterpart (layout hints that leave the numbers
alone).
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
    """``{axes tuple: this rank's group over those axes}`` for every
    non-empty set of the mesh's axes (in mesh order) that spans more
    than one rank: the ``model`` axis, the others, all of them, and each
    tuple a spec may shard a dim over (``("data",)``, ``("pod",
    "data")``). A group's ranks are sorted, so a rank's place in it is
    its row-major coordinate over the axes. Every rank creates every
    group, in one order (``new_subgroups_by_enumeration`` is
    collective)."""
    import itertools

    import torch.distributed as dist

    names = tuple(mesh_shape(mesh))
    ranks = _mesh_ranks(mesh)
    groups = {}
    for k in range(len(names), 0, -1):
        for axes in itertools.combinations(names, k):
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
    # The model's modules run tensor parallel over ``model`` (the ranks
    # of a ``model`` group hold the same tokens) when True: set by the
    # rules' layout (``train_layout``, ``serve_layout``). None (as
    # ``for_mesh`` builds a ctx) runs no tensor parallelism itself and
    # asks ``train_layout`` for the rules' placement, expert parallelism
    # composed on top where ``ep_active`` holds, as the reference's
    # default rules place it. False asks for the expert-only layout
    # under expert parallelism (``dataclasses.replace(ctx,
    # tensor_parallel=False)``: the expert leaves over ``model``, every
    # other leaf replicated, the ranks holding different tokens).
    tensor_parallel: Optional[bool] = None
    # Set by ``serve_layout``: how a serving step's rows and KV caches lie
    # over the mesh. None in training.
    serve: Optional["ServePlan"] = None

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

    def _order(self, axes) -> tuple:
        return tuple(a for a in self.shape if a in tuple(axes))

    def group(self, axes):
        """This rank's process group over ``axes`` (None when they span
        one rank)."""
        return self.groups.get(self._order(axes))

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        import torch.distributed as dist

        names = list(self.shape)
        pos = (_mesh_ranks(self.mesh) == dist.get_rank()).nonzero()[0]
        return int(pos[names.index(axis)])

    def index(self, axes) -> int:
        """This rank's row-major coordinate over ``axes`` (its block of
        a dim sharded over them, as ``NamedSharding`` places it; its
        rank in :meth:`group`)."""
        i = 0
        for a in self._order(axes):
            i = i * self.shape[a] + self.coord(a)
        return i

    @property
    def tp_size(self) -> int:
        """The tensor-parallel width: the ``model`` axis's size under
        the rules' layout, else 1."""
        if not (self.groups and self.tensor_parallel):
            return 1
        return self.shape.get(EP_AXIS, 1)

    @property
    def tp_group(self):
        return self.group((EP_AXIS,)) if self.tp_size > 1 else None

    @property
    def tp_rank(self) -> int:
        return self.coord(EP_AXIS) if self.tp_size > 1 else 0

    @property
    def token_axes(self) -> tuple:
        return tuple(self.shape)

    @property
    def replica_axes(self) -> tuple:
        """Every axis but ``model``: the axes an expert shard is
        replicated over, and those the rules shard a batch over
        (ACT_RULES ``batch``)."""
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
# a tree's layout over the mesh
# ---------------------------------------------------------------------------


def entry_axes(entry) -> tuple:
    """The mesh axes of one entry of a spec (None, an axis, a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _map(fn, tree, *others):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, *(o[i] for o in others))
                          for i, v in enumerate(tree))
    return fn(tree, *others)


def shard_leaf(t, spec, ctx: ShardCtx):
    """This rank's block of a global tensor (a copy of its own): each
    dim cut to the contiguous block at the rank's row-major coordinate
    over the dim's axes."""
    if not isinstance(t, torch.Tensor) or not any(spec):
        return t
    for d, e in enumerate(spec):
        axes = entry_axes(e)
        if axes:
            n = t.shape[d] // ctx.size(axes)
            t = t.narrow(d, ctx.index(axes) * n, n)
    return t.clone()


def gather_leaf(t, spec, ctx: ShardCtx):
    """The global tensor from every rank's blocks (collective over each
    sharded dim's axes)."""
    import torch.distributed as dist

    if not isinstance(t, torch.Tensor):
        return t
    for d, e in enumerate(spec):
        axes = entry_axes(e)
        if ctx.size(axes) > 1:
            parts = [torch.empty_like(t) for _ in range(ctx.size(axes))]
            dist.all_gather(parts, t.contiguous(), group=ctx.group(axes))
            t = torch.cat(parts, dim=d)
    return t


def global_leaf(t, spec, ctx: ShardCtx):
    """An empty global-shaped tensor (meta device) for a rank's block."""
    if not isinstance(t, torch.Tensor):
        return t
    shape = list(t.shape)
    for d, e in enumerate(spec):
        shape[d] *= ctx.size(entry_axes(e))
    return torch.empty(shape, dtype=t.dtype, device="meta")


def reshard(t, src, dst, ctx: ShardCtx):
    """A rank's block of a tensor laid out by spec ``src`` -> its block
    under spec ``dst`` (no gradient): each dim whose axes differ joined
    over ``src``'s axes, then cut by ``dst``'s."""
    src = tuple(src) + (None,) * (t.dim() - len(src))
    dst = tuple(dst) + (None,) * (t.dim() - len(dst))
    if src == dst:
        return t
    for d, (a, b) in enumerate(zip(src, dst)):
        if entry_axes(a) != entry_axes(b):
            t = gather_leaf(t, (None,) * d + (a,), ctx)
            t = shard_leaf(t, (None,) * d + (b,), ctx)
    return t


def ep_dim(axes: str) -> Optional[int]:
    """The dim of a leaf that the EP layout slices over ``model``: its
    ``expert`` dim when that leads (after the stacked ``layer`` dim) —
    the experts' weights, not the router's ``embed expert``."""
    names = axes.split()
    i = 0
    while i < len(names) and names[i] == "layer":
        i += 1
    return i if i < len(names) and names[i] == "expert" else None


def _dim_spec(d: Optional[int]) -> tuple:
    return () if d is None else (None,) * d + (EP_AXIS,)


def shard_tree(tree, dims, ctx: ShardCtx):
    """This rank's slice of a global tree under the EP layout: each leaf
    with a dim in ``dims`` (int or None) cut to its ``model``
    coordinate's contiguous block; other leaves kept as they are."""
    return _map(lambda t, d: shard_leaf(t, _dim_spec(d), ctx), tree, dims)


def gather_tree(tree, dims, ctx: ShardCtx):
    """The global tree from every rank's EP slices."""
    return _map(lambda t, d: gather_leaf(t, _dim_spec(d), ctx), tree, dims)


def state_axes_of(state, param_axes):
    """Logical axes of a train state (``params``, ``opt_state``,
    ``step``, optional ``residual``) from its params' (the reference's
    ``state_axes``, for any of the port's optimizers): the residual's
    are the params'; Adafactor's ``v_row`` drops a leaf's last name,
    ``v_col`` the one before; other slots (``v``, ``m``) keep the
    leaf's; steps have none."""
    def slots(axes, s):
        names = axes.split()
        pick = {"v_row": names[:-1], "v_col": names[:-2] + names[-1:]}
        return {n: " ".join(pick.get(n, names)) for n in s}

    out = {}
    for k, v in state.items():
        if k in ("params", "residual"):
            out[k] = param_axes
        elif k == "opt_state":
            out[k] = {kk: (_map(slots, param_axes, vv) if kk == "slots"
                           else _map(lambda _: "", vv))
                      for kk, vv in v.items()}
        else:
            out[k] = _map(lambda _: "", v)
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class TreeLayout:
    """How a rank's tree lies over the mesh: ``specs`` (mirroring the
    tree) gives each leaf's spec, the reference's ``PartitionSpec``
    (one entry a dim: None, an axis, or a tuple of axes). Each rank
    holds the contiguous block of every sharded dim at its row-major
    coordinate over the dim's axes, as ``NamedSharding`` places it.
    ``token_axes``: the axes the batch's rows are split over (every
    axis in the expert-only layout, the data axes under the rules). A
    checkpoint holds the global tree: rank 0 writes it and the others
    wait (:meth:`barrier`)."""

    ctx: ShardCtx
    specs: Any
    token_axes: tuple

    def shard(self, tree):
        return _map(lambda t, s: shard_leaf(t, s, self.ctx), tree,
                    self.specs)

    def gather(self, tree):
        return _map(lambda t, s: gather_leaf(t, s, self.ctx), tree,
                    self.specs)

    def global_like(self, tree):
        return _map(lambda t, s: global_leaf(t, s, self.ctx), tree,
                    self.specs)

    def batch_rows(self) -> tuple:
        """(this rank's index, the count) of the batch's row blocks:
        ranks that differ only along ``model`` under the rules take the
        same rows."""
        return self.ctx.index(self.token_axes), \
            self.ctx.size(self.token_axes)

    @property
    def writer(self) -> bool:
        import torch.distributed as dist

        return dist.get_rank() == 0

    def barrier(self) -> None:
        import torch.distributed as dist

        dist.barrier()


def train_layout(ctx: Optional[ShardCtx], cfg, dispatch: str, state):
    """The layout of a train state under ``ctx``, None without a ctx or
    a process group: the reference's placement, ``tree_specs(
    state_axes(cfg), state, mesh, param_rules)`` — with the default
    rules ``embed`` over ``data`` (FSDP), ``heads``, ``kv_heads``,
    ``mlp``, ``vocab`` and ``expert`` over ``model`` (tensor parallel)
    — with tokens split over the data axes and the model's modules
    tensor parallel over ``model``; expert parallelism (a MoE arch,
    sorted dispatch, ``moe.ep == "a2a"``, a mesh that can host it) then
    runs on each peer's block of its data rank's routing groups
    (``core/moe.py``), as ``ShardCtx.for_mesh``'s ctx asks. A ctx whose
    ``tensor_parallel`` is False asks for expert parallelism without
    tensor parallelism: the expert leaves sliced over ``model`` on their
    ``expert`` dim, every other leaf replicated, tokens split over every
    axis."""
    if ctx is None or not ctx.groups:
        return None
    from repro_torch.core.moe import ep_active
    from repro_torch.models.model_zoo import param_axes

    axes = state_axes_of(state, param_axes(cfg))
    if cfg.moe is not None and dispatch == "sorted" \
            and ep_active(ctx, cfg.moe) and ctx.tensor_parallel is False:
        return TreeLayout(ctx, _map(lambda a: _dim_spec(ep_dim(a)), axes),
                          ctx.token_axes)
    return TreeLayout(dataclasses.replace(ctx, tensor_parallel=True),
                      tree_specs(axes, state, ctx.mesh, ctx.param_rules),
                      ctx.replica_axes)


# ---------------------------------------------------------------------------
# serving under the rules
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServePlan:
    """How a serving step's rows and KV caches lie over the mesh.
    ``batch_axes``: the axes the static engine's rows are split over (the
    cache's ``batch`` entry; () when the rows are replicated, as the
    paged engine's always are). ``cache``: how a static cache or the
    paged pools lie over ``model`` — ``"heads"`` (each rank its block of
    the KV heads, every position), ``"seq"`` (``cache_seq``: each rank
    its block of positions, every KV head) or ``"replicated"``.
    ``expert_axes``: the data axes the experts' d_ff (``mlp``) is cut
    over (the weight-stationary ``serve_tp`` placement: each rank holds
    its ``E / m`` experts' block of d_ff and the MoE sums its partial
    outputs over these axes and ``model``); () otherwise."""

    batch_axes: tuple = ()
    cache: str = "heads"
    expert_axes: tuple = ()


def _check_serving_stack(cfg) -> None:
    """Raise for a stack the port does not serve under a mesh: every
    decoder-only and encoder-decoder stack of attention, rwkv and mamba
    mixers serves; an encoder-only one has no serving path."""
    if cfg.structure not in ("decoder_only", "encoder_decoder"):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.structure}): serving runs decoder-only and "
            "encoder-decoder stacks")


def _static_plan(cfg, specs) -> ServePlan:
    """The :class:`ServePlan` of a static cache's specs, checked: every
    layer's cache splits its rows over the same data axes (the
    encoder's states ``enc`` too); an attention layer's k (layer batch
    cache_seq kv_heads head_dim) puts ``cache_seq`` or ``kv_heads`` over
    ``model`` or neither, which sets the plan's cache mode; an rwkv
    layer's WKV state (layer batch heads head_dim head_dim) its heads,
    its ``x_prev`` replicated over ``model``; a mamba layer's conv window
    (layer batch conv mlp) and state (layer batch mlp state) their
    ``d_in`` block (``mlp``)."""
    found = []
    for seg in specs["stack"]["segments"]:
        for pos in seg.values():
            mixer = pos["mixer"]
            key = next(k for k in ("k", "wkv", "ssm") if k in mixer)
            spec = tuple(mixer[key]) + (None,) * 5
            batch = entry_axes(spec[1])
            if key == "k":
                inner = (("cache_seq", entry_axes(spec[2])),
                         ("kv_heads", entry_axes(spec[3])))
            elif key == "wkv":
                inner = (("heads", entry_axes(spec[2])),)
            else:
                inner = (("mlp", entry_axes(spec[2])),)
            for name, axes in inner:
                if axes and axes != (EP_AXIS,):
                    raise ValueError(
                        f"{cfg.name}: the static cache's {name} over "
                        f"{axes} (spec {mixer[key]}) is not a placement "
                        "the port serves (model alone or nothing)")
            found.append((key, batch, dict(inner)))
    if "enc" in specs:
        found.append(("enc", entry_axes((tuple(specs["enc"]) + (None,))[0]),
                      {}))
    batch = found[0][1]
    for key, b, _ in found:
        if EP_AXIS in b:
            raise ValueError(
                f"{cfg.name}: the static cache's batch over {b} (its "
                f"{key!r}): rows over model are not served")
        if b != batch:
            raise ValueError(
                f"{cfg.name}: the static cache's leaves split the batch "
                f"over {batch} and {b}: one placement of the rows serves")
    mode = "replicated"
    for key, _, inner in found:
        if key == "k":
            mode = ("seq" if inner["cache_seq"] else "heads"
                    if inner["kv_heads"] else "replicated")
            break
        if key == "wkv" and inner["heads"]:
            mode = "heads"
    return ServePlan(batch, mode)


def _walk(fn, tree, *others, path=()):
    """``fn(leaf, *other leaves, path, parent dict)`` over a tree of
    dicts and lists (``others`` mirror it; their leaves may be
    tuples)."""
    if isinstance(tree, dict):
        return {k: (_walk(fn, v, *(o[k] for o in others), path=path + (k,))
                    if isinstance(v, (dict, list))
                    else fn(v, *(o[k] for o in others), path + (k,), tree))
                for k, v in tree.items()}
    return [_walk(fn, v, *(o[i] for o in others), path=path + (i,))
            for i, v in enumerate(tree)]


@dataclasses.dataclass(frozen=True, eq=False)
class ServeLayout:
    """A serving engine's placement (:func:`serve_layout`): ``ctx`` (the
    tensor-parallel ctx with the :class:`ServePlan` the model code
    reads), ``specs`` (each parameter's spec under the param rules),
    ``cache_specs`` (the cache's, None without one) and the global
    parameters on the meta device (``shapes``)."""

    ctx: ShardCtx
    cfg: Any
    specs: Any
    shapes: Any
    cache_specs: Any = None

    def for_cache(self, cache, *, paged: bool = False) -> "ServeLayout":
        """This layout with a cache's placement: a static cache
        (``zoo.serve_cache_axes`` under the act rules) or, ``paged``,
        the KV block pools (``kv_heads`` over ``model``). ``cache``
        holds global shapes (the meta device will do)."""
        from repro_torch.models.param import tree_map

        cfg, ctx = self.cfg, self.ctx
        m = ctx.shape.get(EP_AXIS, 1)
        if paged:
            Kh = cfg.n_kv_heads
            if m > 1 and Kh % m:
                raise ValueError(
                    f"{cfg.name}: the paged pools (P, bs, Kh, dh) hold "
                    f"each rank's KV heads, but {Kh} KV heads do not split "
                    f"over {m} model ranks")
            spec = (None, None, None, EP_AXIS) if m > 1 else ()
            specs = tree_map(lambda _: spec, cache)
            plan = ServePlan((), "heads" if m > 1 else "replicated")
        else:
            from repro_torch.models.model_zoo import serve_cache_axes

            specs = tree_specs(serve_cache_axes(cfg), cache, ctx.mesh,
                               ctx.act_rules)
            plan = _static_plan(cfg, specs)
        plan = dataclasses.replace(plan, expert_axes=ctx.serve.expert_axes)
        return dataclasses.replace(
            self, cache_specs=specs,
            ctx=dataclasses.replace(ctx, serve=plan))

    def join(self, params):
        """The global tree of ``params``, each leaf the global tensor or
        this rank's block under its spec (``train_layout``'s placement):
        blocks gathered over their axes, global leaves kept as they
        are."""
        def leaf(t, spec, g, path, parent):
            if tuple(t.shape) == tuple(g.shape):
                return t
            return gather_leaf(t, spec, self.ctx)

        return _walk(leaf, params, self.specs, self.shapes)

    def place(self, params, *, device=None):
        """The parameters this rank serves with, from the global tree or
        its blocks (:meth:`join`), one leaf at a time (a leaf's blocks
        joined, cut, and the joined leaf dropped before the next, so the
        rank never holds the whole model; each leaf moved to ``device``
        where given): every dim over ``model`` cut to the rank's block
        where its module runs tensor parallel (``comm._tensor_parallel``:
        attention, the FFNs, the embedding table and the head; in
        serving also the rwkv time mix's heads), whole elsewhere; an
        expert leaf's ``mlp`` dim over the data axes (``serve_tp``) cut
        to the rank's block; every other dim over the data axes (FSDP)
        joined, once. A leaf handed over as the rank's block of what it
        keeps is kept as it is: under ``serve_tp`` (``embed: ()``) the
        blocks join nothing over the data axes. The joins are counted
        (``comm.COUNTS``: ``fsdp_all_gather`` over the data axes,
        ``model_all_gather`` over ``model``). A mamba mixer's leaves are
        cut to the rank's block of ``d_in`` (``models/ssm.tp_block``;
        ``in_proj``'s two halves each cut) where ``d_in`` splits over
        ``model``. A MoE router stays whole: every peer routes alike, so
        its logits need no gather a step."""
        from repro_torch.models.ssm import INNER_DIM, tp_block
        from repro_torch.sharding.comm import _tensor_parallel

        ctx = self.ctx
        m = ctx.shape.get(EP_AXIS, 1)
        r = ctx.index((EP_AXIS,)) if m > 1 else 0
        d_in = (self.cfg.ssm.expand * self.cfg.d_model
                if self.cfg.ssm is not None else 0)
        ws = ctx.serve.expert_axes if ctx.serve is not None else ()

        def mamba(path, parent):
            return "A_log" in parent and path[-1] in INNER_DIM

        def kept(spec, path, parent):
            """The entries of ``spec`` the rank keeps cut."""
            out = []
            for e in spec:
                a = entry_axes(e)
                if m > 1 and a == (EP_AXIS,) and "router" not in path \
                        and not mamba(path, parent) \
                        and _tensor_parallel(path, parent, serving=True):
                    out.append(e)
                elif a and a == ws and "experts" in path:
                    out.append(e)
                else:
                    out.append(None)
            return tuple(out)

        def leaf(t, spec, g, path, parent):
            keep = kept(spec, path, parent)
            if tuple(t.shape) != tuple(g.shape):
                if keep == tuple(spec):
                    keep = ()  # already the rank's block
                else:
                    t = _join(t, spec, ctx)
            whole = t
            if mamba(path, parent):
                if m > 1 and d_in % m == 0:
                    t = tp_block(path[-1], t, r, m)
            else:
                t = shard_leaf(t, keep, ctx) if any(keep) else t
            if device is not None:
                t = t.to(device)
            # A block is a copy of its own (one copy, to the device, where
            # the leaf lies elsewhere), so that the joined leaf is freed.
            if t is not whole and t._base is not None:
                t = t.clone()
            return t

        return _walk(leaf, params, self.specs, self.shapes)

    def alloc(self, cache, *, device=None):
        """Zeros of this rank's block of every leaf of a global cache
        (meta tensors will do) under :attr:`cache_specs`."""
        def leaf(t, spec, path, parent):
            shape = list(t.shape)
            for d, e in enumerate(spec):
                shape[d] //= self.ctx.size(entry_axes(e))
            return torch.zeros(shape, dtype=t.dtype, device=device)

        return _walk(leaf, cache, self.cache_specs)

    def shard_cache(self, cache):
        """This rank's block of a global cache (e.g. one process's
        pools)."""
        return _map(lambda t, s: shard_leaf(t, s, self.ctx), cache,
                    self.cache_specs)

    def rows(self) -> tuple:
        """(this rank's index, the count) of the static batch's row
        blocks."""
        axes = self.ctx.serve.batch_axes
        return self.ctx.index(axes), self.ctx.size(axes)


def _join(t, spec, ctx):
    """A rank's block of a leaf joined over every sharded dim (counted:
    ``fsdp_all_gather`` over data axes, ``model_all_gather`` over
    ``model``)."""
    from repro_torch.sharding import comm

    for d, e in enumerate(spec):
        axes = entry_axes(e)
        if ctx.size(axes) > 1:
            t = gather_leaf(t, (None,) * d + (e,), ctx)
            comm._count("model_all_gather" if EP_AXIS in axes
                        else "fsdp_all_gather", t)
    return t


def _check_param_specs(cfg, axes, specs) -> tuple:
    """The data axes the experts' d_ff is cut over (``ServePlan.
    expert_axes``; () outside ``serve_tp``'s placement). Raise where the
    rules place a weight the port cannot serve with: a dim over
    ``model`` together with another axis, or a dim over a data axis
    other than the FSDP ``embed`` and an expert leaf's ``mlp`` whose
    ``expert`` dim lies over ``model`` (``serve_tp``'s weight-stationary
    experts)."""
    found = set()

    def leaf(ax, spec, path, parent):
        names = ax.split()
        for d, e in enumerate(spec):
            a = entry_axes(e)
            if not a or a == (EP_AXIS,) or (EP_AXIS not in a
                                             and names[d] == "embed"):
                continue
            if EP_AXIS not in a and names[d] == "mlp" and "expert" in names \
                    and entry_axes(spec[names.index("expert")]) \
                    == (EP_AXIS,):
                found.add(a)
                continue
            raise ValueError(
                f"{cfg.name}: {'/'.join(map(str, path))} ({ax}) has spec "
                f"{spec}: its {names[d]} dim over {a} is not a placement "
                "the port serves with (weights are joined over their "
                "FSDP embed dims and cut over model, the experts' mlp "
                "also over the data axes)")

    _walk(leaf, axes, specs)
    if len(found) > 1:
        raise ValueError(f"{cfg.name}: the experts' mlp lies over "
                         f"{sorted(found)}: one placement serves")
    return found.pop() if found else ()


def serve_layout(ctx: ShardCtx, cfg, params=None, cache=None, *,
                 paged: bool = False) -> ServeLayout:
    """The serving counterpart of :func:`train_layout`: the weights by
    ``model_zoo.param_axes`` under ``ctx.param_rules``, and with
    ``cache`` the static cache by ``model_zoo.serve_cache_axes`` under
    ``ctx.act_rules`` (``batch`` over the data axes, ``cache_seq`` over
    ``model``, or ``kv_heads`` where ``max_len`` does not divide) or,
    ``paged``, the pools with ``kv_heads`` over ``model``
    (:meth:`ServeLayout.for_cache`). ``params``, where given, must hold
    each leaf global or as the rank's block under its spec (else
    ``ValueError``); :meth:`ServeLayout.place` gives the rank's. The
    model runs under ``layout.ctx`` (tensor parallel, with the
    :class:`ServePlan`). Decoder-only and encoder-decoder stacks of
    attention, rwkv and mamba mixers (``NotImplementedError`` for an
    encoder-only one): a mamba layer's leaves by ``param_axes`` and its
    caches by ``serve_cache_axes`` (``batch`` over data, ``mlp``, its
    ``d_in``, over model), an encoder-decoder's encoder states
    ``cache["enc"]`` as ``"batch seq embed"`` (the rank's rows). Under
    the weight-stationary ``serve_tp`` profile (``launch/specs.py``)
    an expert leaf's ``expert`` dim lies over ``model`` and its ``mlp``
    over the data axes: the plan's ``expert_axes``. A
    placement the port cannot run raises ``ValueError`` naming the leaf
    and its spec. Needs no process group."""
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models.param import axes_of, tree_map

    _check_serving_stack(cfg)
    shapes = zoo.init_params(None, cfg, device="meta")
    axes = tree_map(axes_of, shapes)
    specs = tree_specs(axes, shapes, ctx.mesh, ctx.param_rules)
    plan = ServePlan(expert_axes=_check_param_specs(cfg, axes, specs))
    layout = ServeLayout(
        dataclasses.replace(ctx, tensor_parallel=True, serve=plan),
        cfg, specs, shapes)
    if params is not None:
        def check(t, spec, g, path, parent):
            block = [n // ctx.size(entry_axes(e)) for n, e in
                     zip(g.shape, tuple(spec) + (None,) * g.dim())]
            if list(t.shape) not in (list(g.shape), block):
                raise ValueError(
                    f"{cfg.name}: {'/'.join(map(str, path))} has shape "
                    f"{tuple(t.shape)}: neither the global {tuple(g.shape)}"
                    f" nor its block {tuple(block)} under spec {spec}")

        _walk(check, params, specs, shapes)
    if cache is not None:
        layout = layout.for_cache(cache, paged=paged)
    return layout
