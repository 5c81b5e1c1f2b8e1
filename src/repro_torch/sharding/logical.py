"""Logical-axis -> mesh-axis sharding rules engine (port of
``repro/sharding/logical.py``).

t5x/MaxText-style: every tensor dim carries a logical axis name; a rules
table maps each name to an ordered list of mesh-axis *candidates* (each
candidate is a tuple of mesh axes the dim may be sharded over). A
candidate applies only if (a) all its axes exist in the mesh, (b) none
is already used by another dim of the same tensor, and (c) the dim size
is divisible by the candidate's total device count. First applicable
candidate wins; otherwise the dim is replicated. This divisibility
fallback is what lets one rules table serve every arch (e.g. grok's E=8
experts cannot shard over a 16-wide ``model`` axis -> falls back to
expert-tensor parallelism; granite's vocab 49155 is odd -> embedding
shards over ``embed`` instead).

Two tables: PARAM_RULES (weights; ``embed`` is the FSDP dim) and
ACT_RULES (activations; only batch/seq/expert dims shard).

A mesh argument is anything with axis names and sizes: a
``torch.distributed.device_mesh.DeviceMesh`` or a plain ``{name: size}``
mapping (the rules need no processes). A spec is a tuple in the
reference's canonical ``PartitionSpec`` form — one entry per dim, an
axis name, a tuple of names or None, trailing Nones trimmed;
:func:`placements_for` maps it to DTensor placements. The reference's
``constrain`` (a GSPMD layout hint that leaves the numbers alone) has no
counterpart: the port's layout is explicit (``sharding/__init__.py``).
"""
from __future__ import annotations

from typing import Mapping, Sequence

Candidate = tuple[str, ...]
Rules = Mapping[str, Sequence[Candidate]]

# Weights. Order of dict entries is irrelevant; per-tensor assignment is
# greedy left-to-right over the tensor's dims.
PARAM_RULES: Rules = {
    "layer": (),  # stacked layer dim: never sharded
    "expert": (("model",),),
    "mlp": (("model",),),
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "vocab": (("model",),),
    "embed": (("data",),),  # FSDP / ZeRO-3 dim
    "head_dim": (),
    "state": (),
    "conv": (),
    "pos": (),
    "_": (),
}

# Activations / inputs / caches.
ACT_RULES: Rules = {
    "batch": (("pod", "data"), ("data",)),
    "seq": (),
    "embed": (),
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "head_dim": (),
    "mlp": (("model",),),
    "expert": (("model",),),
    "cap": (),
    "vocab": (("model",),),
    # KV caches: shard the time dim over `model` (sequence parallelism
    # for decode); falls back to replication for short caches.
    "cache_seq": (("model",),),
    "state": (),
    "layer": (),
    "conv": (),
    "pos": (),
    "_": (),
}


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a DeviceMesh or a mapping, in mesh
    order."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def make_rules(
    mesh,
    *,
    params: bool,
    fsdp_over_pod: bool = False,
    overrides: Mapping[str, Sequence[Candidate]] | None = None,
    dp_only: bool = False,
) -> Rules:
    """Build a rules table for a mesh.

    ``dp_only`` gives the paper-faithful baseline: weights replicated
    (expert partitioning only), activations batch-sharded.
    ``fsdp_over_pod`` extends weight FSDP across the pod axis
    (beyond-paper; default off so cross-pod traffic stays pure-DP
    gradient reduction).
    """
    base = dict(PARAM_RULES if params else ACT_RULES)
    if params:
        if dp_only:
            base["embed"] = ()
        elif fsdp_over_pod and "pod" in mesh_shape(mesh):
            base["embed"] = (("pod", "data"), ("data",))
    if overrides:
        base.update(overrides)
    return base


# The mesh axis the sorted-dispatch expert-parallel all-to-all runs
# over. Matches PARAM_RULES["expert"]: expert weights live on `model`,
# so the EP path keeps them resident and moves tokens instead.
EP_AXIS = "model"


def expert_parallel_layout(mesh, num_experts: int):
    """EP layout for the sorted-dispatch all-to-all (core/ep.py), or
    ``None`` when the mesh cannot host it (no ``model`` axis, axis of
    size 1, or experts not divisible — the same graceful-fallback
    discipline as the rules engine).

    Returns ``(ep_axis, ep_size, token_axes)``: the a2a axis, its device
    count, and the full tuple of mesh axes the token-group dim shards
    over (every device owns a distinct token shard; expert weights are
    sharded over ``ep_axis`` and replicated over the rest).
    """
    if mesh is None:
        return None
    sizes = mesh_shape(mesh)
    if EP_AXIS not in sizes:
        return None
    ep = sizes[EP_AXIS]
    if ep <= 1 or num_experts % ep:
        return None
    return EP_AXIS, ep, tuple(sizes)


def spec_for(logical: str, shape: tuple[int, ...], mesh,
             rules: Rules) -> tuple:
    """Spec for one tensor given its space-joined logical axes."""
    names = logical.split() if logical else []
    if len(names) != len(shape):
        raise ValueError(f"logical {logical!r} does not match shape {shape}")
    used: set[str] = set()
    out: list = []
    axis_sizes = mesh_shape(mesh)
    for name, dim in zip(names, shape):
        assigned = None
        for cand in rules.get(name, ()):  # type: ignore[arg-type]
            if not all(a in axis_sizes for a in cand):
                continue
            if any(a in used for a in cand):
                continue
            total = 1
            for a in cand:
                total *= axis_sizes[a]
            if total == 0 or dim % total != 0:
                continue
            assigned = cand
            used.update(cand)
            break
        if assigned is None:
            out.append(None)
        elif len(assigned) == 1:
            out.append(assigned[0])
        else:
            out.append(tuple(assigned))
    # Trim trailing Nones (canonical form).
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def placements_for(spec: tuple, mesh) -> tuple:
    """DTensor placements of a spec: per mesh dim, ``Shard(tensor dim)``
    of the dim it shards, else ``Replicate()``. A dim sharded over a
    tuple of mesh axes shards over each of them in order."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(mesh_shape(mesh))
    names = list(mesh_shape(mesh))
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry,) if isinstance(entry, str) else entry:
            out[names.index(axis)] = Shard(dim)
    return tuple(out)


def _tree_map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _tree_map2(fn, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_tree_map2(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def tree_specs(axes_tree, shapes_tree, mesh, rules: Rules):
    """(axes-string tree, shape tree) -> spec tree. ``shapes_tree``
    leaves may be tensors or shape tuples."""

    def one(axes: str, shaped):
        shape = shaped if isinstance(shaped, tuple) else tuple(shaped.shape)
        return spec_for(axes, shape, mesh, rules)

    return _tree_map2(one, axes_tree, shapes_tree)


def tree_placements(axes_tree, shapes_tree, mesh, rules: Rules):
    """(axes-string tree, shape tree) -> DTensor placements tree."""
    return _tree_map2(lambda a, s: placements_for(
        spec_for(a, s if isinstance(s, tuple) else tuple(s.shape),
                 mesh, rules), mesh), axes_tree, shapes_tree)
