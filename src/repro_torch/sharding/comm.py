"""The collectives of the rules engine's placement, as autograd functions
over a ``ShardCtx``'s process groups (the counterpart of what GSPMD
inserts for the reference's ``NamedSharding``s).

Under the rules (``sharding.train_layout``) a rank holds the block of
every leaf that its spec gives it: ``embed`` over the data axes (FSDP),
``heads``, ``kv_heads``, ``mlp``, ``vocab`` and ``expert`` over
``model`` (tensor parallel). The ranks of one ``model`` group hold the
same tokens (a data rank's rows), so the activations between layers are
replicated over ``model``:

* :func:`gather_fsdp` — all-gather over the data axes forward,
  reduce-scatter backward: a weight's FSDP blocks joined before use on
  tokens that differ from rank to rank (its gradient summed over them);
* :func:`copy_to_model` — identity forward, all-reduce over ``model``
  backward: the input of a column-parallel product (each peer's
  gradient of it is partial);
* :func:`reduce_from_model` — all-reduce forward, identity backward:
  the output of a row-parallel product or of a local-experts partial
  sum;
* :func:`gather_replicated` — all-gather forward, the rank's block of
  the gradient backward: a computation every ``model`` peer repeats
  identically (the router's logits; a weight whose module runs no
  tensor parallelism); :func:`gather_blocks` over any axes (the
  expert-parallel MoE's outputs, each peer having computed its block
  of the groups);
* :func:`reduce_over` — all-reduce over any axes (serving, no
  gradient): the weight-stationary MoE's partial outputs, each rank's
  ``E / m`` experts' block of d_ff, summed over the data axes and
  ``model`` (``expert_all_reduce``).

:func:`params_for_compute` applies them to a rank's params at the top of
a step. Gloo has no reduce-scatter: on a gloo group it is built from
an all-to-all (each rank's blocks sent to their owners, who add them
in rank order; ``_reduce_scatter``); all-gather and all-reduce are
gloo's own. Gloo stages CUDA tensors through host memory. Each
collective adds its payload bytes (an all-gather's output, a
reduce-scatter's input, an all-reduce's tensor, an all-to-all's input)
to :data:`COUNTS` under its kind (``core/ep.py``'s all-to-alls as
``ep_all_to_all``); ``launch/dryrun.rules_collective_payloads`` models
the same sums.
"""
from __future__ import annotations

import torch

KINDS = ("fsdp_all_gather", "fsdp_reduce_scatter", "tp_all_reduce",
         "router_all_gather", "model_all_gather", "cache_all_gather",
         "softmax_combine", "row_all_gather", "logits_all_gather",
         "ep_all_to_all", "ep_all_gather", "expert_all_reduce")
COUNTS = dict.fromkeys(KINDS, 0)
# The backend whose reduce-scatter :func:`_reduce_scatter` builds: None
# reads the group's; the dry run's rank step, on a "fake" group
# (``launch/dryrun.rank_memory``), names the one it models.
TRANSPORT = None


def reset_counts() -> None:
    for k in KINDS:
        COUNTS[k] = 0


def counts() -> dict:
    return dict(COUNTS)


def _count(kind: str, t: torch.Tensor) -> None:
    COUNTS[kind] += t.numel() * t.element_size()


def _all_gather(x, dim: int, group, n: int):
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _all_reduce(x, group, op: str = "sum"):
    import torch.distributed as dist

    out = x.contiguous().clone()
    dist.all_reduce(out, op={"sum": dist.ReduceOp.SUM,
                             "max": dist.ReduceOp.MAX}[op], group=group)
    return out


def _reduce_scatter(x, dim: int, group, n: int):
    """The rank's block along ``dim`` of the sum over ``group``. Gloo has
    no reduce-scatter: there each rank's blocks go to their owners by
    one all-to-all and the owner adds them in rank order."""
    import torch.distributed as dist

    k = x.shape[dim] // n
    inp = x.movedim(dim, 0).contiguous()
    if (TRANSPORT or dist.get_backend(group)) == "gloo":
        got = torch.empty_like(inp)
        dist.all_to_all_single(got, inp, group=group)
        out = got.reshape(n, k, *inp.shape[1:]).sum(0)
    else:
        out = inp.new_empty((k, *inp.shape[1:]))
        dist.reduce_scatter_tensor(out, inp, group=group)
    return out.movedim(0, dim).contiguous()


class _GatherFSDP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        out = _all_gather(x, dim, group, n)
        _count("fsdp_all_gather", out)
        return out

    @staticmethod
    def backward(ctx, g):
        _count("fsdp_reduce_scatter", g)
        return _reduce_scatter(g, ctx.dim, ctx.group, ctx.n), None, None, \
            None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _count("tp_all_reduce", g)
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        _count("tp_all_reduce", x)
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, kind):
        import torch.distributed as dist

        ctx.dim, ctx.k = dim, x.shape[dim]
        ctx.r = dist.get_rank(group)
        out = _all_gather(x, dim, group, n)
        _count(kind, out)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.r * ctx.k, ctx.k).contiguous(), None,
                None, None, None)


def gather_fsdp(x, dim: int, group, n: int):
    """``x``'s blocks along ``dim`` joined over ``group`` (``n`` ranks,
    in rank order); the backward sums the gradient over the group and
    keeps the rank's block. ``x`` itself when ``group`` is None."""
    return x if group is None else _GatherFSDP.apply(x, dim, group, n)


def copy_to_model(x, ctx):
    """Identity; the gradient all-reduced over ``ctx``'s ``model``
    group."""
    g = ctx.tp_group
    return x if g is None else _CopyToModel.apply(x, g)


def reduce_from_model(x, ctx):
    """``x`` summed over ``ctx``'s ``model`` group; the gradient passes
    as it is."""
    g = ctx.tp_group
    return x if g is None else _ReduceFromModel.apply(x, g)


def max_over_model(x, ctx):
    """The elementwise max over ``model`` (no gradient: the caller
    subtracts it where it cancels, as a softmax's shift)."""
    g = ctx.tp_group
    if g is None:
        return x
    _count("tp_all_reduce", x)
    return _all_reduce(x.detach(), g, "max")


def gather_replicated(x, dim: int, ctx, kind: str = "router_all_gather"):
    """The ``model`` peers' blocks of ``x`` joined along ``dim``, for a
    computation every peer repeats identically; the backward keeps the
    rank's block of the (identical) gradient."""
    g = ctx.tp_group
    if g is None:
        return x
    return _GatherReplicated.apply(x, dim, g, ctx.tp_size, kind)


def gather_blocks(x, dim: int, ctx, axes, kind: str):
    """The blocks of ``x`` along ``dim`` held by the ranks over
    ``axes``, joined in their row-major order; the backward keeps the
    rank's block of the gradient, which every rank holds whole (no
    sum). ``x`` itself over one rank."""
    n = ctx.size(axes)
    if n == 1:
        return x
    return _GatherReplicated.apply(x, dim, ctx.group(axes), n, kind)


def gather_rows(x, ctx, axes, kind: str):
    """The blocks of ``x`` along dim 0 held by the ranks over ``axes``,
    joined in their row-major order (no gradient; ``x`` itself over one
    rank)."""
    n = ctx.size(axes)
    if n == 1:
        return x
    out = _all_gather(x, 0, ctx.group(axes), n)
    _count(kind, out)
    return out


def reduce_over(x, ctx, axes, kind: str):
    """``x`` summed over the ranks of ``axes`` (no gradient; ``x`` itself
    over one rank)."""
    if ctx.size(axes) == 1:
        return x
    _count(kind, x)
    return _all_reduce(x, ctx.group(axes))


# ---------------------------------------------------------------------------
# the params a step computes with
# ---------------------------------------------------------------------------

ATTENTION_KEYS = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
# The rwkv time mix's per-head leaves (a dict with ``w_lora_a``).
RWKV_HEAD_KEYS = ("wr", "wk", "wv", "wg", "u", "wo")


def _tensor_parallel(path: tuple, parent: dict,
                     serving: bool = False) -> bool:
    """Whether the module owning the leaf at ``path`` runs tensor
    parallel on its ``model`` blocks: attention (a dict with ``wq``),
    every FFN (``ffn``: the MLP, the router and the experts), the
    embedding table (vocab-parallel lookup) and the head; ``serving``
    also the rwkv time mix over its heads (``models/rwkv.py``; its
    training step joins them)."""
    if "ffn" in path or path in (("embed", "tokens"), ("head", "w")):
        return True
    if serving and "w_lora_a" in parent and path[-1] in RWKV_HEAD_KEYS:
        return True
    return "wq" in parent and path[-1] in ATTENTION_KEYS


def params_for_compute(params, specs, ctx):
    """A rank's params as the step computes with them: every dim over
    the data axes joined (:func:`gather_fsdp`); a dim over ``model``
    kept as the rank's block where its module runs tensor parallel
    (:func:`_tensor_parallel`), else joined (:func:`gather_replicated`,
    every peer repeating the module). The modules read their blocks'
    sizes off the shapes, against the config's."""
    from repro_torch.sharding import EP_AXIS, entry_axes

    def leaf(t, spec, path, parent):
        for d, e in enumerate(spec):
            axes = entry_axes(e)
            if not axes:
                continue
            if EP_AXIS not in axes:
                t = gather_fsdp(t, d, ctx.group(axes), ctx.size(axes))
            elif len(axes) > 1:
                raise NotImplementedError(
                    f"{'/'.join(map(str, path))}: a dim over {axes} "
                    "(model with other axes) is not placed by the rules")
            elif not _tensor_parallel(path, parent):
                t = gather_replicated(t, d, ctx, "model_all_gather")
        return t

    def walk(tree, spec, path):
        if isinstance(tree, dict):
            return {k: (walk(v, spec[k], path + (k,))
                        if isinstance(v, (dict, list))
                        else leaf(v, spec[k], path + (k,), tree))
                    for k, v in tree.items()}
        return [walk(v, s, path + (i,)) for i, (v, s) in
                enumerate(zip(tree, spec))]

    return walk(params, specs, ())
