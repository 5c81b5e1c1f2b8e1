"""Dry run: every (architecture x input shape x mesh) cell built and run
once on the meta device, with no allocation, giving the roofline's raw
terms a device (port of ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch granite-moe-1b-a400m --shape train_4k --mesh pod \\
        --profile optimized
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # every
        cell in this process; writes artifacts/dryrun_torch/*.json

The reference lowers and compiles each cell for 512 forced host devices
and reads XLA's memory and cost analyses and the partitioned HLO. The
port builds the cell (``launch/specs.py``) and runs its step once on the
meta device under ``launch/flops.step_cost``: the aten products are
FlopCounterMode's, the kernels' FLOPs and bytes come from their work
models through the shape-only route (``kernels/ops.py``), the flash
kernels' among them (the counterpart of ``pallas_model.py``'s modelled
attention traffic; its XLA-path half has none). Where the data decides
the work (the grouped kernels' valid rows), the meta route counts the
capacity-full bound, so the card's counted work is at most the dry
run's. No XLA runs: only the rank step below needs a process of its
own, for its process group.

Per device: the step is the global one, so FLOPs and bytes are the
mesh's, divided evenly over its devices. ``memory.argument_bytes`` is
exact: each input leaf's bytes over its shard factor under the rules'
placement on the mesh (``sharding.spec_for``; the reference's
``argument_size_in_bytes``). The rest of ``memory`` comes from a second
run, rank 0's own step (:func:`rank_memory`): in a process of its own,
started by spawn (so that no process group is left in the caller),
under a "fake" process group whose world is the mesh's size, its state
and batch cut to its blocks by the rules' placement
(``specs.build_cell(rank=True)``), counted by ``launch/memory.py``'s
live-bytes tracker on the meta device: ``temp_bytes``, ``output_bytes``,
``total_bytes`` = ``peak_bytes`` (the reference's sum of arguments,
temporaries and outputs), ``fits_hbm`` (the reference's ``fits_16g``
against the card's HBM) and ``at_peak`` (the largest live groups at the
peak). The rank's arguments must equal ``argument_bytes``. The kernels'
shape-only routes allocate the scratch their CUDA wrappers allocate;
where the data decides a kernel's work the buffers are the static ones
on both devices. The fake group's collectives move nothing; a
reduce-scatter is built as NCCL's (:func:`rank_memory`'s
``transport="gloo"``: as gloo's, from an all-to-all, as the smoke's
ranks run it).

``collective_bytes_per_device`` models the collectives the port's
runtime runs: under expert parallelism the gradient all-reduce
and the all-to-alls of ``core/ep.py``, whose buffers are static
(:func:`ep_a2a_bytes`); otherwise the rules' placement
(:func:`rules_collective_payloads`): the FSDP all-gathers and
reduce-scatters over the data axes, the tensor-parallel all-reduces over
``model``, the router's all-gathers and the gradient all-reduce over
the data axes. A prefill or decode cell runs the static engine's step
under the cell's ctx; its collectives are those of serving under the
rules (:func:`serve_collective_payloads`): the weights are joined once
when an engine is built, so a step moves only its activations.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback


def argument_bytes(args, axes, ctx, kind: str) -> dict:
    """Bytes a device of each input (params or train state, batch,
    serve cache; mirroring the ``args`` and ``info["axes"]`` of a
    cell of ``kind``):
    each leaf's bytes over the product of the mesh axes its spec shards
    it over, under the param rules for the parameters and the train
    state and the activation rules for the rest."""
    import torch

    from repro_torch.sharding import mesh_shape, spec_for

    sizes = mesh_shape(ctx.mesh)

    def tree_bytes(tree, ax, rules) -> int:
        if isinstance(tree, torch.Tensor):
            spec = spec_for(ax, tuple(tree.shape), ctx.mesh, rules)
            shards = math.prod(sizes[a] for e in spec if e is not None
                               for a in ((e,) if isinstance(e, str) else e))
            return tree.numel() * tree.element_size() // shards
        if isinstance(tree, dict):
            return sum(tree_bytes(tree[k], ax[k], rules) for k in tree)
        if isinstance(tree, (list, tuple)):
            return sum(tree_bytes(t, a, rules) for t, a in zip(tree, ax))
        return 0  # host ints (a decode step's index)

    names = {"train": ("state", "batch"), "prefill": ("params", "batch"),
             "decode": ("params", "tokens", "cache", "index")}[kind]
    out = {}
    for name, a, ax in zip(names, args, axes):
        rules = ctx.param_rules if name in ("state", "params") \
            else ctx.act_rules
        out[name] = tree_bytes(a, ax, rules)
    out["total"] = sum(out.values())
    return out


def ep_a2a_bytes(cfg, *, tokens_per_rank: int, ep: int,
                 itemsize: int) -> dict:
    """Bytes one rank sends through the expert-parallel all-to-alls of
    ONE MoE layer (``core/ep.sorted_dispatch_ep``), whose buffers are
    static: ``ep * budget`` rows, ``budget`` the ``ep_row_budget`` of the
    rank's assignments. Forward: the token rows (d in ``itemsize``),
    their local expert ids (int32) and the returned rows; backward: the
    two row buffers again."""
    from repro_torch.core.ep import ep_row_budget
    from repro_torch.core.routing import capacity
    from repro_torch.kernels.grouped_mlp import ROW_BLOCK

    moe = cfg.moe
    g = min(moe.group_size, tokens_per_rank)
    groups = -(-tokens_per_rank // g)
    if moe.router == "expert_choice":
        per_group = moe.num_experts * capacity(g, moe)
    else:
        per_group = g * (1 if moe.router == "switch" else moe.top_k)
    rows = ep * ep_row_budget(groups * per_group, ep, moe.ep_budget_factor,
                              ROW_BLOCK)
    row = 2 * rows * cfg.d_model * itemsize
    return {"forward": row + 4 * rows, "backward": row}


def _moe_tp_payloads(cfg, moe, n: int, m: int, dispatch: str,
                     router: str, it: int) -> tuple:
    """(forward all-reduce, backward all-reduce, router all-gather)
    payload bytes of one MoE layer under tensor parallelism
    (``core/moe``): the partial outputs' sum; the input's and the
    combine weights' gradients; the sharded router's logits (float32)."""
    from repro_torch.core.routing import capacity

    E = moe.num_experts
    g = min(moe.group_size, n)
    G = -(-n // g)
    rows = G * g * cfg.d_model * it
    bwd = rows
    if dispatch != "sorted" or router == "expert_choice":
        bwd += G * E * capacity(g, moe) * 4  # the slot tables' weights
    else:
        k = 1 if router == "switch" else moe.top_k
        bwd += G * g * k * 4  # the assignments' weights
    return rows, bwd, (G * g * E * 4 if E % m == 0 else 0)


def serve_collective_payloads(cfg, *, mesh, kind: str, tokens: int,
                              itemsize: int, batch: int = 0,
                              cache_len: int = 0, logits_rows: int = 0,
                              enc_len: int = 0, ring: bool = False,
                              param_rules=None,
                              pad_heads_multiple: int = 0) -> dict:
    """Payload bytes a rank moves through each kind of collective of one
    serving step under ``sharding.serve_layout`` (the sums
    ``comm.COUNTS`` keeps; an all-gather's output, an all-reduce's
    tensor). ``kind`` "prefill" or "decode": the static engine's step
    over ``batch`` rows of ``tokens // batch`` tokens and a cache of
    ``cache_len`` positions, its rows over the data axes where the
    cache's ``batch`` spec splits them; "mixed": a paged step (mixed,
    verify, prefill-on-join or decode) of ``tokens`` rows replicated
    over the data axes, ``logits_rows`` of logits. Per rwkv layer whose
    heads split over ``model``: the time mix's ``wo`` all-reduce. Per
    mamba layer whose ``d_in`` splits over ``model``: the all-reduces of
    ``x_proj``'s partial products (dt_rank + 2 d_state a token) and of
    ``out_proj``'s partial outputs. An encoder-decoder's prefill first
    runs its encoder over the rank's rows of ``enc_len`` positions (its
    lookup where it embeds tokens, its layers as below, no cache); every
    decoder layer adds its cross attention's output all-reduce. Per
    attention layer:
    ``wo``'s all-reduce; where the static cache lies over ``model`` by
    position (``cache_seq``) or is replicated, the gathers of the step's
    k and v, and at a decode step of q, and with ``cache_seq`` the
    partials' gather (``softmax_combine``, float32). Per MoE layer: the
    partial outputs' sum over ``model``, over the global rows where a
    data rank's rows do not form whole groups (their
    ``row_all_gather``); the router is whole on every rank
    (``ServeLayout.place``). Where ``param_rules`` (the cell's; the
    default rules with the arch's overrides when None) put the experts'
    ``mlp`` over data axes (``serve_tp``'s weight-stationary experts,
    ``ServePlan.expert_axes``), a static step gathers every row of the
    data group (``row_all_gather``, whenever the rows are split) and
    every MoE layer sums the partial outputs of all those rows over the
    data axes and ``model`` (``expert_all_reduce``) instead. A dense FFN's
    all-reduce, a vocab-parallel lookup's, and the logits gathered over
    ``model`` (vocab-parallel head) and over the data axes (the static
    batch's rows). The dispatch does not change them. Under
    ``pad_heads_multiple`` (``ApplyCfg``'s) the query heads are padded
    (``head_plan``): where the rules put the heads over ``model`` and the
    padding adds heads, every attention layer gathers its ``wq``, ``wo``
    (and ``bq``) blocks over ``model`` a step (``fsdp_all_gather``,
    weights of ``itemsize`` bytes) and pads and cuts them
    (``models/attention._tp_heads``). With ``ring``,
    ``{"payloads": ..., "bytes": ...}``: the bytes a ring sends ((W - 1)
    / W of an all-gather's output, 2 (W - 1) / W of an all-reduce's
    tensor over its W ranks)."""
    from repro_torch.models import stack as stk
    from repro_torch.models.attention import head_plan
    from repro_torch.sharding import (
        EP_AXIS,
        entry_axes,
        make_rules,
        mesh_shape,
        spec_for,
    )
    from repro_torch.sharding.comm import KINDS

    sizes = mesh_shape(mesh)
    m = sizes.get(EP_AXIS, 1)
    out = dict.fromkeys(KINDS, 0)
    sent = [0]

    def add(key, n, w, f=1):
        out[key] += n
        if w > 1:
            sent[0] += f * n * (w - 1) // w

    it, d, V = itemsize, cfg.d_model, cfg.vocab_size
    Kh, dh = cfg.n_kv_heads, cfg.head_dim
    if kind in ("prefill", "decode"):
        spec = spec_for("batch cache_seq kv_heads head_dim",
                        (batch, cache_len, Kh, dh), mesh,
                        make_rules(mesh, params=False))
        spec = tuple(spec) + (None,) * (4 - len(spec))
        D = math.prod(sizes[a] for a in entry_axes(spec[0]))
        Sq = tokens // batch
        B_l = batch // D
        n = B_l * Sq
        mode = ("seq" if entry_axes(spec[1]) else "heads"
                if entry_axes(spec[2]) else "replicated")
        out_rows = B_l
    else:
        D, Sq, n, mode, out_rows = 1, 1, tokens, "heads", logits_rows
    descs = stk.layer_descs(cfg)
    encdec = cfg.structure == "encoder_decoder"
    ws = ()
    if cfg.moe is not None:
        rules = param_rules if param_rules is not None else make_rules(
            mesh, params=True,
            overrides=dict(cfg.sharding_overrides or {}) or None)
        espec = tuple(spec_for("expert embed mlp",
                               (cfg.moe.num_experts, d, cfg.d_ff), mesh,
                               rules)) + (None,) * 3
        if entry_axes(espec[0]) == (EP_AXIS,) and entry_axes(espec[2]) \
                and EP_AXIS not in entry_axes(espec[2]):
            ws = entry_axes(espec[2])
    W = math.prod(sizes[a] for a in ws) * m
    plan = head_plan(cfg, m, pad_heads_multiple) if m > 1 and (
        encdec or any(d.mixer == "attn" for d in descs)) else None
    Hq, dh_q = cfg.n_heads, cfg.head_dim
    regather = 0  # the padded query weights' bytes gathered a layer
    if plan is not None and plan[0] != Hq:
        rules = param_rules if param_rules is not None else make_rules(
            mesh, params=True,
            overrides=dict(cfg.sharding_overrides or {}) or None)
        qspec = tuple(spec_for("embed heads head_dim", (d, Hq, dh_q), mesh,
                               rules)) + (None,) * 3
        if EP_AXIS in entry_axes(qspec[1]):
            regather = (2 * d + cfg.qkv_bias) * Hq * dh_q * itemsize
    H = cfg.d_model // cfg.ssm.head_size if cfg.ssm is not None else 0
    d_in = cfg.ssm.expand * d if cfg.ssm is not None else 0
    dt_rank = max(1, math.ceil(d / 16))

    def layers(descs, n, Sq, cached):
        for desc in descs:
            if m > 1 and desc.mixer == "rwkv6" and H % m == 0:
                add("tp_all_reduce", n * d * it, m, 2)  # the time mix's wo
            if m > 1 and desc.mixer == "mamba" and d_in % m == 0:
                add("tp_all_reduce",
                    n * (dt_rank + 2 * cfg.ssm.d_state) * it, m, 2)
                add("tp_all_reduce", n * d * it, m, 2)  # out_proj
            if m > 1 and desc.mixer == "attn":
                if regather:
                    add("fsdp_all_gather", regather, m)
                if plan is not None:
                    add("tp_all_reduce", n * d * it, m, 2)
                if cached and mode != "heads":
                    if plan is not None:
                        Hp, Gp, kv = plan
                        Hl = Hp // m
                        Kl = {"block": Hl // Gp, "one": 1, "each": Hl}[kv]
                        add("cache_all_gather", 2 * m * n * Kl * dh * it, m)
                        if Sq == 1:
                            add("cache_all_gather", B_l * Hp * dh * it, m)
                    if Sq == 1 and mode == "seq":
                        Hq = plan[0] if plan is not None else cfg.n_heads
                        add("softmax_combine",
                            m * B_l * Hq * (dh + 2) * 4, m)
            if m > 1 and desc.cross and plan is not None:
                if regather:
                    add("fsdp_all_gather", regather, m)
                add("tp_all_reduce", n * d * it, m, 2)  # cross attention
            if desc.ffn == "moe" and ws:
                nr = n * D
                if D > 1:
                    add("row_all_gather", nr * d * it, D)
                add("expert_all_reduce", nr * d * it, W, 2)
            elif desc.ffn == "moe":
                moe = cfg.moe
                E = moe.num_experts
                gathered = D > 1 and n % min(moe.group_size, n * D) != 0
                nr = n * D if gathered else n
                g = min(moe.group_size, nr)
                G = -(-nr // g)
                if gathered:
                    add("row_all_gather", nr * d * it, D)
                if m > 1 and (E % m == 0 or cfg.d_ff % m == 0):
                    add("tp_all_reduce",
                        (n if gathered else G * g) * d * it, m, 2)
            elif m > 1 and cfg.d_ff % m == 0:
                add("tp_all_reduce", n * d * it, m, 2)

    if encdec and kind == "prefill":
        n_enc = B_l * enc_len
        if m > 1 and V % m == 0 and cfg.frontend is None:
            add("tp_all_reduce", n_enc * d * it, m, 2)  # its lookup
        layers(stk.layer_descs(cfg, stack="encoder"), n_enc, enc_len, False)
    layers(descs, n, Sq, True)
    if m > 1 and V % m == 0:
        add("tp_all_reduce", n * d * it, m, 2)  # the vocab-parallel lookup
        add("logits_all_gather", out_rows * V * 4, m)
    if D > 1:
        add("logits_all_gather", out_rows * D * V * 4, D)
    return {"payloads": out, "bytes": sent[0]} if ring else out


def rules_collective_payloads(cfg, *, params, mesh, dispatch: str,
                              remat: str, tokens: int, itemsize: int,
                              kind: str = "train", ce_chunk: int = 0,
                              seq: int = 0, **serve) -> dict:
    """Payload bytes a rank moves through each kind of collective of one
    train step under the rules' placement (``sharding/comm.py``: an
    all-gather's output, a reduce-scatter's input, an all-reduce's
    tensor), the sums ``comm.COUNTS`` keeps: ``fsdp_all_gather`` and
    ``fsdp_reduce_scatter`` (each leaf's blocks over the data axes,
    float32 masters, joined once a step and its gradient scattered
    back), ``model_all_gather`` (a leaf over ``model`` in a module that
    runs no tensor parallelism), ``tp_all_reduce`` (attention, MLP and
    MoE inputs' gradients and outputs, a vocab-parallel lookup, head
    and cross-entropy) and ``router_all_gather``; with expert
    parallelism (sorted dispatch, ``moe.ep == "a2a"``, a mesh that
    hosts it) a MoE layer's all-to-alls at each peer's block of its
    data rank's groups (``ep_all_to_all``, :func:`ep_a2a_bytes`) and
    the blocks' join (``ep_all_gather``) in place of the partial
    outputs' sum. ``tokens`` is the
    global batch's; ``remat`` other than none runs the stack's forward
    collectives twice. ``ce_chunk`` (with ``seq``, a row's positions):
    the vocab-parallel cross-entropy over checkpointed chunks, whose
    backward recomputes each chunk's max, sum and target all-reduces and
    all-reduces the float32 head input's gradient, over the rows padded
    to whole chunks. Decoder-only and encoder-only stacks with
    attention mixers are modelled layer by layer; an encoder-decoder's
    cross-attention adds its inputs' gradients and output. A serving
    ``kind`` ("prefill", "decode", "mixed"; ``serve`` its shapes) is
    :func:`serve_collective_payloads`."""
    if kind != "train":
        return serve_collective_payloads(cfg, mesh=mesh, kind=kind,
                                         tokens=tokens, itemsize=itemsize,
                                         **serve)
    from repro_torch.models import param as pm
    from repro_torch.models import stack as stk
    from repro_torch.models.attention import head_plan
    from repro_torch.sharding import (
        EP_AXIS,
        entry_axes,
        make_rules,
        mesh_shape,
        spec_for,
    )
    from repro_torch.sharding.comm import _tensor_parallel

    sizes = mesh_shape(mesh)
    m = sizes.get(EP_AXIS, 1)
    D = math.prod(v for a, v in sizes.items() if a != EP_AXIS)
    rules = make_rules(mesh, params=True,
                       overrides=dict(cfg.sharding_overrides or {}) or None)
    ep = _ep_degree(cfg, mesh, dispatch) > 1
    from repro_torch.sharding.comm import KINDS

    out = dict.fromkeys(KINDS, 0)

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                if isinstance(v, (dict, list)):
                    walk(v, path + (k,))
                else:
                    leaf(v, path + (k,), tree)
        else:
            for i, v in enumerate(tree):
                walk(v, path + (i,))

    def leaf(t, path, parent):
        spec = spec_for(pm.axes_of(t), tuple(t.shape), mesh, rules)
        n = t.numel() * 4
        for e in spec:
            n //= math.prod(sizes[a] for a in entry_axes(e))
        for e in spec:
            axes = entry_axes(e)
            k = math.prod(sizes[a] for a in axes)
            if k == 1:
                continue
            n *= k
            if EP_AXIS not in axes:
                out["fsdp_all_gather"] += n
                out["fsdp_reduce_scatter"] += n
            elif not _tensor_parallel(path, parent):
                out["model_all_gather"] += n
            else:
                n //= k

    walk(params, ())
    if m == 1:
        return out
    it = itemsize
    d = cfg.d_model
    n = tokens // D
    passes = 2 if remat != "none" else 1
    ar = gather = 0
    stacks = [("decoder", stk.layer_descs(cfg))]
    if cfg.structure == "encoder_decoder":
        stacks.append(("encoder", stk.layer_descs(cfg, stack="encoder")))
    enc_n = n
    dec_n = max(tokens // 4 // D, 1) if cfg.structure == \
        "encoder_decoder" else n
    for name, descs in stacks:
        rows = dec_n if name == "decoder" else enc_n
        router = stk.stack_router_kind(cfg, stack=name)
        for desc in descs:
            if desc.mixer == "attn" and head_plan(cfg, m) is not None:
                fwd, bwd = rows * d * it, rows * d * it
                if cfg.n_kv_heads % m:
                    kv = 2 * d * cfg.n_kv_heads * cfg.head_dim
                    kv += 2 * cfg.n_kv_heads * cfg.head_dim \
                        if cfg.qkv_bias else 0
                    bwd += kv * it
                ar += passes * fwd + bwd
                if desc.cross:
                    ar += passes * rows * d * it + rows * d * it \
                        + enc_n * d * it
                    if cfg.n_kv_heads % m:
                        ar += kv * it
            if desc.ffn == "moe":
                moe = cfg.moe
                E = moe.num_experts
                if E % m == 0 or cfg.d_ff % m == 0:
                    fwd, bwd, r = _moe_tp_payloads(cfg, moe, rows, m,
                                                   dispatch, router, it)
                    if ep:
                        # Each peer's block of the groups through the
                        # all-to-alls, the blocks joined; no partial sum.
                        a2a = ep_a2a_bytes(cfg, tokens_per_rank=rows // m,
                                           ep=m, itemsize=it)
                        out["ep_all_to_all"] += passes * a2a["forward"] \
                            + a2a["backward"]
                        out["ep_all_gather"] += passes * fwd
                        fwd = 0
                    ar += passes * fwd + bwd
                    gather += passes * r
            elif cfg.d_ff % m == 0:
                ar += passes * rows * d * it + rows * d * it
    V = cfg.vocab_size
    if V % m == 0:
        chunked = bool(ce_chunk) and cfg.structure != "encoder_only"
        if cfg.structure == "encoder_only":
            rows = n // cfg.n_frontend_positions
        else:
            rows = dec_n
            ar += rows * d * it  # the vocab-parallel lookup
            if cfg.structure == "encoder_decoder" and cfg.frontend is None:
                ar += enc_n * d * it  # the encoder's (not frames)
        if chunked:
            S = (max(seq // 4, 1) if cfg.structure == "encoder_decoder"
                 else seq) or rows
            c = min(ce_chunk, S)
            rows = rows // S * (S + (-S) % c)
            # the head input (float32), then max, sum, target twice
            ar += rows * d * 4 + 2 * 3 * rows * 4
        else:
            ar += rows * d * it + 3 * rows * 4  # head input, max, sum, target
    out["tp_all_reduce"] = ar
    out["router_all_gather"] = gather
    return out


def _rules_collectives(cfg, out, *, params, mesh, dispatch, remat,
                       tokens, itemsize, ce_chunk=0, seq=0) -> dict:
    """A train step under the rules' placement: the payloads of
    :func:`rules_collective_payloads` (``out["payloads"]``), the bytes a
    ring sends for each ((W - 1) / W of an all-gather's output or a
    reduce-scatter's input, 2 (W - 1) / W of an all-reduce's tensor,
    over the data axes' W ranks or ``model``'s), and the float32
    gradient all-reduce over the data axes of every leaf not sharded
    over them."""
    from repro_torch.models import param as pm
    from repro_torch.sharding import (
        EP_AXIS,
        entry_axes,
        make_rules,
        mesh_shape,
        spec_for,
    )

    sizes = mesh_shape(mesh)
    m = sizes.get(EP_AXIS, 1)
    data = [a for a in sizes if a != EP_AXIS]
    D = math.prod(sizes[a] for a in data)
    rules = make_rules(mesh, params=True,
                       overrides=dict(cfg.sharding_overrides or {}) or None)
    pay = rules_collective_payloads(cfg, params=params, mesh=mesh,
                                    dispatch=dispatch, remat=remat,
                                    tokens=tokens, itemsize=itemsize,
                                    ce_chunk=ce_chunk, seq=seq)
    out["payloads"] = pay
    for leaf in pm.tree_leaves(params):
        spec = spec_for(pm.axes_of(leaf), tuple(leaf.shape), mesh, rules)
        lies = [a for e in spec for a in entry_axes(e)]
        w = math.prod(sizes[a] for a in data if a not in lies)
        if w > 1:
            local = leaf.numel() * 4 // math.prod(sizes[a] for a in lies)
            out["grad_all_reduce"] += 2 * (w - 1) * local // w
    out["counts"]["all-reduce"] += 1 if out["grad_all_reduce"] else 0
    ring = {"fsdp_all_gather": (D, 1), "fsdp_reduce_scatter": (D, 1),
            "model_all_gather": (m, 1), "router_all_gather": (m, 1),
            "tp_all_reduce": (m, 2), "ep_all_to_all": (m, 1),
            "ep_all_gather": (m, 1)}
    out["bytes"] = out["grad_all_reduce"] + sum(
        f * pay[k] * (w - 1) // w for k, (w, f) in ring.items() if w > 1)
    return out


def _ep_degree(cfg, mesh, dispatch: str) -> int:
    """The ``model`` ranks a MoE layer's all-to-all spans (1 without
    expert parallelism)."""
    from repro_torch.sharding import expert_parallel_layout, mesh_shape

    moe = cfg.moe
    if (moe is not None and dispatch == "sorted" and moe.ep == "a2a"
            and expert_parallel_layout(mesh, moe.num_experts) is not None):
        return mesh_shape(mesh)["model"]
    return 1


def collective_bytes(cfg, *, kind: str, params, dispatch: str, remat: str,
                     mesh, tokens: int, itemsize: int, batch: int = 0,
                     seq: int = 0, tensor_parallel: bool = False,
                     param_rules=None, ce_chunk: int = 0,
                     pad_heads_multiple: int = 0) -> dict:
    """The collectives a device runs in one step of the port's runtime
    on ``mesh``, in bytes it sends. Training under the rules' placement
    (with expert parallelism, for a ``tensor_parallel`` ctx:
    ``train_layout``): :func:`_rules_collectives`. Training under the
    expert-only layout: the gradients' float32 all-reduce
    (``train_loop.reduce_grads``; a ring sends 2 (W - 1) / W of the
    buffer), every leaf over the whole mesh but expert leaves, which
    reduce over the mesh's other axes, and each MoE layer's all-to-alls
    (sorted dispatch, ``moe.ep == "a2a"``, a mesh that hosts it;
    :func:`ep_a2a_bytes`), the forward's again under ``remat`` full or
    dots (the layer is recomputed) and the backward's. Prefill and
    decode cells of attention or rwkv stacks without expert
    parallelism: the static engine's step under the rules' serving
    placement (:func:`serve_collective_payloads`, a ``batch`` x ``seq``
    prompt or one token a row against a cache of ``seq``; the experts'
    placement by ``param_rules``, the cell's), under ``"payloads"``;
    with it, the all-to-alls of the forward. ``ce_chunk``: the train
    cell's chunked cross-entropy (:func:`rules_collective_payloads`);
    ``pad_heads_multiple``: a serving cell's padded query heads
    (:func:`serve_collective_payloads`)."""
    from repro_torch.models import param as pm
    from repro_torch.models import stack as stk
    from repro_torch.sharding import ep_dim, mesh_shape

    n = math.prod(mesh_shape(mesh).values())
    ep = _ep_degree(cfg, mesh, dispatch)
    out = {"grad_all_reduce": 0, "a2a_forward": 0, "a2a_backward": 0,
           "counts": {"all-reduce": 0, "all-to-all": 0}}
    if kind == "train" and (ep == 1 or tensor_parallel):
        return _rules_collectives(cfg, out, params=params, mesh=mesh,
                                  dispatch=dispatch, remat=remat,
                                  tokens=tokens, itemsize=itemsize,
                                  ce_chunk=ce_chunk, seq=seq)
    mixers = {d.mixer for d in stk.layer_descs(cfg)}
    if ep == 1 and cfg.structure == "decoder_only" \
            and mixers in ({"attn"}, {"rwkv6"}):
        step = 1 if kind == "decode" else seq
        r = serve_collective_payloads(
            cfg, mesh=mesh, kind=kind, tokens=batch * step,
            itemsize=itemsize, batch=batch, cache_len=seq, ring=True,
            param_rules=param_rules, pad_heads_multiple=pad_heads_multiple)
        out.update(r)
        return out
    if kind == "train":
        rep = exp = 0
        for leaf in pm.tree_leaves(params):
            if ep > 1 and ep_dim(pm.axes_of(leaf)) is not None:
                exp += leaf.numel() // ep * 4
            else:
                rep += leaf.numel() * 4
        for nbytes, w in ((rep, n), (exp, n // ep)):
            if nbytes and w > 1:
                out["grad_all_reduce"] += 2 * (w - 1) * nbytes // w
                out["counts"]["all-reduce"] += 1
    if ep > 1:
        descs = stk.layer_descs(cfg)
        if cfg.structure == "encoder_decoder":
            descs = descs + stk.layer_descs(cfg, stack="encoder")
        layers = sum(d.ffn == "moe" for d in descs)
        one = ep_a2a_bytes(cfg, tokens_per_rank=tokens // n, ep=ep,
                           itemsize=itemsize)
        passes = 2 if kind == "train" and remat in ("full", "dots") else 1
        out["a2a_forward"] = passes * layers * one["forward"]
        out["counts"]["all-to-all"] += passes * layers * 3
        if kind == "train":
            out["a2a_backward"] = layers * one["backward"]
            out["counts"]["all-to-all"] += layers * 2
    out["bytes"] = (out["grad_all_reduce"] + out["a2a_forward"]
                    + out["a2a_backward"])
    return out


def _rank_child(arch, shape, mesh, transport, **build) -> dict:
    """:func:`rank_memory`'s body, in the spawned process."""
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.memory import measure
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import build_cell
    from repro_torch.sharding import comm

    torch.set_num_threads(1)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(mesh.values()))
    try:
        comm.TRANSPORT = transport
        dmesh = make_mesh(tuple(mesh.values()), tuple(mesh),
                          device_type="cpu")
        step, args, info = build_cell(arch, shape, dmesh, rank=True,
                                      **build)
        want = argument_bytes(info["global_args"], info["axes"],
                              info["ctx"], shape.kind)["total"]
        t0 = time.perf_counter()
        _, rep = measure(step, *args)
        rep["run_s"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    if rep["argument_bytes"] != want:
        raise AssertionError(
            f"rank 0's step holds {rep['argument_bytes']} argument bytes, "
            f"the rules' placement {want}")
    return rep


def rank_memory(arch: str, shape, mesh: dict, *, profile: str = "baseline",
                extra_ac: dict | None = None, cfg=None, param_dtype=None,
                cache_dtype=None, transport: str | None = None) -> dict:
    """Rank 0's step of a cell on the meta device under a "fake" process
    group of ``mesh``'s size (``torch.testing._internal.distributed.
    fake_pg``), in a child process started by spawn, counted by
    ``launch/memory.measure``: its ``argument_bytes`` (checked equal to
    the rules' placement's), ``output_bytes``, ``temp_bytes``,
    ``peak_bytes``, ``total_bytes`` and ``at_peak``, and ``run_s``.
    ``transport="gloo"`` builds the reduce-scatters as gloo's, from an
    all-to-all (``sharding/comm.py``); None, as NCCL's.
    The cell's arguments are :func:`run_cell`'s. Raises where the rank's
    step cannot be built or run."""
    import multiprocessing

    from repro_torch.configs import SHAPES

    cell = dict(arch=arch, mesh=dict(mesh), profile=profile,
                extra_ac=extra_ac, cfg=cfg, param_dtype=param_dtype,
                cache_dtype=cache_dtype, transport=transport,
                shape=SHAPES[shape] if isinstance(shape, str) else shape)
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        return pool.apply(_rank_child, kwds=cell)


def run_cell(arch: str, shape, mesh_kind: str, profile: str, out_dir: str,
             extra_ac: dict | None = None, tag: str = "",
             mesh: dict | None = None, *, cfg=None, param_dtype=None,
             cache_dtype=None) -> dict:
    """Build, run on the meta device and record one cell. ``shape``: a
    ``SHAPES`` name or a ``ShapeCfg``; ``mesh`` (a ``{axis: size}``
    mapping) overrides ``mesh_kind``'s production mesh; ``cfg`` (the
    arch's config changed), ``param_dtype`` and ``cache_dtype`` override
    the cell's (``specs.build_cell``). The memory record is rank 0's
    step with NCCL's reduce-scatter (:func:`rank_memory`)."""
    import torch

    from repro_torch.configs import SHAPES, get_config, shape_applicable
    from repro_torch.launch.flops import model_flops, step_cost
    from repro_torch.launch.mesh import (
        HBM_BW,
        HBM_BYTES,
        NVLINK_BW,
        PEAK_FLOPS_BF16,
        production_mesh_shape,
    )
    from repro_torch.launch.specs import build_cell

    shp = SHAPES[shape] if isinstance(shape, str) else shape
    cfg = cfg if cfg is not None else get_config(arch)
    ok, reason = shape_applicable(cfg, shp)
    rec = {"arch": arch, "shape": shp.name, "mesh": mesh_kind,
           "profile": profile, "tag": tag}
    if not ok:
        rec.update(status="skipped", reason=reason)
        _write(rec, out_dir, tag)
        print(f"[dryrun] SKIP {arch} x {shp.name}: {reason}")
        return rec

    if mesh is None:
        mesh = production_mesh_shape(multi_pod=mesh_kind == "multipod")
    n_chips = math.prod(mesh.values())
    over = dict(cfg=cfg, param_dtype=param_dtype, cache_dtype=cache_dtype)
    step, args, info = build_cell(arch, shp, mesh, profile=profile,
                                  extra_ac=extra_ac, **over)
    axes, ctx, ac = info.pop("axes"), info.pop("ctx"), info.pop("ac")
    cfg = info.pop("cfg")
    info.pop("global_args")
    rec.update(info)
    rec["mesh_shape"] = dict(mesh)
    t0 = time.perf_counter()
    _, cost = step_cost(step, *args)
    run_s = time.perf_counter() - t0
    rank = rank_memory(arch, shp, mesh, profile=profile, extra_ac=extra_ac,
                       **over)

    mem = argument_bytes(args, axes, ctx, shp.kind)
    params = args[0]["params"] if shp.kind == "train" else args[0]
    coll = collective_bytes(
        cfg, kind=shp.kind, params=params, dispatch=ac.dispatch,
        remat=ac.remat, mesh=mesh, tokens=shp.global_batch * shp.seq_len,
        itemsize=torch.empty((), dtype=ac.cdtype).element_size(),
        batch=shp.global_batch, seq=shp.seq_len,
        tensor_parallel=ctx.tensor_parallel is not False,
        param_rules=ctx.param_rules, ce_chunk=ac.ce_chunk,
        pad_heads_multiple=ac.pad_heads_multiple)

    flops_dev = cost["total_flops"] / n_chips
    bytes_dev = (cost["aten_bytes"] + sum(cost["kernel_bytes"].values())) \
        / n_chips
    coll_dev = float(coll["bytes"])
    t_compute = flops_dev / PEAK_FLOPS_BF16
    t_memory = bytes_dev / HBM_BW
    t_coll = coll_dev / NVLINK_BW
    dominant = max(("compute", t_compute), ("memory", t_memory),
                   ("collective", t_coll), key=lambda kv: kv[1])[0]
    tokens = shp.global_batch * (shp.seq_len if shp.kind != "decode" else 1)
    model_dev = model_flops(cfg, shp.kind, tokens,
                            info["params_active"]) / n_chips
    flash = [k for k in cost["kernel_flops"] if k.startswith("flash")]
    rec.update(
        status="ok",
        n_chips=n_chips,
        run_s=run_s,
        flops_per_device=flops_dev,
        aten_flops=cost["aten_flops"],
        kernel_flops=cost["kernel_flops"],
        kernel_bytes=cost["kernel_bytes"],
        kernel_calls=cost["kernel_calls"],
        bytes_per_device=bytes_dev,
        attention={"flash_flops": sum(cost["kernel_flops"][k]
                                      for k in flash),
                   "flash_bytes": sum(cost["kernel_bytes"][k]
                                      for k in flash)},
        collective_bytes_per_device=coll_dev,
        collectives=coll,
        collective_counts=coll["counts"],
        memory={
            "argument_bytes": mem["total"],
            "argument_bytes_by_input": mem,
            "arguments_fit_hbm": bool(mem["total"] < HBM_BYTES),
            "temp_bytes": rank["peak_bytes"] - mem["total"]
            - rank["output_bytes"],
            "output_bytes": rank["output_bytes"],
            "total_bytes": rank["peak_bytes"],
            "peak_bytes": rank["peak_bytes"],
            "fits_hbm": bool(rank["peak_bytes"] < HBM_BYTES),
            "at_peak": rank["at_peak"],
            "rank_run_s": rank["run_s"],
        },
        roofline={
            "compute_s": t_compute,
            "memory_s": t_memory,
            "collective_s": t_coll,
            "dominant": dominant,
            "step_time_lower_bound_s": max(t_compute, t_memory, t_coll),
        },
        model_flops_per_device=model_dev,
        useful_flops_ratio=model_dev / flops_dev if flops_dev else 0.0,
    )
    _write(rec, out_dir, tag)
    print(f"[dryrun] {arch} x {shp.name} x {mesh_kind} ({profile}): "
          f"{run_s:.1f} s on the meta device")
    print(f"  flops/device={flops_dev:.4e} (aten {cost['aten_flops']:.4e}, "
          f"kernels {sum(cost['kernel_flops'].values()):.4e}) "
          f"bytes/device={bytes_dev:.4e} collective/device={coll_dev:.4e}")
    print(f"  argument_bytes={mem['total']} ({mem})")
    m = rec["memory"]
    print(f"  rank 0's step ({m['rank_run_s']:.1f} s): temp_bytes="
          f"{m['temp_bytes']} output_bytes={m['output_bytes']} "
          f"total_bytes=peak_bytes={m['peak_bytes']} "
          f"fits_hbm={m['fits_hbm']}")
    for g in m["at_peak"]:
        print(f"    at the peak: {g['bytes']} B in {g['count']} from "
              f"{g['op']} ({g['where']})")
    print("  roofline: compute=%.4fs memory=%.4fs collective=%.4fs -> %s"
          % (t_compute, t_memory, t_coll, dominant))
    print("  model_flops/counted_flops=%.3f" % rec["useful_flops_ratio"])
    return rec


def _write(rec: dict, out_dir: str, tag: str = "") -> None:
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    name = (f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"
            f"__{rec['profile']}{suffix}.json").replace("/", "_")
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=2)


def all_cells(meshes, profile):
    from repro_torch.configs import SHAPES, assigned_archs

    for arch in assigned_archs():
        for shape in SHAPES:
            for mesh_kind in meshes:
                yield arch, shape, mesh_kind, profile


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--profile", default="baseline",
                    choices=["baseline", "optimized", "serve_tp"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--extra-ac", default="",
                    help='JSON ApplyCfg overrides, e.g. {"ce_chunk":1024}')
    ap.add_argument("--all", action="store_true",
                    help="run every applicable cell, in this process")
    ap.add_argument("--meshes", default="pod,multipod")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)
    extra_ac = json.loads(args.extra_ac) if args.extra_ac else None

    if args.all:
        failures = []
        for arch, shape, mesh_kind, profile in all_cells(
                args.meshes.split(","), args.profile):
            print("=" * 72, flush=True)
            try:
                run_cell(arch, shape, mesh_kind, profile, args.out,
                         extra_ac=extra_ac, tag=args.tag)
            except Exception:  # a failed cell must not stop the others
                traceback.print_exc()
                failures.append((arch, shape, mesh_kind))
        print("=" * 72)
        if failures:
            print(f"[dryrun] FAILURES: {failures}")
            sys.exit(1)
        print("[dryrun] all cells OK")
        return
    if not args.arch:
        ap.error("--arch is required without --all")
    run_cell(args.arch, args.shape, args.mesh, args.profile, args.out,
             extra_ac=extra_ac, tag=args.tag)


if __name__ == "__main__":
    main()
