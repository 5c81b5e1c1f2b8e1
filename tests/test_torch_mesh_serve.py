"""Serving under the rules engine's placement on ``gloo`` ranks on the
CPU: ``ServeEngine(ctx=)`` on a (data=2, model=2) mesh.

``get_reduced("granite-moe-1b-a400m")`` (4 query / 2 KV heads, 8
experts top-4 at the config's capacity factor, vocab 259), random
weights from seed 0, serves on 4 spawned ranks, each holding its blocks
of the heads, KV heads and experts over ``model`` (``sharding.
serve_layout``):

* the static engine, 4 prompts of 9-16 tokens padded to 16: 6 new
  tokens (a cache of 22 positions, ``cache_seq`` over ``model``: each
  rank holds half the positions of every KV head, a decode step's
  partial softmaxes combined across the ranks) and 5 (21 positions,
  odd: ``kv_heads`` over ``model``), the rows over ``data``; the same
  with the weights handed over as the rank's blocks of the train
  layout (joined once); a vocabulary of 256 (vocab-parallel embedding
  and head) against one process;
* the paged chunked engine over 5 requests, three sharing a 16-token
  prefix, the pools holding the rank's KV head, the rows replicated
  over ``data``;
* speculative decoding with the dense draft (``spec_k`` 2);
* on (data=1, model=4), the static engine with one query head a rank
  (its KV head by global index): the cache's positions over ``model``
  (20) and the cache replicated (21), against one process.

Each engine's tokens equal the reference's ``ServeEngine(ctx=)`` on a
forced 4-device (2, 2) debug mesh (run in a subprocess), every rank's
the same; each step's logits (teacher-forced static steps, each paged
tick's) are within rtol 1e-4, atol 1e-5 of the port's one-process
engine; a paged rank's pools at close hold its KV-head block of the one
process's (atol 1e-4, the serving parity tests' pool tolerance).
Also: a data rank's decode rows route as the global batch's group (the
test checks that routing each rank's rows alone would differ); the
bytes each rank counted through each kind of collective in a static
prefill, a decode step and a mixed step equal
``launch/dryrun.rules_collective_payloads``; a mamba stack under a
serving ctx raises (rwkv serves: ``tests/test_torch_mesh_rwkv.py``).
Without ranks: ``serve_layout``'s specs equal the reference's
``spec_for`` for every registered attention arch on (2, 2) and
(16, 16); the log-sum-exp combine equals one softmax, blocks with
no valid position included; placements the port cannot serve raise;
``ServeEngine(ctx=None)`` and a ctx without process groups serve as
before, bit for bit. One spawn of 4 ranks; the ranks import torch and
the port only.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.models import model_zoo as zoo
from repro_torch.serve import Request, ServeConfig, ServeEngine
from torch_threads import one_thread  # noqa: F401 (autouse)

GRANITE = "granite-moe-1b-a400m"
WORLD, MESH = 4, (2, 2)
PROMPT_LENS = (16, 12, 9, 16)
# max_new: the static cache is 16 + max_new positions.
STATIC = {"seq": 6, "heads": 5, "blocks": 6, "vocab": 6}
# On (data=1, model=4): 2 KV heads do not split over 4 ranks, each rank
# runs 1 query head and reads its KV head by global index; 20 positions
# split over model, 21 leave the cache replicated.
M4 = {"m4_seq": 4, "m4_replicated": 5}
PAGED = dict(max_batch=4, max_len=64, block_size=8, chunk_size=16)
SPEC = dict(PAGED, draft="dense", spec_k=2)
RTOL, ATOL, POOL_ATOL = 1e-4, 1e-5, 1e-4


def _cfg(case=""):
    cfg = get_reduced(GRANITE)
    return dataclasses.replace(cfg, vocab_size=256) if case == "vocab" \
        else cfg


def _prompts():
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(1, 256, size=n)]
            for n in PROMPT_LENS]


def _requests():
    """5 requests of 6 new tokens; 0, 3 and 4 share a 16-token prefix
    (two blocks), 3 and 4 arriving while 0 runs."""
    rng = np.random.default_rng(1)
    pre = [int(t) for t in rng.integers(1, 256, size=16)]
    tail = [[int(t) for t in rng.integers(1, 256, size=n)]
            for n in (5, 11, 20, 9, 3)]
    prompts = [pre + tail[0], tail[1], tail[2], pre + tail[3],
               pre + tail[4]]
    arrival = (0, 0, 1, 2, 4)
    return [dict(rid=i, prompt=p, max_new=6, arrival=a)
            for i, (p, a) in enumerate(zip(prompts, arrival))]


def _static_steps(eng, prompts, tokens, new):
    """The static engine's steps teacher-forced on ``tokens`` (its
    ``generate``'s outputs): (logits of the prefill and each decode
    step, the collective payloads counted in the prefill and the first
    decode step)."""
    from repro_torch.sharding import comm

    cfg, B = eng.cfg, len(prompts)
    plen = max(map(len, prompts))
    toks = torch.zeros((B, plen), dtype=torch.long)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p)
    gen = torch.tensor([t[len(p):] for t, p in zip(tokens, prompts)])
    cache, ctx, (lo, hi) = eng.static_cache(B, plen + new)
    logits, counts = [], []
    with torch.no_grad():
        comm.reset_counts()
        cache, lg = zoo.prefill(eng.params, {"tokens": toks[lo:hi]}, cache,
                                cfg, ac=eng.ac, ctx=ctx)
        counts.append(comm.counts())
        logits.append(lg[:, -1].numpy())
        for t in range(new - 1):
            comm.reset_counts()
            cache, lg = zoo.decode_step(eng.params, gen[lo:hi, t:t + 1],
                                        cache, plen + t, cfg, ac=eng.ac,
                                        ctx=ctx)
            counts.append(comm.counts())
            logits.append(lg[:, -1].numpy())
    return logits, counts[:2]


def _session(eng):
    """A paged session over :func:`_requests`, a tick at a time: (outputs,
    each step's logits, the payloads counted in the first step, the
    pools at close, the stats)."""
    from repro_torch.sharding import comm

    sess = eng.open_session()
    for r in _requests():
        sess.submit(Request(**r))
    logits, counts, steps = [], [], 0
    with torch.no_grad():
        while True:
            comm.reset_counts()
            alive = sess.tick()
            if sess.stats["mixed_steps"] != steps:
                steps = sess.stats["mixed_steps"]
                logits.append(sess.last_logits.copy())
                counts.append(comm.counts())
            if not alive:
                break
    outs, fin = sess.close()
    pools = {k: v.clone() for k, v in
             sess.cache["stack"]["segments"][0]["pos0"]["mixer"].items()}
    assert all(f["status"] == "completed" for f in fin.values())
    return ({str(k): v for k, v in outs.items()}, logits, counts[0], pools,
            {k: eng.last_stats[k] for k in ("compile_count",
                                            "free_blocks_at_close",
                                            "prefix_hit_frac")})


def _moe_case():
    """(layer 0's MoE params, 4 decode rows (4, 1, d)) of the reduced
    granite at seed 0."""
    from repro_torch.models.param import tree_map

    cfg = _cfg()
    params = zoo.init_params(0, cfg, device="cpu")
    ffn = tree_map(lambda t: t[0],
                   params["stack"]["segments"][0]["pos0"]["ffn"])
    g = torch.Generator().manual_seed(5)
    return cfg, ffn, torch.randn(4, 1, cfg.d_model, generator=g)


def _engines(ctx, params_for=None, static=STATIC, paged=True):
    """Every case's results on this process (``ctx`` None: one
    process)."""
    out = {}
    prompts = _prompts()
    for case, new in static.items():
        if ctx is None and case == "blocks":
            continue
        cfg = _cfg(case)
        params = zoo.init_params(0, cfg, device="cpu")
        if case == "blocks":
            params = params_for(params, cfg)
        eng = ServeEngine(params, cfg, ServeConfig(max_batch=4),
                          device="cpu", ctx=ctx)
        toks = eng.generate(prompts, new)
        logits, counts = _static_steps(eng, prompts, toks, new)
        out[case] = {"tokens": toks, "logits": logits, "counts": counts}
    cfg = _cfg()
    params = zoo.init_params(0, cfg, device="cpu")
    for case, kw in (("paged", PAGED), ("spec", SPEC)) if paged else ():
        eng = ServeEngine(params, cfg, ServeConfig(paged=True, **kw),
                          device="cpu", ctx=ctx)
        toks, logits, counts, pools, stats = _session(eng)
        out[case] = {"tokens": toks, "logits": logits, "counts": counts,
                     "pools": pools, "stats": stats}
    return out


def _worker(rank, world, tmp):
    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world)
    from repro_torch.core.moe import moe_apply
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding import ShardCtx, serve_layout, shard_leaf
    from repro_torch.sharding import _walk as walk

    ctx = ShardCtx.for_mesh(make_debug_mesh(MESH, ("data", "model")))

    def blocks(params, cfg):
        """The rank's blocks under the param rules (the train layout's
        placement of the weights)."""
        specs = serve_layout(ctx, cfg).specs
        return walk(lambda t, s, *_: shard_leaf(t, s, ctx), params, specs)

    out = _engines(ctx, blocks)
    out.update(_engines(ShardCtx.for_mesh(make_debug_mesh(
        (1, WORLD), ("data", "model"))), static=M4, paged=False))
    # A data rank's decode rows through layer 0's MoE.
    cfg, _, x = _moe_case()
    meta = zoo.init_serve_cache(cfg, 4, 22, dtype=torch.float32,
                                device="meta")
    lay = serve_layout(ctx, cfg, cache=meta)
    i, n = lay.rows()
    placed = lay.place(zoo.init_params(0, cfg, device="cpu"))
    ffn = {k: {kk: vv[0] for kk, vv in v.items()} for k, v in
           placed["stack"]["segments"][0]["pos0"]["ffn"].items()}
    with torch.no_grad():
        out["moe"] = {d: moe_apply(ffn, x[i * 4 // n:(i + 1) * 4 // n], cfg,
                                   cfg.moe, dispatch=d, ctx=lay.ctx)[0]
                      for d in ("gather", "sorted")}
    out["rows"] = (i, n)
    out["model_rank"] = ctx.coord("model")
    # rwkv and mamba stacks serve under a mesh too
    # (tests/test_torch_mesh_rwkv.py, tests/test_torch_mesh_mamba.py):
    # the engine places a jamba stack, its mamba caches its d_in block.
    rwkv = get_reduced("jamba-1.5-large-398b")
    try:
        eng = ServeEngine(zoo.init_params(0, rwkv, device="cpu"), rwkv,
                          device="cpu", ctx=ctx)
        cache, _, _ = eng.static_cache(4, 16)
        out["rwkv"] = tuple(cache["stack"]["segments"][0]["pos0"]["mixer"][
            "ssm"].shape)
    except NotImplementedError as e:
        out["rwkv"] = str(e)
    torch.save(out, f"{tmp}/rank{rank}.pt")
    dist.destroy_process_group()


REFERENCE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get_reduced
    from repro.launch.mesh import make_debug_mesh
    from repro.models import model_zoo as zoo
    from repro.models import param as pm
    from repro.serve import Request, ServeConfig, ServeEngine
    from repro.sharding import ShardCtx

    tmp, part = sys.argv[1:]
    spec = json.load(open(f"{tmp}/spec.json"))[part]
    z = np.load(f"{tmp}/params.npz")
    cfg = get_reduced("granite-moe-1b-a400m")
    vals, _ = pm.split(jax.eval_shape(
        lambda: zoo.init_params(jax.random.PRNGKey(0), cfg)))
    name = lambda p: "/".join(
        str(getattr(k, "key", getattr(k, "idx", None))) for k in p)
    vals = jax.tree_util.tree_map_with_path(
        lambda p, _: jnp.asarray(z[name(p)]), vals)
    ctx = ShardCtx.for_mesh(make_debug_mesh((2, 2), ("data", "model")))
    out = {}
    for case, new in spec["static"].items():
        eng = ServeEngine(vals, cfg, ServeConfig(max_batch=4), ctx=ctx)
        out[case] = eng.generate(spec["prompts"], new)
    for case, kw in spec["paged"].items():
        eng = ServeEngine(vals, cfg, ServeConfig(paged=True, **kw), ctx=ctx)
        outs, _ = eng.serve([Request(**r) for r in spec["requests"]])
        out[case] = {str(k): v for k, v in outs.items()}
    json.dump(out, open(f"{tmp}/ref_{part}.json", "w"), default=int)
""")


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        return {k: v for kk, vv in tree.items()
                for k, v in _flat(vv, f"{pre}/{kk}" if pre else kk).items()}
    if isinstance(tree, list):
        return {k: v for i, vv in enumerate(tree)
                for k, v in _flat(vv, f"{pre}/{i}").items()}
    return {pre: tree}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' results, the one process's, the reference's tokens).
    The reference runs in a subprocess and the one process here while
    the ranks run."""
    from repro_torch.models.convert import to_jax_values

    tmp = str(tmp_path_factory.mktemp("mesh_serve"))
    params = zoo.init_params(0, _cfg(), device="cpu")
    np.savez(f"{tmp}/params.npz", **_flat(to_jax_values(params)))
    # Two reference processes: the static and paged engines, and the
    # speculative one (each jit-compiles its own steps).
    common = {"prompts": _prompts(), "requests": _requests()}
    with open(f"{tmp}/spec.json", "w") as f:
        json.dump({"a": {**common, "paged": {"paged": PAGED},
                         "static": {k: STATIC[k] for k in ("seq",
                                                           "heads")}},
                   "b": {**common, "paged": {"spec": SPEC}, "static": {}}},
                  f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   ["src", os.environ.get("PYTHONPATH", "")]))
    refs = [subprocess.Popen([sys.executable, "-c", REFERENCE, tmp, part],
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE) for part in "ab"]
    procs = torch.multiprocessing.start_processes(
        _worker, args=(WORLD, tmp), nprocs=WORLD, join=False,
        start_method="spawn")
    try:
        one = _engines(None, static={**STATIC, "m4_seq": M4["m4_seq"]})
        while not procs.join():
            pass
    finally:
        errs = [ref.communicate(timeout=300)[1] for ref in refs]
    for ref, err in zip(refs, errs):
        assert ref.returncode == 0, err.decode()[-2000:]
    ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    want = {}
    for part in "ab":
        with open(f"{tmp}/ref_{part}.json") as f:
            want.update(json.load(f))
    return ranks, one, want


def _close(got, want, what):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} step {i}")


@pytest.mark.parametrize("case", ["seq", "heads"])
def test_static_engine_matches_reference_and_one_process(runs, case):
    """Tokens equal the reference's ``ServeEngine(ctx=)`` on every rank;
    each step's logits (every row's, on every rank) within tolerance of
    one process. ``seq``: the cache's positions over model; ``heads``:
    its KV heads (the odd cache length)."""
    ranks, one, ref = runs
    for r, got in enumerate(ranks):
        assert got[case]["tokens"] == ref[case], (case, r)
        _close(got[case]["logits"], one[case]["logits"], f"{case} rank {r}")
    assert one[case]["tokens"] == ref[case]


@pytest.mark.parametrize("case", ["blocks", "vocab", "m4_seq",
                                  "m4_replicated"])
def test_static_engine_variants_match_one_process(runs, case):
    """``blocks``: the weights handed over as the rank's blocks of the
    train layout, joined once at construction; ``vocab``: a vocabulary
    of 256, split over model (vocab-parallel lookup and head, the
    logits gathered); ``m4_*``: 4 model ranks of one query head each
    (their KV head picked by global index), the cache's positions over
    model (20) or the cache replicated (21)."""
    ranks, one, _ = runs
    want = one[{"blocks": "seq", "m4_replicated": "heads"}.get(case, case)]
    for r, got in enumerate(ranks):
        assert got[case]["tokens"] == want["tokens"], (case, r)
        _close(got[case]["logits"], want["logits"], f"{case} rank {r}")


@pytest.mark.parametrize("case", ["paged", "spec"])
def test_paged_engine_matches_reference_and_one_process(runs, case):
    """The chunked engine (shared prefix) and speculative decoding with
    the dense draft: tokens equal the reference's on every rank, each
    tick's logits within tolerance of one process's, one step shape, no
    block leaked, the prefix cache hit."""
    ranks, one, ref = runs
    for r, got in enumerate(ranks):
        assert got[case]["tokens"] == ref[case], (case, r)
        _close(got[case]["logits"], one[case]["logits"], f"{case} rank {r}")
        assert got[case]["stats"] == one[case]["stats"]
    st = one[case]["stats"]
    assert st["compile_count"] == 1 and st["prefix_hit_frac"] > 0


def test_paged_pools_hold_the_ranks_kv_heads(runs):
    """A rank's pools at close: its block of the KV heads of the one
    process's pools (the trash block 0 aside, whose colliding dead-row
    writes keep no order)."""
    ranks, one, _ = runs
    Kh = _cfg().n_kv_heads
    for r, got in enumerate(ranks):
        m = got["model_rank"]
        for k, pool in got["paged"]["pools"].items():
            kl = pool.shape[3]
            assert kl == Kh // MESH[1]
            want = one["paged"]["pools"][k][:, :, :, m * kl:(m + 1) * kl]
            np.testing.assert_allclose(pool[:, 1:].numpy(),
                                       want[:, 1:].numpy(), atol=POOL_ATOL,
                                       rtol=0, err_msg=f"rank {r} {k}")


def test_decode_rows_route_as_the_global_group(runs):
    """A data rank's 2 of the 4 decode rows through a MoE layer give its
    rows of the one-process layer over all 4 (one group of 4, capacity
    1 an expert); routing the 2 rows alone (a group of 2) gives other
    outputs, so a rank that routed alone would fail here."""
    from repro_torch.core.moe import moe_apply

    ranks, _, _ = runs
    cfg, ffn, x = _moe_case()
    with torch.no_grad():
        for d in ("gather", "sorted"):
            want = moe_apply(ffn, x, cfg, cfg.moe, dispatch=d)[0]
            for r, got in enumerate(ranks):
                i, n = got["rows"]
                lo, hi = i * 4 // n, (i + 1) * 4 // n
                torch.testing.assert_close(got["moe"][d], want[lo:hi],
                                           rtol=RTOL, atol=ATOL)
            alone = torch.cat([moe_apply(ffn, x[lo:lo + 2], cfg, cfg.moe,
                                         dispatch=d)[0] for lo in (0, 2)])
            assert (alone - want).abs().max() > 1e-3, d


def _payloads(case, step):
    """The dry run's payloads of a case's step (4 bytes an element)."""
    from repro_torch.launch.dryrun import rules_collective_payloads

    cfg = _cfg(case)
    B, plen = len(PROMPT_LENS), max(PROMPT_LENS)
    mesh = dict(zip(("data", "model"), MESH))
    if case == "paged":
        kind = "mixed"
        kw = dict(tokens=PAGED["max_batch"] + PAGED["chunk_size"],
                  logits_rows=PAGED["max_batch"] + 1)
        dispatch = "sorted"
    else:
        kind = ("prefill", "decode")[step]
        kw = dict(tokens=B * (plen if step == 0 else 1), batch=B,
                  cache_len=plen + STATIC[case])
        dispatch = "gather"
    return rules_collective_payloads(
        cfg, params=None, mesh=mesh, dispatch=dispatch, remat="none",
        itemsize=4, kind=kind, **kw)


@pytest.mark.parametrize("case", ["seq", "heads", "vocab", "paged"])
def test_collective_bytes_match_the_dry_run(runs, case):
    """Every kind of collective's payload each rank counted in a static
    prefill and the first decode step, or the first mixed step, equals
    the dry run's model; the static cache's k/v (and q) gathers, the
    combine and the MoE's row gathers are nonzero where they run."""
    ranks, _, _ = runs
    for r, got in enumerate(ranks):
        counts = got[case]["counts"]
        steps = [counts] if case == "paged" else counts
        for step, c in enumerate(steps):
            want = _payloads(case, step)
            assert c == want, (case, r, step)
            assert want["tp_all_reduce"] > 0
    if case in ("seq", "vocab"):
        dec = _payloads(case, 1)
        assert dec["cache_all_gather"] > 0 and dec["softmax_combine"] > 0
        assert dec["row_all_gather"] > 0
    if case == "vocab":
        assert _payloads(case, 1)["logits_all_gather"] > 0


def test_dry_run_serve_cells_count_collectives():
    """A decode cell's modelled collectives on a mesh with model > 1 are
    nonzero: granite's decode_32k-like step over (data 2, model 2)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import collective_bytes

    cfg = get_config(GRANITE)
    for kind in ("prefill", "decode"):
        coll = collective_bytes(
            cfg, kind=kind, params=None, dispatch="gather", remat="none",
            mesh={"data": 2, "model": 2}, tokens=0, itemsize=2, batch=8,
            seq=1024)
        assert coll["bytes"] > 0, kind
        assert coll["payloads"]["tp_all_reduce"] > 0
        if kind == "decode":
            assert coll["payloads"]["softmax_combine"] > 0


def test_rwkv_under_a_serving_mesh_raises(runs):
    """Every decoder-only and encoder-decoder stack serves under a mesh:
    the ranks' ``ServeEngine`` places a mamba stack (its ssm state
    (layer, rows, d_in, d_state) the rank's 2 of 4 rows and 64 of 128
    inner channels), ``serve_layout`` places mamba and encoder-decoder
    stacks (rwkv stacks serve: ``tests/test_torch_mesh_rwkv.py``); an
    encoder-only stack has no serving path and raises."""
    ranks, _, _ = runs
    for got in ranks:
        assert got["rwkv"] == (1, 2, 64, 8)
    from repro_torch.sharding import ShardCtx, serve_layout

    ctx = ShardCtx.for_mesh({"data": 2, "model": 2})
    for arch in ("jamba-1.5-large-398b", "t5-base-upcycled"):
        assert serve_layout(ctx, get_reduced(arch)).ctx.tensor_parallel
    with pytest.raises(NotImplementedError, match="encoder_only"):
        serve_layout(ctx, get_reduced("vit-b16-upcycled"))


def test_unservable_placements_raise():
    """``serve_tp``'s weight-stationary experts (``mlp`` over data once
    ``expert`` takes model) now serve (``tests/test_torch_mesh_serve_tp.
    py``); a dim over model together with another axis in one entry and
    paged pools whose KV heads do not split over model still raise
    ``ValueError`` naming the leaf and its spec."""
    from repro_torch.launch.specs import PROFILES, make_ctx
    from repro_torch.sharding import ShardCtx, serve_layout

    cfg = _cfg()
    tp = make_ctx({"data": 2, "model": 2}, cfg, PROFILES["serve_tp"])
    lay = serve_layout(tp, cfg)
    assert lay.ctx.serve.expert_axes == ("data",)
    assert tuple(lay.specs["stack"]["segments"][0]["pos0"]["ffn"]
                 ["experts"]["wi"]) == (None, "model", None, "data")
    both = ShardCtx.for_mesh({"data": 2, "model": 2},
                             overrides={"heads": (("model", "data"),)})
    with pytest.raises(ValueError,
                       match=r"mixer/wo .*heads dim over \('model', 'data'\)"):
        serve_layout(both, cfg)
    pools = zoo.init_paged_serve_cache(cfg, 4, 8, device="meta")
    with pytest.raises(ValueError, match="2 KV heads do not split over 4"):
        serve_layout(ShardCtx.for_mesh({"data": 1, "model": 4}), cfg,
                     cache=pools, paged=True)


def _attention_archs():
    from repro_torch.configs import get_config, list_configs
    from repro_torch.models import stack as stk

    return [n for n in list_configs()
            if get_config(n).structure == "decoder_only"
            and {d.mixer for d in stk.layer_descs(get_config(n))}
            == {"attn"}]


_JAX_TREES = {}


def _jax_trees(arch):
    """The reference's (param shapes, param axes, {S: cache shapes}) of
    an arch on the abstract device, built once."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import model_zoo as jzoo
    from repro.models import param as jpm

    if arch not in _JAX_TREES:
        jcfg = jget(arch)
        sds, axes = jpm.split(jax.eval_shape(
            lambda: jzoo.init_params(jax.random.PRNGKey(0), jcfg)))
        caches = {S: jax.eval_shape(lambda: jzoo.init_serve_cache(
            jcfg, 8, S, dtype=jnp.bfloat16)) for S in (1024, 1023)}
        _JAX_TREES[arch] = (jcfg, sds, axes, caches,
                            jzoo.serve_cache_axes(jcfg))
    return _JAX_TREES[arch]


@pytest.mark.parametrize("shape", [(2, 2), (16, 16)])
def test_serve_layout_specs_match_the_reference(shape):
    """Every registered attention arch (full config): each weight's spec
    and the static cache's at an even and an odd length equal the
    reference's ``spec_for`` under its param and act rules, as its
    dry run places a serving cell's inputs."""
    import types

    import jax
    from repro.sharding import logical as jlog
    from repro_torch.configs import get_config
    from repro_torch.sharding import ShardCtx, serve_layout

    mesh = dict(zip(("data", "model"), shape))
    jmesh = types.SimpleNamespace(shape=mesh, axis_names=tuple(mesh))

    def jspecs(axes, shapes, rules):
        return jax.tree.map(
            lambda a, s: tuple(jlog.spec_for(a, s.shape, jmesh, rules)),
            axes, shapes)

    for arch in _attention_archs():
        jcfg, sds, axes, caches, cache_axes = _jax_trees(arch)
        over = dict(jcfg.sharding_overrides or {}) or None
        prules = jlog.make_rules(jmesh, params=True, overrides=over)
        arules = jlog.make_rules(jmesh, params=False)
        cfg = get_config(arch)
        ctx = ShardCtx.for_mesh(mesh, cfg=cfg)
        lay = serve_layout(ctx, cfg)
        want = jspecs(axes, sds, prules)
        assert _flat(lay.specs) == _flat(want), (arch, shape)
        for S, csds in caches.items():
            want = jspecs(cache_axes, csds, arules)
            meta = zoo.init_serve_cache(cfg, 8, S, device="meta")
            got = lay.for_cache(meta).cache_specs
            assert _flat(got) == _flat(want), (arch, shape, S)


def test_combine_equals_one_softmax():
    """Partial softmaxes over 4 blocks of a 24-position cache, combined
    by log-sum-exp, equal the softmax over the whole sequence for every
    query length: blocks past it hold no valid position (max -inf, sum
    0), weigh 0 and give no NaN."""
    from repro_torch.models.attention import (
        _decode_attention,
        combine_partials,
        decode_partial,
    )

    g = torch.Generator().manual_seed(2)
    q = torch.randn(3, 1, 4, 16, generator=g)
    k = torch.randn(3, 24, 2, 16, generator=g) * 3
    v = torch.randn(3, 24, 2, 16, generator=g)
    for kv_len in (1, 5, 6, 7, 13, 24):
        parts = [decode_partial(q, k[:, lo:lo + 6], v[:, lo:lo + 6],
                                min(max(kv_len - lo, 0), 6))
                 for lo in range(0, 24, 6)]
        u, mx, l = (torch.stack(t) for t in zip(*parts))
        y = combine_partials(u, mx, l).reshape(3, 1, 4, 16)
        assert torch.isfinite(y).all()
        torch.testing.assert_close(y, _decode_attention(q, k, v, kv_len),
                                   rtol=1e-5, atol=1e-6)


def test_one_process_serving_is_unchanged():
    """``ctx=None`` and a ctx without process groups (the dry run's)
    serve bit for bit as an engine built without one, static and
    paged."""
    from repro_torch.sharding import ShardCtx

    cfg = _cfg()
    params = zoo.init_params(0, cfg, device="cpu")
    nogroups = ShardCtx.for_mesh({"data": 2, "model": 2})
    for sc in (ServeConfig(max_batch=4), ServeConfig(paged=True, **PAGED)):
        outs = []
        for kw in ({}, {"ctx": None}, {"ctx": nogroups}):
            eng = ServeEngine(params, cfg, sc, device="cpu", **kw)
            if sc.paged:
                outs.append(eng.serve([Request(**r) for r in
                                       _requests()[:2]])[0])
            else:
                outs.append(eng.generate(_prompts()[:2], 3))
        assert outs[0] == outs[1] == outs[2]
    with torch.no_grad():
        cache = zoo.init_serve_cache(cfg, 2, 8, dtype=torch.float32,
                                     device="cpu")
        toks = {"tokens": torch.tensor(_prompts()[1][:5])[None].repeat(2, 1)}
        _, a = zoo.prefill(params, toks, cache, cfg)
        cache = zoo.init_serve_cache(cfg, 2, 8, dtype=torch.float32,
                                     device="cpu")
        _, b = zoo.prefill(params, toks, cache, cfg, ctx=nogroups)
    assert torch.equal(a, b)
