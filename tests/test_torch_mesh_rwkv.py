"""rwkv6 and expert parallelism under a serving mesh on ``gloo`` ranks on
the CPU: ``ServeEngine(ctx=)`` on (data=2, model=2).

``get_reduced("rwkv6-7b")`` (d 64, 4 heads of 16, 4 layers, vocab 256)
at random weights from seed 0 (conditioned: :func:`_params`), and the
same with a channel-mix MoE (``with_moe``: 4 experts top-2 every other
layer, dropless), serve
through the static engine with the reference's placement
(``sharding.serve_layout``): each rank its 2 of the 4 heads of the time
mix (``wr``, ``wk``, ``wv``, ``wg``, ``u``; ``wo`` row parallel), the
WKV state its rows (over data) and heads (over model), ``x_prev``
replicated over model; the FFN tensor parallel, the MoE's 2 of 4
experts a rank, a decode step's rows routed as the global batch's
groups. 4 prompts of 5-11 tokens, 5 new. The tokens equal the
reference's ``ServeEngine(ctx=)`` on a forced 4-device (2, 2) debug mesh
(a subprocess) on every rank; each teacher-forced step's logits are
within rtol 1e-4, atol 1e-5 of the port's one process; each rank's WKV
state and ``x_prev`` at the end are its blocks of the one process's
(atol 1e-4); each kind of collective's payload in a prefill and a
decode step equals ``launch/dryrun.rules_collective_payloads``. On
(data=1, model=4) the dense stack runs one head a rank against one
process.

``get_reduced("granite-moe-1b-a400m")`` with ``moe.ep="a2a"``: the static
engine (gather dispatch) gives the reference's tokens; the paged
engine's first step of one request is one routing group, which 4 ranks
cannot split: the reference's ``ValueError``, raised by both; with
routing groups of 4 tokens a paged step of 16 rows is 4 groups, one a
rank through the all-to-all, and the engine serves the one process's
tokens. ``serve_layout`` places mamba and encoder-decoder stacks too. One spawn of 4 ranks and two reference
subprocesses; the ranks import torch and the port only.
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

from repro_torch.configs import MoECfg, get_reduced
from repro_torch.models import model_zoo as zoo
from repro_torch.serve import Request, ServeConfig, ServeEngine
from torch_threads import one_thread  # noqa: F401 (autouse)

WORLD = 4
PROMPT_LENS = (9, 5, 11, 7)
NEW = 5
# The caches at the end: the serving parity tests' cache tolerance
# (tests/test_torch_mesh_serve.py's pools).
RTOL, ATOL, STATE_ATOL = 1e-4, 1e-5, 1e-4
STATIC = ("rwkv", "rwkv_moe", "granite_a2a")
PAGED = dict(paged=True, max_batch=4, max_len=64, block_size=8,
             chunk_size=12)


def _cfg(case):
    if case.startswith("rwkv"):
        cfg = get_reduced("rwkv6-7b")
        if case == "rwkv_moe":
            cfg = cfg.with_moe(MoECfg(num_experts=4, router="top_k"))
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
        return cfg
    cfg = get_reduced("granite-moe-1b-a400m")
    moe = dataclasses.replace(cfg.moe, ep="a2a")
    if case == "granite_paged_ep":
        moe = dataclasses.replace(moe, group_size=4)
    return dataclasses.replace(cfg, moe=moe)


def _params(case):
    """Random weights from seed 0; an rwkv stack's conditioned as
    ``chip_smoke.condition_rwkv`` does (``w0`` interleaved over the
    heads, ``wr``, ``wk``, ``wv``, ``wg`` at fan-in d): at the
    reference's init two float32 orders of the same sums part by more
    than the tolerances below (``tests/test_torch_rwkv.py``)."""
    cfg = _cfg(case)
    params = zoo.init_params(0, cfg, device="cpu")
    if case.startswith("rwkv"):
        K, d = cfg.ssm.head_size, cfg.d_model
        H = d // K
        for seg in params["stack"]["segments"]:
            for pos in seg.values():
                m = pos["mixer"]
                reps = m["w0"].shape[0]
                m["w0"].copy_(m["w0"].reshape(reps, H, K).transpose(1, 2)
                              .reshape(reps, d))
                for n in ("wr", "wk", "wv", "wg"):
                    m[n] *= (H / d) ** 0.5
    return params


def _prompts():
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(1, 256, size=n)]
            for n in PROMPT_LENS]


def _requests():
    return [dict(rid=i, prompt=p, max_new=4, arrival=i)
            for i, p in enumerate(_prompts()[:3])]


def _static_steps(eng, prompts, tokens):
    """The static engine's steps teacher-forced on ``tokens``: (logits of
    the prefill and each decode step, the rank's cache at the end, its
    rows, the collective payloads counted in the prefill and the first
    decode step)."""
    from repro_torch.sharding import comm

    cfg, B = eng.cfg, len(prompts)
    plen = max(map(len, prompts))
    toks = torch.zeros((B, plen), dtype=torch.long)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p)
    gen = torch.tensor([t[len(p):] for t, p in zip(tokens, prompts)])
    cache, ctx, (lo, hi) = eng.static_cache(B, plen + NEW)
    counts = []
    with torch.no_grad():
        comm.reset_counts()
        cache, lg = zoo.prefill(eng.params, {"tokens": toks[lo:hi]}, cache,
                                cfg, ac=eng.ac, ctx=ctx)
        counts.append(comm.counts())
        logits = [lg[:, -1].numpy()]
        for t in range(NEW - 1):
            comm.reset_counts()
            cache, lg = zoo.decode_step(eng.params, gen[lo:hi, t:t + 1],
                                        cache, plen + t, cfg, ac=eng.ac,
                                        ctx=ctx)
            counts.append(comm.counts())
            logits.append(lg[:, -1].numpy())
    return logits, cache, (lo, hi), counts[:2]


def _engines(ctx, cases=STATIC + ("paged", "granite_paged_ep")):
    """Each case's results on this process (``ctx`` None: one
    process)."""
    out = {}
    for case in cases:
        if case in ("paged", "granite_paged_ep"):
            cfg = _cfg(case)
            eng = ServeEngine(_params(case), cfg, ServeConfig(**PAGED),
                              device="cpu", ctx=ctx)
            try:
                outs, _ = eng.serve([Request(**r) for r in (
                    _requests()[:1] if case == "paged" else _requests())])
                out[case] = {str(k): v for k, v in outs.items()}
            except ValueError as e:
                out[case] = f"ValueError: {e}"
            continue
        cfg = _cfg(case.replace("_m4", ""))
        eng = ServeEngine(_params(case.replace("_m4", "")), cfg,
                          ServeConfig(max_batch=4), device="cpu", ctx=ctx)
        toks = eng.generate(_prompts(), NEW)
        logits, cache, rows, counts = _static_steps(eng, _prompts(), toks)
        out[case] = {"tokens": toks, "logits": logits, "rows": rows,
                     "counts": counts}
        if case.startswith("rwkv"):
            layer = cache["stack"]["segments"][0]["pos0"]
            out[case]["state"] = {"wkv": layer["mixer"]["wkv"].clone(),
                                  "x_prev": layer["mixer"]["x_prev"].clone()}
    return out


def _worker(rank, world, tmp):
    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world)
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding import ShardCtx

    ctx = ShardCtx.for_mesh(make_debug_mesh((2, 2), ("data", "model")))
    out = _engines(ctx)
    out.update(_engines(ShardCtx.for_mesh(make_debug_mesh(
        (1, WORLD), ("data", "model"))), cases=("rwkv_m4",)))
    out["model_rank"] = ctx.coord("model")
    torch.save(out, f"{tmp}/rank{rank}.pt")
    dist.destroy_process_group()


REFERENCE = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import MoECfg, get_reduced
    from repro.launch.mesh import make_debug_mesh
    from repro.models import model_zoo as zoo
    from repro.models import param as pm
    from repro.serve import Request, ServeConfig, ServeEngine
    from repro.sharding import ShardCtx

    tmp, part = sys.argv[1:]
    spec = json.load(open(f"{tmp}/spec.json"))

    def config(case):
        if case.startswith("rwkv"):
            cfg = get_reduced("rwkv6-7b")
            if case == "rwkv_moe":
                cfg = cfg.with_moe(MoECfg(num_experts=4, router="top_k"))
                cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                    cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
            return cfg
        cfg = get_reduced("granite-moe-1b-a400m")
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, ep="a2a"))

    name = lambda p: "/".join(
        str(getattr(k, "key", getattr(k, "idx", None))) for k in p)
    ctx = ShardCtx.for_mesh(make_debug_mesh((2, 2), ("data", "model")))
    out = {}
    for case in spec["parts"][part]:
        cfg = config(case if case != "paged" else "granite_a2a")
        z = np.load(f"{tmp}/{case if case != 'paged' else 'granite_a2a'}"
                    ".npz")
        vals, _ = pm.split(jax.eval_shape(
            lambda: zoo.init_params(jax.random.PRNGKey(0), cfg)))
        vals = jax.tree_util.tree_map_with_path(
            lambda p, _: jnp.asarray(z[name(p)]), vals)
        if case == "paged":
            eng = ServeEngine(vals, cfg, ServeConfig(**spec["paged"]),
                              ctx=ctx)
            try:
                eng.serve([Request(**r) for r in spec["requests"][:1]])
                out[case] = None
            except ValueError as e:
                out[case] = f"ValueError: {e}"
            continue
        eng = ServeEngine(vals, cfg, ServeConfig(max_batch=4), ctx=ctx)
        out[case] = eng.generate(spec["prompts"], spec["new"])
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
    """(the ranks' results, the one process's, the reference's). The
    reference runs in two subprocesses and the one process here while
    the ranks run."""
    from repro_torch.models.convert import to_jax_values

    tmp = str(tmp_path_factory.mktemp("mesh_rwkv"))
    for case in STATIC:
        np.savez(f"{tmp}/{case}.npz", **_flat(to_jax_values(
            _params(case))))
    parts = {"a": ["rwkv", "rwkv_moe"], "b": ["granite_a2a", "paged"]}
    with open(f"{tmp}/spec.json", "w") as f:
        json.dump({"parts": parts, "prompts": _prompts(), "new": NEW,
                   "requests": _requests(), "paged": PAGED}, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   ["src", os.environ.get("PYTHONPATH", "")]))
    refs = [subprocess.Popen([sys.executable, "-c", REFERENCE, tmp, part],
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE) for part in parts]
    procs = torch.multiprocessing.start_processes(
        _worker, args=(WORLD, tmp), nprocs=WORLD, join=False,
        start_method="spawn")
    try:
        one = _engines(None)
        while not procs.join():
            pass
    finally:
        errs = [ref.communicate(timeout=300)[1] for ref in refs]
    for ref, err in zip(refs, errs):
        assert ref.returncode == 0, err.decode()[-3000:]
    ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    want = {}
    for part in parts:
        with open(f"{tmp}/ref_{part}.json") as f:
            want.update(json.load(f))
    return ranks, one, want


def _close(got, want, what):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} step {i}")


@pytest.mark.parametrize("case", STATIC)
def test_static_engine_matches_reference_and_one_process(runs, case):
    """Tokens equal the reference's ``ServeEngine(ctx=)`` on every rank;
    each step's logits (every row's, on every rank) within tolerance of
    one process."""
    ranks, one, ref = runs
    for r, got in enumerate(ranks):
        assert got[case]["tokens"] == ref[case], (case, r)
        _close(got[case]["logits"], one[case]["logits"], f"{case} rank {r}")
    assert one[case]["tokens"] == ref[case]


@pytest.mark.parametrize("case", ["rwkv", "rwkv_moe", "rwkv_m4"])
def test_rwkv_state_is_the_ranks_block(runs, case):
    """Each rank's WKV state (layer, rows, heads, K, K) at the end is its
    rows' and heads' block of one process's; its ``x_prev`` its rows'
    (replicated over model). ``rwkv_m4``: one head a rank on (1, 4)."""
    ranks, one, _ = runs
    want = one[case.replace("_m4", "")]["state"]
    for r, got in enumerate(ranks):
        lo, hi = got[case]["rows"]
        st = got[case]["state"]
        hl = st["wkv"].shape[2]
        m = r % (WORLD if case == "rwkv_m4" else 2)
        assert hl == want["wkv"].shape[2] // (4 if case == "rwkv_m4" else 2)
        torch.testing.assert_close(
            st["wkv"], want["wkv"][:, lo:hi, m * hl:(m + 1) * hl],
            rtol=0, atol=STATE_ATOL)
        torch.testing.assert_close(st["x_prev"], want["x_prev"][:, lo:hi],
                                   rtol=0, atol=STATE_ATOL)


def test_rwkv_one_head_a_rank_matches_one_process(runs):
    ranks, one, _ = runs
    for r, got in enumerate(ranks):
        assert got["rwkv_m4"]["tokens"] == one["rwkv"]["tokens"], r
        _close(got["rwkv_m4"]["logits"], one["rwkv"]["logits"],
               f"rwkv_m4 rank {r}")


def test_paged_a2a_raises_where_the_reference_raises(runs):
    """One request's first chunk is one routing group: 4 ranks cannot
    split it, and the reference's error names the same counts."""
    ranks, one, ref = runs
    assert ref["paged"] is not None and "G=1 groups" in ref["paged"]
    for got in ranks:
        assert got["paged"] == ref["paged"]
    assert isinstance(one["paged"], dict)  # one process has no mesh


def test_paged_a2a_runs_expert_parallel_where_groups_divide(runs):
    """Routing groups of 4: each 16-row step is 4 groups, one a rank
    through the all-to-all; the same tokens as one process."""
    ranks, one, _ = runs
    for got in ranks:
        assert got["granite_paged_ep"] == one["granite_paged_ep"]


@pytest.mark.parametrize("case", ["rwkv", "rwkv_moe"])
def test_collective_payloads_match_the_dry_run(runs, case):
    """Each kind of collective's payload every rank counted in the static
    prefill and the first decode step equals the dry run's model: the
    time mix's and the FFN's all-reduces, the vocab-parallel lookup, the
    MoE's row gathers and the logits' gathers."""
    from repro_torch.launch.dryrun import rules_collective_payloads

    ranks, _, _ = runs
    B, plen = len(PROMPT_LENS), max(PROMPT_LENS)
    want = [rules_collective_payloads(
        _cfg(case), params=None, mesh={"data": 2, "model": 2},
        dispatch="gather", remat="none", itemsize=4, kind=kind,
        tokens=B * (plen if kind == "prefill" else 1), batch=B,
        cache_len=plen + NEW) for kind in ("prefill", "decode")]
    for r, got in enumerate(ranks):
        assert got[case]["counts"] == want, (case, r)
    assert want[0]["tp_all_reduce"] > 0
    assert (want[1]["row_all_gather"] > 0) == (case == "rwkv_moe")


def test_mamba_and_encoder_decoder_still_raise():
    """``serve_layout`` places mamba and encoder-decoder stacks as it
    places rwkv's (they are served: ``tests/test_torch_mesh_mamba.py``,
    ``tests/test_torch_mesh_encdec.py``): a mamba layer's conv window and
    state split their rows over data and ``d_in`` over model, an
    encoder-decoder's ``cache["enc"]`` its rows over data."""
    from repro_torch.sharding import ShardCtx, serve_layout

    ctx = ShardCtx.for_mesh({"data": 2, "model": 2})
    for arch in ("jamba-1.5-large-398b", "t5-base-upcycled", "rwkv6-7b"):
        cfg = get_reduced(arch)
        meta = zoo.init_serve_cache(cfg, 4, 16, dtype=torch.float32,
                                    device="meta", enc_len=8)
        lay = serve_layout(ctx, cfg, cache=meta)
        assert lay.ctx.serve.batch_axes == ("data",), arch
        if arch.startswith("jamba"):
            mixer = lay.cache_specs["stack"]["segments"][0]["pos0"]["mixer"]
            assert mixer == {"conv": (None, "data", None, "model"),
                             "ssm": (None, "data", "model")}
            assert lay.ctx.serve.cache == "seq"  # its attention layer
        if arch.startswith("t5"):
            assert lay.cache_specs["enc"] == ("data",)
