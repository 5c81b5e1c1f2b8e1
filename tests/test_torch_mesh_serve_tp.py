"""The weight-stationary ``serve_tp`` profile served on ``gloo`` ranks on
the CPU: ``ServeEngine(ctx=make_ctx(mesh, cfg, PROFILES["serve_tp"]))``
on a (data=2, model=2) mesh.

Under ``serve_tp`` (``launch/specs.py``: no FSDP, ``embed: ()``, ``mlp``
over ``model`` then ``data``) an expert leaf lies ``('model', None,
'data')``: each rank holds its ``E / 2`` experts' block of d_ff
(``(E/2, d, F/2)`` of ``wi``/``wg``, ``(E/2, F/2, d)`` of ``wo``), the
dense FFNs' d_ff and the heads over ``model`` as under the default
rules. Each rank runs its partial over every row of its data group (a
static batch's rows gathered over ``data``, a paged step's already on
every rank) and the partial outputs are summed over data and model
(``comm.reduce_over``, ``expert_all_reduce``).

Models: ``get_reduced("granite-moe-1b-a400m")`` (8 experts top-4, d_ff
32, random weights from seed 0) through the static engine, its cache's
positions over model (6 new: 22 positions) and its KV heads (5 new: 21),
and through the paged chunked engine (5 requests, three sharing a
prefix); ``get_reduced("jamba-1.5-large-398b")`` (mamba + MoE of 4
experts every other layer, attention at fan-in d) through the static
engine. Each engine's tokens equal the reference's ``ServeEngine(ctx=
make_ctx(mesh, cfg, PROFILES["serve_tp"]))`` on a forced 4-device (2, 2)
debug mesh (subprocesses) on every rank; each teacher-forced step's
logits, and each paged tick's, are within rtol 1e-4, atol 1e-5 of the
port's one process. Every rank's expert leaves are the ``(E/2, d, F/2)``
blocks; building an engine gathers nothing over data (from the global
tree nothing at all; from the rank's blocks only the router, over
model); the bytes each rank counts through each kind of collective in a
prefill, a decode and a mixed step equal ``launch/dryrun.
serve_collective_payloads`` under the profile's rules. Without ranks:
``serve_layout``'s specs under ``serve_tp`` equal the reference's
``spec_for`` for every servable arch on (2, 2) and (16, 16). Granite
also served under the profile's ``pad_heads_multiple`` (its 4 heads
padded to 16): the same tokens, and the padded weights' gathers the dry
run models. One spawn of 4 ranks; the ranks import torch and the port
only.
"""
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
from test_torch_mesh_serve import (
    PAGED,
    PROMPT_LENS,
    _flat,
    _prompts,
    _requests,
    _session,
    _static_steps,
)
from torch_threads import one_thread  # noqa: F401 (autouse)

GRANITE, JAMBA = "granite-moe-1b-a400m", "jamba-1.5-large-398b"
WORLD, MESH = 4, (2, 2)
# max_new: the static cache is 16 + max_new positions (22: cache_seq over
# model; 21: kv_heads).
STATIC = {"seq": 6, "heads": 5}
JAMBA_NEW = 5
RTOL, ATOL = 1e-4, 1e-5
# The profile's query-head padding: the reduced granite's 4 heads (2 a
# model rank) padded to 16, each rank gathering and cutting its padded
# wq and wo a step.
PAD = 16


def _jamba_params():
    """jamba's weights from seed 0, the attention layer's projections at
    fan-in d (as ``tests/test_torch_mesh_mamba.py`` conditions them)."""
    cfg = get_reduced(JAMBA)
    params = zoo.init_params(0, cfg, device="cpu")
    H, Kh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    for seg in params["stack"]["segments"]:
        for pos in seg.values():
            m = pos["mixer"]
            if "wq" in m:
                m["wq"] *= (H / d) ** 0.5
                m["wk"] *= (Kh / d) ** 0.5
                m["wv"] *= (Kh / d) ** 0.5
    return params


def _experts(eng, key="wi"):
    """The shapes of every MoE layer's expert leaf ``key`` an engine
    serves with."""
    return sorted({tuple(pos["ffn"]["experts"][key].shape)
                   for seg in eng.params["stack"]["segments"]
                   for pos in seg.values() if "experts" in pos["ffn"]})


def _engines(ctx, blocks=None):
    """Every case's results on this process (``ctx`` None: one
    process). ``blocks(params, cfg)``: the rank's blocks of the global
    tree, for the build from blocks."""
    from repro_torch.sharding import comm

    out = {}
    prompts = _prompts()
    cfg = get_reduced(GRANITE)
    params = zoo.init_params(0, cfg, device="cpu")
    for case, new in STATIC.items():
        comm.reset_counts()
        eng = ServeEngine(params, cfg, ServeConfig(max_batch=4),
                          device="cpu", ctx=ctx)
        build = comm.counts()
        toks = eng.generate(prompts, new)
        logits, counts = _static_steps(eng, prompts, toks, new)
        out[case] = {"tokens": toks, "logits": logits, "counts": counts,
                     "build": build,
                     "experts": {k: _experts(eng, k)
                                 for k in ("wi", "wg", "wo")}}
    eng = ServeEngine(params, cfg, ServeConfig(max_batch=4), device="cpu",
                      ctx=ctx, ac=zoo.ApplyCfg(pad_heads_multiple=PAD))
    toks = eng.generate(prompts, STATIC["seq"])
    logits, counts = _static_steps(eng, prompts, toks, STATIC["seq"])
    out["padded"] = {"tokens": toks, "logits": logits, "counts": counts}
    eng = ServeEngine(params, cfg, ServeConfig(paged=True, **PAGED),
                      device="cpu", ctx=ctx)
    toks, logits, counts, _, stats = _session(eng)
    out["paged"] = {"tokens": toks, "logits": logits, "counts": counts,
                    "stats": stats}
    if blocks is not None:
        comm.reset_counts()
        eng = ServeEngine(blocks(params, cfg), cfg, ServeConfig(max_batch=4),
                          device="cpu", ctx=ctx)
        out["blocks"] = {"build": comm.counts(),
                         "tokens": eng.generate(prompts, STATIC["seq"]),
                         "experts": _experts(eng)}
    jcfg = get_reduced(JAMBA)
    eng = ServeEngine(_jamba_params(), jcfg, ServeConfig(max_batch=4),
                      device="cpu", ctx=ctx)
    toks = eng.generate(prompts, JAMBA_NEW)
    logits, counts = _static_steps(eng, prompts, toks, JAMBA_NEW)
    out["jamba"] = {"tokens": toks, "logits": logits, "counts": counts,
                    "experts": _experts(eng)}
    return out


def _moe_rows(ctx):
    """A data rank's 2 of 4 decode rows through the reduced granite's
    layer 0 MoE under the profile's serving ctx, both dispatches."""
    from repro_torch.core.moe import moe_apply
    from repro_torch.sharding import serve_layout

    cfg = get_reduced(GRANITE)
    meta = zoo.init_serve_cache(cfg, 4, 22, dtype=torch.float32,
                                device="meta")
    lay = serve_layout(ctx, cfg, cache=meta)
    i, n = lay.rows()
    placed = lay.place(zoo.init_params(0, cfg, device="cpu"))
    ffn = {k: {kk: vv[0] for kk, vv in v.items()} for k, v in
           placed["stack"]["segments"][0]["pos0"]["ffn"].items()}
    x = torch.randn(4, 1, cfg.d_model,
                    generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        return {d: moe_apply(ffn, x[i * 4 // n:(i + 1) * 4 // n], cfg,
                             cfg.moe, dispatch=d, ctx=lay.ctx)[0]
                for d in ("gather", "sorted")}, (i, n)


def _worker(rank, world, tmp):
    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world)
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.specs import PROFILES, make_ctx
    from repro_torch.sharding import _walk as walk
    from repro_torch.sharding import serve_layout, shard_leaf

    mesh = make_debug_mesh(MESH, ("data", "model"))
    ctx = make_ctx(mesh, get_reduced(GRANITE), PROFILES["serve_tp"])

    def blocks(params, cfg):
        """The rank's blocks under the profile's param rules."""
        specs = serve_layout(ctx, cfg).specs
        return walk(lambda t, s, *_: shard_leaf(t, s, ctx), params, specs)

    out = _engines(ctx, blocks)
    out["moe"], out["rows"] = _moe_rows(ctx)
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
    from repro.launch.specs import PROFILES, make_ctx
    from repro.models import model_zoo as zoo
    from repro.models import param as pm
    from repro.serve import Request, ServeConfig, ServeEngine

    tmp, part = sys.argv[1:]
    spec = json.load(open(f"{tmp}/spec.json"))[part]
    cfg = get_reduced(spec["arch"])
    z = np.load(f"{tmp}/{part}.npz")
    vals, _ = pm.split(jax.eval_shape(
        lambda: zoo.init_params(jax.random.PRNGKey(0), cfg)))
    name = lambda p: "/".join(
        str(getattr(k, "key", getattr(k, "idx", None))) for k in p)
    vals = jax.tree_util.tree_map_with_path(
        lambda p, _: jnp.asarray(z[name(p)]), vals)
    mesh = make_debug_mesh((2, 2), ("data", "model"))
    ctx = make_ctx(mesh, cfg, PROFILES["serve_tp"])
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' results, the one process's, the reference's tokens).
    The reference runs in two subprocesses and the one process here
    while the ranks run."""
    from repro_torch.models.convert import to_jax_values

    tmp = str(tmp_path_factory.mktemp("mesh_serve_tp"))
    np.savez(f"{tmp}/granite.npz", **_flat(to_jax_values(
        zoo.init_params(0, get_reduced(GRANITE), device="cpu"))))
    np.savez(f"{tmp}/jamba.npz", **_flat(to_jax_values(_jamba_params())))
    common = {"prompts": _prompts(), "requests": _requests()}
    with open(f"{tmp}/spec.json", "w") as f:
        json.dump({"granite": {**common, "arch": GRANITE, "static": STATIC,
                               "paged": {"paged": PAGED}},
                   "jamba": {**common, "arch": JAMBA, "paged": {},
                             "static": {"jamba": JAMBA_NEW}}}, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   ["src", os.environ.get("PYTHONPATH", "")]))
    refs = [subprocess.Popen([sys.executable, "-c", REFERENCE, tmp, part],
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE)
            for part in ("granite", "jamba")]
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
        assert ref.returncode == 0, err.decode()[-2000:]
    ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    want = {}
    for part in ("granite", "jamba"):
        with open(f"{tmp}/ref_{part}.json") as f:
            want.update(json.load(f))
    return ranks, one, want


def _close(got, want, what):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} step {i}")


@pytest.mark.parametrize("case", ["seq", "heads", "paged", "jamba"])
def test_engines_match_reference_and_one_process(runs, case):
    """Tokens equal the reference's engine under ``serve_tp`` on every
    rank and in one process; each teacher-forced static step's logits
    (every row's, on every rank) and each paged tick's within tolerance
    of one process. ``seq``/``heads``: granite's static cache over model
    by position / by KV head; ``paged``: the chunked engine (one step
    shape, the prefix cache hit); ``jamba``: mamba + MoE, static."""
    ranks, one, ref = runs
    for r, got in enumerate(ranks):
        assert got[case]["tokens"] == ref[case], (case, r)
        _close(got[case]["logits"], one[case]["logits"], f"{case} rank {r}")
        if case == "paged":
            assert got[case]["stats"] == one[case]["stats"]
    assert one[case]["tokens"] == ref[case]
    if case == "paged":
        st = one[case]["stats"]
        assert st["compile_count"] == 1 and st["prefix_hit_frac"] > 0


def test_padded_heads_serve_the_same_tokens(runs):
    """Granite served with its 4 query heads padded to 16 (zero heads,
    exactly preserved outputs) gives the unpadded engine's tokens on
    every rank, its teacher-forced logits within tolerance of the one
    process's padded engine."""
    ranks, one, _ = runs
    assert one["padded"]["tokens"] == one["seq"]["tokens"]
    for r, got in enumerate(ranks):
        assert got["padded"]["tokens"] == got["seq"]["tokens"], r
        _close(got["padded"]["logits"], one["padded"]["logits"],
               f"padded rank {r}")


@pytest.mark.parametrize("arch", [GRANITE, JAMBA])
def test_ranks_hold_their_expert_blocks(runs, arch):
    """Every rank serves with the ``(E/2, d, F/2)`` blocks of ``wi`` and
    ``wg`` and the ``(E/2, F/2, d)`` block of ``wo`` of every MoE layer
    (the stacked layer dim first)."""
    cfg = get_reduced(arch)
    E, d, F = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    for r, got in enumerate(runs[0]):
        if arch == GRANITE:
            L = cfg.n_layers
            want = {"wi": [(L, E // 2, d, F // 2)],
                    "wg": [(L, E // 2, d, F // 2)],
                    "wo": [(L, E // 2, F // 2, d)]}
            assert got["seq"]["experts"] == want, r
            assert got["blocks"]["experts"] == want["wi"], r
        else:
            assert [s[-3:] for s in got["jamba"]["experts"]] == \
                [(E // 2, d, F // 2)], r


@pytest.mark.parametrize("source", ["global", "blocks"])
def test_building_an_engine_gathers_nothing_over_data(runs, source):
    """An engine built from the global tree joins no weight (nothing
    counted); from the rank's blocks under the profile's rules it joins
    only the router's experts over model (the router stays whole), no
    weight over data. Both serve the same tokens."""
    from repro_torch.sharding.comm import KINDS

    cfg = get_reduced(GRANITE)
    L, d, E = cfg.n_layers, cfg.d_model, cfg.moe.num_experts
    for r, got in enumerate(runs[0]):
        if source == "global":
            assert got["seq"]["build"] == dict.fromkeys(KINDS, 0), r
        else:
            build = got["blocks"]["build"]
            assert build["fsdp_all_gather"] == 0, r
            assert build["model_all_gather"] == L * d * E * 4, r
            assert got["blocks"]["tokens"] == got["seq"]["tokens"], r


def test_data_ranks_rows_sum_the_partials(runs):
    """A data rank's 2 of 4 decode rows through layer 0's MoE, each rank
    holding its 4 experts' half of d_ff, give its rows of the one-process
    layer over all 4 rows (gather and sorted dispatch)."""
    from repro_torch.core.moe import moe_apply
    from repro_torch.models.param import tree_map

    cfg = get_reduced(GRANITE)
    params = zoo.init_params(0, cfg, device="cpu")
    ffn = tree_map(lambda t: t[0],
                   params["stack"]["segments"][0]["pos0"]["ffn"])
    x = torch.randn(4, 1, cfg.d_model,
                    generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        for d in ("gather", "sorted"):
            want = moe_apply(ffn, x, cfg, cfg.moe, dispatch=d)[0]
            for r, got in enumerate(runs[0]):
                i, n = got["rows"]
                lo, hi = i * 4 // n, (i + 1) * 4 // n
                torch.testing.assert_close(got["moe"][d], want[lo:hi],
                                           rtol=RTOL, atol=ATOL)


def _payloads(case, step):
    """The dry run's payloads of a case's step under the profile's
    rules (4 bytes an element)."""
    from repro_torch.launch.dryrun import serve_collective_payloads
    from repro_torch.launch.specs import PROFILES, make_ctx

    arch = JAMBA if case == "jamba" else GRANITE
    cfg = get_reduced(arch)
    mesh = dict(zip(("data", "model"), MESH))
    rules = make_ctx(mesh, cfg, PROFILES["serve_tp"]).param_rules
    B, plen = len(PROMPT_LENS), max(PROMPT_LENS)
    if case == "paged":
        return serve_collective_payloads(
            cfg, mesh=mesh, kind="mixed",
            tokens=PAGED["max_batch"] + PAGED["chunk_size"], itemsize=4,
            logits_rows=PAGED["max_batch"] + 1, param_rules=rules)
    new = {"jamba": JAMBA_NEW, "padded": STATIC["seq"]}.get(case) \
        or STATIC[case]
    return serve_collective_payloads(
        cfg, mesh=mesh, kind=("prefill", "decode")[step],
        tokens=B * (plen if step == 0 else 1), itemsize=4, batch=B,
        cache_len=plen + new, param_rules=rules,
        pad_heads_multiple=PAD if case == "padded" else 0)


@pytest.mark.parametrize("case", ["seq", "heads", "paged", "jamba",
                                  "padded"])
def test_collective_bytes_match_the_dry_run(runs, case):
    """Every kind of collective's payload each rank counted in a static
    prefill and its first decode step, or the first mixed step, equals
    the dry run's model under the profile's rules: the rows' gather over
    data and each MoE layer's partial sum over data and model
    (``expert_all_reduce``) in place of the sum over model alone;
    ``padded``: the profile's ``pad_heads_multiple`` (4 heads padded to
    16), each attention layer gathering its wq and wo blocks over model
    a step."""
    cfg = get_reduced(JAMBA if case == "jamba" else GRANITE)
    moe_layers = cfg.n_layers if case != "jamba" else cfg.n_layers // 2
    for r, got in enumerate(runs[0]):
        counts = got[case]["counts"]
        steps = [counts] if case == "paged" else counts
        for step, c in enumerate(steps):
            want = _payloads(case, step)
            assert c == want, (case, r, step)
            # Every row of the step (the data group's), d float32, a
            # MoE layer.
            rows = (PAGED["max_batch"] + PAGED["chunk_size"]
                    if case == "paged" else len(PROMPT_LENS)
                    * (max(PROMPT_LENS) if step == 0 else 1))
            assert want["expert_all_reduce"] == \
                moe_layers * rows * cfg.d_model * 4
            if case != "paged":
                assert want["row_all_gather"] >= \
                    moe_layers * rows * cfg.d_model * 4
            # wq (d, 4, dh) and wo (4, dh, d) whole a layer, float32.
            assert want["fsdp_all_gather"] == (
                cfg.n_layers * 2 * cfg.d_model * cfg.n_heads * cfg.head_dim
                * 4 if case == "padded" else 0)


def test_dry_run_serve_tp_cell_models_its_placement():
    """The dry run's granite ``decode_32k`` cell on the pod mesh (16, 16)
    under ``serve_tp`` against ``optimized`` (44,238,240 B a device):
    both gather the 128 decode rows over data in each of the 24 MoE
    layers (6,291,456 B of payload); ``serve_tp`` sums each layer's
    partial outputs of all 128 rows over data and model (256 ranks:
    262,144 B a layer, 6,291,456 B; a ring sends 2 x 255/256 of it,
    12,533,760 B) where ``optimized`` sums a data rank's 8 rows over
    model (16,384 B a layer, 393,216 B; 2 x 15/16: 737,280 B): 44,238,240
    - 737,280 + 12,533,760 = 56,034,720 B a device."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import collective_bytes
    from repro_torch.launch.specs import PROFILES, make_ctx

    cfg = get_config(GRANITE)
    mesh = {"data": 16, "model": 16}
    rec = {}
    for prof in ("optimized", "serve_tp", "baseline"):
        rec[prof] = collective_bytes(
            cfg, kind="decode", params=None, dispatch="gather",
            remat="none", mesh=mesh, tokens=128 * 32768, itemsize=2,
            batch=128, seq=32768,
            param_rules=make_ctx(mesh, cfg, PROFILES[prof]).param_rules)
    opt, tp = rec["optimized"], rec["serve_tp"]
    assert opt["bytes"] == rec["baseline"]["bytes"] == 44_238_240
    assert tp["bytes"] == 56_034_720 == 44_238_240 - 737_280 + 12_533_760
    diff = {k: v - opt["payloads"][k] for k, v in tp["payloads"].items()
            if v != opt["payloads"][k]}
    assert diff == {"tp_all_reduce": -393_216,
                    "expert_all_reduce": 6_291_456}
    assert tp["payloads"]["row_all_gather"] == \
        opt["payloads"]["row_all_gather"] == 6_291_456


def _servable():
    from repro_torch.configs import get_config, list_configs

    return [n for n in list_configs()
            if get_config(n).structure != "encoder_only"]


@pytest.mark.parametrize("shape", [(2, 2), (16, 16)])
def test_serve_tp_specs_match_the_reference(shape):
    """Every servable arch (full config): each weight's spec under the
    ``serve_tp`` profile's rules equals the reference's ``spec_for``
    under its ``make_ctx(mesh, cfg, PROFILES["serve_tp"])``, and the
    plan's ``expert_axes`` is ``("data",)`` exactly where an expert
    leaf's ``mlp`` lies over data."""
    import types

    import jax
    from repro.configs import get_config as jget
    from repro.launch import specs as jspecs
    from repro.models import model_zoo as jzoo
    from repro.models import param as jpm
    from repro.sharding import logical as jlog
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import PROFILES, make_ctx
    from repro_torch.sharding import serve_layout

    mesh = dict(zip(("data", "model"), shape))
    jmesh = types.SimpleNamespace(shape=mesh, axis_names=tuple(mesh))
    for arch in _servable():
        jcfg = jget(arch)
        sds, axes = jpm.split(jax.eval_shape(
            lambda: jzoo.init_params(jax.random.PRNGKey(0), jcfg)))
        jctx = jspecs.make_ctx(jmesh, jcfg, jspecs.PROFILES["serve_tp"])
        want = jax.tree.map(
            lambda a, s: tuple(jlog.spec_for(a, s.shape, jmesh,
                                             jctx.param_rules)), axes, sds)
        cfg = get_config(arch)
        lay = serve_layout(make_ctx(mesh, cfg, PROFILES["serve_tp"]), cfg)
        got = _flat(lay.specs)
        assert got == _flat(want), (arch, shape)
        over = any("experts" in k and "data" in v for k, v in got.items())
        assert lay.ctx.serve.expert_axes == (("data",) if over else ())
