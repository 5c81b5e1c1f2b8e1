"""jamba's mamba stack under a serving mesh on ``gloo`` ranks on the CPU:
``ServeEngine(ctx=)`` on (data=2, model=2) and (1, 4).

``get_reduced("jamba-1.5-large-398b")`` (d 64, ``d_in`` 128, 8 layers:
7 mamba and one attention, a MoE of 4 experts top-2 every other layer,
vocab 256) at random weights from seed 0 serves through the static
engine with the reference's placement (``sharding.serve_layout``): each
mamba layer tensor parallel over its inner dim (``models/ssm.py``: the
rank's block of ``d_in`` in both halves of ``in_proj``, the conv,
``dt_w``, ``dt_b``, ``A_log``, ``D``, the rows of ``x_proj`` and
``out_proj``; ``x_proj``'s partial products and ``out_proj``'s partial
outputs summed over model), its conv window and state the rank's rows
(over data) and ``d_in`` block (over model); the attention layer's
heads, the FFNs and the MoE's experts over model as for the attention
stacks (its projections at fan-in d, :func:`_params`). 4 prompts of
5-11 tokens, 5 new. The tokens equal the
reference's ``ServeEngine(ctx=)`` on a forced 4-device (2, 2) debug
mesh (a subprocess) on every rank; each teacher-forced step's logits
are within rtol 1e-4, atol 1e-5 of the port's one process; each rank's
conv and ssm caches at the end are its block of the one process's (atol
1e-4); each kind of collective's payload in a prefill and a decode step
equals ``launch/dryrun.rules_collective_payloads`` (no step gathers a
weight). On (1, 4) the stack runs a quarter of ``d_in`` a rank against
one process. One spawn of 4 ranks and one reference subprocess; the
ranks import torch and the port only.
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
from repro_torch.serve import ServeConfig, ServeEngine
from torch_threads import one_thread  # noqa: F401 (autouse)

ARCH = "jamba-1.5-large-398b"
WORLD = 4
PROMPT_LENS = (9, 5, 11, 7)
NEW = 5
RTOL, ATOL, STATE_ATOL = 1e-4, 1e-5, 1e-4
MESHES = {"jamba": (2, 2), "jamba_m4": (1, WORLD)}


def _prompts():
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(1, 256, size=n)]
            for n in PROMPT_LENS]


def _params():
    """Random weights from seed 0, the attention layer's projections
    rescaled to fan-in d (``chip_smoke.condition_attention``): at the
    reference's init (fan-in = the head count) two float32 orders of the
    same sums part by more than the tolerances below."""
    cfg = get_reduced(ARCH)
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


def _static_steps(eng, prompts, tokens):
    """The static engine's steps teacher-forced on ``tokens``: (logits of
    the prefill and each decode step, the rank's cache at the end, its
    rows, the collective payloads of the prefill and the first decode
    step)."""
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


def _mamba_caches(cache):
    """{layer path: {"conv", "ssm"}} of every mamba layer of a cache."""
    out = {}
    for si, seg in enumerate(cache["stack"]["segments"]):
        for pos, layer in seg.items():
            if "ssm" in layer["mixer"]:
                out[f"{si}/{pos}"] = {k: layer["mixer"][k].clone()
                                      for k in ("conv", "ssm")}
    return out


def _engine(ctx):
    """The engine's tokens, teacher-forced logits, mamba caches, rows,
    payloads and its first mamba layer's placed ``in_proj`` (``ctx``
    None: one process)."""
    cfg = get_reduced(ARCH)
    eng = ServeEngine(_params(), cfg, ServeConfig(max_batch=4),
                      device="cpu", ctx=ctx)
    toks = eng.generate(_prompts(), NEW)
    logits, cache, rows, counts = _static_steps(eng, _prompts(), toks)
    in_proj = eng.params["stack"]["segments"][0]["pos0"]["mixer"][
        "in_proj"].clone()
    return {"tokens": toks, "logits": logits, "rows": rows,
            "counts": counts, "caches": _mamba_caches(cache),
            "in_proj": in_proj}


def _worker(rank, world, tmp):
    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world)
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding import ShardCtx

    out = {}
    for case, shape in MESHES.items():
        ctx = ShardCtx.for_mesh(make_debug_mesh(shape, ("data", "model")))
        out[case] = _engine(ctx)
        out[case]["model_rank"] = ctx.coord("model")
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
    from repro.serve import ServeConfig, ServeEngine
    from repro.sharding import ShardCtx

    tmp = sys.argv[1]
    spec = json.load(open(f"{tmp}/spec.json"))
    cfg = get_reduced(spec["arch"])
    z = np.load(f"{tmp}/params.npz")
    name = lambda p: "/".join(
        str(getattr(k, "key", getattr(k, "idx", None))) for k in p)
    vals, _ = pm.split(jax.eval_shape(
        lambda: zoo.init_params(jax.random.PRNGKey(0), cfg)))
    vals = jax.tree_util.tree_map_with_path(
        lambda p, _: jnp.asarray(z[name(p)]), vals)
    ctx = ShardCtx.for_mesh(make_debug_mesh((2, 2), ("data", "model")))
    eng = ServeEngine(vals, cfg, ServeConfig(max_batch=4), ctx=ctx)
    out = eng.generate(spec["prompts"], spec["new"])
    json.dump(out, open(f"{tmp}/ref.json", "w"), default=int)
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

    tmp = str(tmp_path_factory.mktemp("mesh_mamba"))
    cfg = get_reduced(ARCH)
    np.savez(f"{tmp}/params.npz", **_flat(to_jax_values(_params())))
    with open(f"{tmp}/spec.json", "w") as f:
        json.dump({"arch": ARCH, "prompts": _prompts(), "new": NEW}, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   ["src", os.environ.get("PYTHONPATH", "")]))
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, tmp], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    procs = torch.multiprocessing.start_processes(
        _worker, args=(WORLD, tmp), nprocs=WORLD, join=False,
        start_method="spawn")
    try:
        one = _engine(None)
        while not procs.join():
            pass
    finally:
        err = ref.communicate(timeout=300)[1]
    assert ref.returncode == 0, err.decode()[-3000:]
    ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    with open(f"{tmp}/ref.json") as f:
        want = json.load(f)
    return ranks, one, want


def _close(got, want, what):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} step {i}")


def test_static_engine_matches_reference_and_one_process(runs):
    """Tokens equal the reference's ``ServeEngine(ctx=)`` on every rank;
    each step's logits (every row's, on every rank) within tolerance of
    one process."""
    ranks, one, ref = runs
    assert one["tokens"] == ref
    for r, got in enumerate(ranks):
        assert got["jamba"]["tokens"] == ref, r
        _close(got["jamba"]["logits"], one["logits"], f"rank {r}")


def test_quarter_of_d_in_a_rank_matches_one_process(runs):
    """(data=1, model=4): every rank runs 32 of the 128 inner channels
    of each mamba layer and every row."""
    ranks, one, _ = runs
    for r, got in enumerate(ranks):
        got = got["jamba_m4"]
        assert got["tokens"] == one["tokens"], r
        _close(got["logits"], one["logits"], f"(1, 4) rank {r}")
        for c in got["caches"].values():
            assert c["ssm"].shape[2] == c["conv"].shape[3] == 128 // WORLD


@pytest.mark.parametrize("case", list(MESHES))
def test_mamba_caches_are_the_ranks_block(runs, case):
    """Each rank's conv window (layer, rows, d_conv - 1, d_in) and ssm
    state (layer, rows, d_in, d_state) of every mamba layer at the end
    are its rows' and ``d_in`` block's of one process's."""
    ranks, one, _ = runs
    m = MESHES[case][1]
    for r, got in enumerate(ranks):
        got = got[case]
        lo, hi = got["rows"]
        k = got["model_rank"]
        assert set(got["caches"]) == set(one["caches"])
        for layer, c in got["caches"].items():
            want = one["caches"][layer]
            n = want["ssm"].shape[2] // m
            torch.testing.assert_close(
                c["ssm"], want["ssm"][:, lo:hi, k * n:(k + 1) * n],
                rtol=0, atol=STATE_ATOL)
            torch.testing.assert_close(
                c["conv"], want["conv"][:, lo:hi, :, k * n:(k + 1) * n],
                rtol=0, atol=STATE_ATOL)


@pytest.mark.parametrize("case", list(MESHES))
def test_in_proj_holds_the_ranks_block_of_both_halves(runs, case):
    """A rank serves ``in_proj``'s columns ``[r n, (r + 1) n)`` of the x
    half and of the z half (``ssm.tp_block``), as many bytes as the
    rules' block of the leaf; it was exchanged once, at placement."""
    from repro_torch.models.ssm import tp_block

    ranks, one, _ = runs
    m = MESHES[case][1]
    full = _params()["stack"]["segments"][0]["pos0"]["mixer"]["in_proj"]
    L, d, two_din = full.shape
    n = two_din // 2 // m
    for got in ranks:
        k = got[case]["model_rank"]
        mine = got[case]["in_proj"]
        assert mine.numel() == full.numel() // m
        torch.testing.assert_close(mine, tp_block("in_proj", full, k, m),
                                   rtol=0, atol=0)
        torch.testing.assert_close(mine[..., :n],
                                   full[..., k * n:(k + 1) * n],
                                   rtol=0, atol=0)
        torch.testing.assert_close(
            mine[..., n:], full[..., two_din // 2 + k * n:
                                two_din // 2 + (k + 1) * n],
            rtol=0, atol=0)


@pytest.mark.parametrize("case", list(MESHES))
def test_collective_payloads_match_the_dry_run(runs, case):
    """Each kind of collective's payload every rank counted in the static
    prefill and the first decode step equals the dry run's model: each
    mamba layer's two all-reduces, the attention's, the FFNs' and the
    MoE's, the vocab-parallel lookup and the logits' gathers. No step
    gathers a weight."""
    from repro_torch.launch.dryrun import rules_collective_payloads

    ranks, _, _ = runs
    dm = MESHES[case]
    B, plen = len(PROMPT_LENS), max(PROMPT_LENS)
    want = [rules_collective_payloads(
        get_reduced(ARCH), params=None,
        mesh={"data": dm[0], "model": dm[1]}, dispatch="gather",
        remat="none", itemsize=4, kind=kind,
        tokens=B * (plen if kind == "prefill" else 1), batch=B,
        cache_len=plen + NEW) for kind in ("prefill", "decode")]
    for r, got in enumerate(ranks):
        assert got[case]["counts"] == want, (case, r)
    for step in want:
        assert step["tp_all_reduce"] > 0
        assert step["model_all_gather"] == step["fsdp_all_gather"] == 0
