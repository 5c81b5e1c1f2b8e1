"""The paper's encoder-decoders under the rules' placement on ``gloo``
ranks on the CPU: a train step and greedy decoding on (data=2,
model=2).

Training (``tests/torch_mesh_steps.py``): reduced T5 upcycled from its
dense parent (Expert Choice encoder over 4 experts, top-2 decoder,
gather dispatch, 2 experts a rank) and reduced whisper (the frame
frontend) take one ``make_train_step`` step under ``train_layout`` on a
global batch of 8 x 32 encoder positions and 8 x 8 decoder tokens,
against the reference's jitted ``make_train_step(ctx=)`` on a forced
4-device (2, 2) mesh (loss rtol 2e-4, every parameter atol 2e-4 and
rtol 2e-3) and against the port's one process (every leaf of the state,
the optimizer's slots included, at the same tolerances; the reduced
gradients within 1e-3 of each leaf's largest). T5's routing groups are
32 tokens, so each data rank holds whole groups (4 x 32 encoder, 4 x 8
decoder tokens); at the reduced config's 64 a data rank holds half a
decoder group and the step raises ``ValueError``. The bytes every rank
counts through each kind of collective equal
``launch/dryrun.rules_collective_payloads``.

Decoding: both models (T5 at groups of 32; attention at fan-in d, as
``chip_smoke.condition_attention``) encode 4 rows of 16 positions and
decode greedily from 3-token prompts, 4 new, through ``zoo.prefill`` /
``zoo.decode_step`` under ``sharding.serve_layout``: the encoder tensor
parallel, ``cache["enc"]`` the rank's rows, the decoder's self-attention
cache ``cache_seq`` over model, cross attention on the rank's heads.
The tokens equal the reference's ``prefill`` / ``decode_step(ctx=)`` on
every rank; each step's logits are within rtol 1e-4, atol 1e-5 of the
port's one process; the payloads equal the dry run's. One spawn of 4
ranks and two reference subprocesses; the ranks import torch and the
port only.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import torch_mesh_steps as ms
from repro_torch.models import model_zoo as zoo
from torch_threads import one_thread  # noqa: F401 (autouse)

WORLD = 4
TRAIN = ("t5", "whisper")
B, ENC, PLEN, NEW = 4, 16, 3, 4
RTOL, ATOL = 1e-4, 1e-5


def _decode_inputs(case):
    """(cfg, params (conditioned: ``torch_mesh_steps.condition``), the
    encoder's input and the decoder prompts: numpy, seed 1)."""
    cfg, params, _ = ms.setup(case)
    rng = np.random.default_rng(1)
    batch = {"dec_tokens": rng.integers(1, 256, size=(B, PLEN))}
    if cfg.frontend == "frame":
        batch["frames"] = rng.normal(size=(B, ENC, cfg.d_model)).astype(
            np.float32)
    else:
        batch["enc_tokens"] = rng.integers(1, 256, size=(B, ENC))
    return cfg, params, batch


def _greedy(case, ctx):
    """Greedy decoding of a case on this process: (tokens (B, NEW),
    logits of each step, payloads of the prefill and the first decode
    step). ``ctx`` None: one process."""
    from repro_torch.sharding import comm, serve_layout

    cfg, params, batch = _decode_inputs(case)
    meta = zoo.init_serve_cache(cfg, B, PLEN + NEW, dtype=torch.float32,
                                device="meta", enc_len=ENC)
    if ctx is None:
        cache = zoo.init_serve_cache(cfg, B, PLEN + NEW,
                                     dtype=torch.float32, device="cpu",
                                     enc_len=ENC)
        sctx, lo, hi = None, 0, B
    else:
        lay = serve_layout(ctx, cfg, params, cache=meta)
        params, cache, sctx = lay.place(params), lay.alloc(meta), lay.ctx
        i, n = lay.rows()
        lo, hi = i * B // n, (i + 1) * B // n
    batch = {k: torch.from_numpy(v[lo:hi]) for k, v in batch.items()}
    toks, logits, counts = [], [], []
    with torch.no_grad():
        comm.reset_counts()
        cache, lg = zoo.prefill(params, batch, cache, cfg, ctx=sctx)
        counts.append(comm.counts())
        for t in range(NEW):
            logits.append(lg[:, -1].numpy())
            cur = lg[:, -1].argmax(-1)
            toks.append(cur.tolist())
            if t == NEW - 1:
                break
            comm.reset_counts()
            cache, lg = zoo.decode_step(params, cur[lo:hi, None], cache,
                                        PLEN + t, cfg, ctx=sctx)
            counts.append(comm.counts())
    return {"tokens": np.array(toks).T.tolist(), "logits": logits,
            "counts": counts[:2], "enc_rows": cache["enc"].shape[0]}


def _worker(rank, world, tmp):
    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world)
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding import ShardCtx

    ctx = ShardCtx.for_mesh(make_debug_mesh((2, 2), ("data", "model")))
    out = {case: ms.mesh_step(case, ctx) for case in TRAIN}
    try:
        ms.mesh_step("t5_straddle", ctx)
        out["straddle"] = None
    except ValueError as e:
        out["straddle"] = str(e)
    out["decode"] = {case: _greedy(case, ctx) for case in TRAIN}
    torch.save(out, f"{tmp}/rank{rank}.pt")
    dist.destroy_process_group()


REFERENCE_DECODE = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get_reduced
    from repro.launch.mesh import make_debug_mesh
    from repro.models import model_zoo as zoo
    from repro.models import param as pm
    from repro.sharding import ShardCtx

    tmp, group, *cases = sys.argv[1:]
    spec = json.load(open(f"{tmp}/decode.json"))
    name = lambda p: "/".join(
        str(getattr(k, "key", getattr(k, "idx", None))) for k in p)
    mesh = make_debug_mesh((2, 2), ("data", "model"))
    ctx = ShardCtx.for_mesh(mesh)
    ac = zoo.ApplyCfg(dispatch="gather", moe_impl="xla", attn_impl="xla")
    out = {}
    for case in cases:
        cfg = get_reduced(spec["archs"][case])
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, group_size=int(group)))
        z = np.load(f"{tmp}/dec_{case}_params.npz")
        vals, _ = pm.split(jax.eval_shape(
            lambda: zoo.init_params(jax.random.PRNGKey(0), cfg)))
        vals = jax.tree_util.tree_map_with_path(
            lambda p, _: jnp.asarray(z[name(p)]), vals)
        batch = {k: jnp.asarray(v) for k, v in
                 np.load(f"{tmp}/dec_{case}_batch.npz").items()}
        B, plen, new = spec["B"], spec["plen"], spec["new"]
        cache = zoo.init_serve_cache(cfg, B, plen + new, dtype=jnp.float32,
                                     enc_len=spec["enc"])
        pre = jax.jit(lambda v, b, c: zoo.prefill(v, b, c, cfg, ac=ac,
                                                  ctx=ctx))
        dec = jax.jit(lambda v, t, c, i: zoo.decode_step(
            v, t, c, i, cfg, ac=ac, ctx=ctx))
        toks = []
        with mesh:
            cache, lg = pre(vals, batch, cache)
            for t in range(new):
                cur = jnp.argmax(lg.reshape(B, -1), -1)
                toks.append(np.asarray(cur).tolist())
                if t == new - 1:
                    break
                cache, lg = dec(vals, cur[:, None], cache,
                                jnp.asarray(plen + t, jnp.int32))
        out[case] = np.array(toks).T.tolist()
    json.dump(out, open(f"{tmp}/ref_decode.json", "w"))
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' results, the one process's, the reference's). The
    reference runs in two subprocesses (the train steps; the decoding)
    and the one process here while the ranks run."""
    from repro_torch.models.convert import to_jax_values

    tmp = str(tmp_path_factory.mktemp("mesh_encdec"))
    ms.save_inputs(tmp, TRAIN)
    for case in TRAIN:
        _, params, batch = _decode_inputs(case)
        np.savez(f"{tmp}/dec_{case}_params.npz",
                 **ms.flat(to_jax_values(params)))
        np.savez(f"{tmp}/dec_{case}_batch.npz", **batch)
    with open(f"{tmp}/decode.json", "w") as f:
        json.dump({"archs": ms.ARCHS, "B": B, "plen": PLEN, "new": NEW,
                   "enc": ENC}, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   ["src", os.environ.get("PYTHONPATH", "")]))
    refs = [subprocess.Popen([sys.executable, "-c", script, tmp, *args],
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE)
            for script, args in (
                (ms.REFERENCE, TRAIN),
                (REFERENCE_DECODE, (str(ms.T5_GROUP),) + TRAIN))]
    procs = torch.multiprocessing.start_processes(
        _worker, args=(WORLD, tmp), nprocs=WORLD, join=False,
        start_method="spawn")
    try:
        one = {case: ms.one_step(case) for case in TRAIN}
        one["decode"] = {case: _greedy(case, None) for case in TRAIN}
        while not procs.join():
            pass
    finally:
        errs = [ref.communicate(timeout=600)[1] for ref in refs]
    for ref, err in zip(refs, errs):
        assert ref.returncode == 0, err.decode()[-3000:]
    ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    want = {case: ms.load_reference(tmp, case) for case in TRAIN}
    with open(f"{tmp}/ref_decode.json") as f:
        want["decode"] = json.load(f)
    return ranks, one, want


@pytest.mark.parametrize("case", TRAIN)
def test_mesh_step_matches_reference_and_one_process(runs, case):
    ranks, one, ref = runs
    for got in ranks:
        ms.hold(got[case], one[case], ref[case])


@pytest.mark.parametrize("case", TRAIN)
def test_train_collective_payloads_match_the_dry_run(runs, case):
    """Every kind of collective's payload a rank counted in the step
    equals the dry run's: FSDP's gathers and scatters, the encoder's,
    the decoder's and the cross attention's all-reduces, T5's MoE
    partial sums and router gathers, the vocab-parallel lookups, head
    and cross-entropy."""
    ranks, _, _ = runs
    want = ms.payloads(case)
    for got in ranks:
        assert got[case]["counts"] == want
    assert want["fsdp_all_gather"] > 0 and want["tp_all_reduce"] > 0


def test_t5_groups_straddling_data_ranks_raise(runs):
    """At routing groups of 64, a data rank's 4 x 8 decoder tokens are
    half a group: the single-process step's groups would straddle the
    ranks."""
    ranks, _, _ = runs
    for got in ranks:
        msg = got["straddle"]
        assert msg is not None and "32 tokens" in msg and "64" in msg


@pytest.mark.parametrize("case", TRAIN)
def test_greedy_decoding_matches_reference_and_one_process(runs, case):
    """Tokens equal the reference's ``prefill`` / ``decode_step(ctx=)``
    on every rank; each step's logits (every row's) within tolerance of
    one process; ``cache["enc"]`` holds the rank's 2 rows."""
    ranks, one, ref = runs
    want = one["decode"][case]
    assert want["tokens"] == ref["decode"][case]
    for r, got in enumerate(ranks):
        got = got["decode"][case]
        assert got["tokens"] == ref["decode"][case], r
        assert got["enc_rows"] == B // 2
        for i, (a, b) in enumerate(zip(got["logits"], want["logits"])):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{case} rank {r} step {i}")


@pytest.mark.parametrize("case", TRAIN)
def test_decode_collective_payloads_match_the_dry_run(runs, case):
    """The prefill (the encoder, tensor parallel, and the decoder's
    prompt) and a decode step (cross attention on the rank's heads
    reading ``cache["enc"]``; the self-attention cache's partials
    combined over model) count what the dry run models."""
    from repro_torch.launch.dryrun import rules_collective_payloads

    ranks, _, _ = runs
    cfg = ms.cfg_of(case)
    want = [rules_collective_payloads(
        cfg, params=None, mesh={"data": 2, "model": 2}, dispatch="gather",
        remat="none", itemsize=4, kind=kind,
        tokens=B * (PLEN if kind == "prefill" else 1), batch=B,
        cache_len=PLEN + NEW, enc_len=ENC)
        for kind in ("prefill", "decode")]
    for r, got in enumerate(ranks):
        assert got["decode"][case]["counts"] == want, (case, r)
    assert want[0]["tp_all_reduce"] > want[1]["tp_all_reduce"] > 0
