"""Expert parallelism under the rules engine's placement on ``gloo`` ranks
on the CPU: ``moe.ep="a2a"`` composed with FSDP and tensor parallelism
(``sharding.train_layout`` for a ``tensor_parallel`` ctx, the MoE's
``core/moe._ep_blocks``).

``get_reduced("granite-moe-1b-a400m")`` (4 query / 2 KV heads, 8
experts top-4, vocab 259) upcycled from its dense parent (its attention
rescaled to fan-in d, so that two float32 implementations agree at the
tolerances below), sorted dispatch, ``ep="a2a"`` at budget factor 2.0,
the default rules on (data=2, model=2): ``embed`` over data, heads,
``mlp``, vocab and experts over model. A global batch of 8 x 32 in
routing groups of 64 (G = 4): each data rank's 4 rows are 2 groups,
each ``model`` peer routes both and runs its one group through the
all-to-all with its 4 experts. Adafactor at ``eps1`` 1e-6 (see
``tests/test_torch_mesh_train.py``), 2 steps, against the reference's
jitted ``make_train_step(ctx=)`` on a forced 4-device (2, 2) debug mesh
with its default rules (a subprocess): both losses (rtol 2e-4), the
grad norms (rtol 1e-3) and every leaf of the gathered state after step
1, params and Adafactor slots (atol 2e-4, rtol 2e-3, the reference's
``tests/test_system.py`` distributed step). One MoE layer at budget
factors 2.0 and 0.25 against the reference's ``moe_apply`` under its
ctx: outputs (rtol 1e-4, atol 1e-5) and ``ep_overflow_frac`` equal (0,
then > 0). The meshes (1, 4) (one group and 2 experts a rank, one data
rank) and (4, 1) (no ``model`` axis: the rules' placement without
expert parallelism) against one process. Each kind of collective's
payload a rank counted equals ``launch/dryrun.rules_collective_payloads``;
a global group count that the rank count does not divide raises the
reference's ``ValueError``; a ``Trainer`` on (2, 2) resumes a
one-process checkpoint and writes one that one process restores, and
its 2 steps end where one process's end. One spawn of 4 ranks and one
reference subprocess; the ranks import torch and the port only.
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
from repro_torch.core.upcycle import upcycle_params
from repro_torch.data import make_iterator
from repro_torch.models import model_zoo as zoo
from repro_torch.models.param import tree_map
from repro_torch.optim import adafactor, constant
from repro_torch.training import (
    TrainConfig,
    Trainer,
    init_train_state,
    make_train_step,
)
from torch_threads import one_thread  # noqa: F401 (autouse)

GRANITE = "granite-moe-1b-a400m"
WORLD, BATCH, SEQ, STEPS = 4, 8, 32, 2
AC = zoo.ApplyCfg(dispatch="sorted")
ATOL, RTOL, LOSS_RTOL, GN_RTOL = 2e-4, 2e-3, 2e-4, 1e-3
MOE_RTOL, MOE_ATOL = 1e-4, 1e-5
FACTORS = (2.0, 0.25)


def _cfg(factor=2.0):
    cfg = get_reduced(GRANITE)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, ep="a2a", ep_budget_factor=factor))


def _opt():
    return adafactor(constant(1e-2), eps1=1e-6)


def _params():
    """The upcycled params (dense parent at seed 0, its attention at
    fan-in d; routers from seed 7)."""
    cfg = _cfg()
    dense_cfg = cfg.dense_parent()
    dense = zoo.init_params(0, dense_cfg, device="cpu")
    H, Kh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    for seg in dense["stack"]["segments"]:
        for pos in seg.values():
            m = pos["mixer"]
            m["wq"] *= (H / d) ** 0.5
            m["wk"] *= (Kh / d) ** 0.5
            m["wv"] *= (Kh / d) ** 0.5
    return upcycle_params(dense, dense_cfg, cfg,
                          torch.Generator().manual_seed(7))


def _batches(batch=BATCH):
    it = make_iterator(_cfg(), global_batch=batch, seq_len=SEQ,
                       host_index=0, host_count=1)
    return [next(it) for _ in range(STEPS)]


def _moe_input():
    """Layer 0's MoE params and an input (8, 32, d) from seed 3."""
    ffn = tree_map(lambda t: t[0],
                   _params()["stack"]["segments"][0]["pos0"]["ffn"])
    x = np.random.default_rng(3).normal(
        size=(BATCH, SEQ, _cfg().d_model)).astype(np.float32)
    return ffn, x


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        return {k: v for kk, vv in tree.items()
                for k, v in _flat(vv, f"{pre}/{kk}" if pre else kk).items()}
    if isinstance(tree, list):
        return {k: v for i, vv in enumerate(tree)
                for k, v in _flat(vv, f"{pre}/{i}").items()}
    return {pre: tree}


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _steps(ctx, batches, steps=STEPS):
    """``steps`` steps under ``train_layout(ctx)``: losses, grad norms,
    the EP overflow metric, the first step's payloads and gathered
    state, the layout's token axes."""
    from repro_torch.sharding import comm, train_layout

    cfg, opt = _cfg(), _opt()
    state = init_train_state(None, cfg, opt, params=_params())
    layout = train_layout(ctx, cfg, AC.dispatch, state)
    state = layout.shard(state)
    step = make_train_step(cfg, opt, ac=AC, layout=layout)
    i, n = layout.batch_rows()
    rec = {"loss": [], "grad_norm": [], "over": [],
           "token_axes": layout.token_axes}
    for s in range(steps):
        batch = batches[s]
        per = len(next(iter(batch.values()))) // n
        local = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
        comm.reset_counts()
        state, m = step(state, local)
        rec["loss"].append(float(m["loss"]))
        rec["grad_norm"].append(float(m["grad_norm"]))
        rec["over"].append(float(m["ep_overflow_frac_sum"]))
        if s == 0:
            rec["counts"] = comm.counts()
            # A copy: the step updates the params in place.
            rec["state"] = tree_map(torch.clone, layout.gather(state))
    return rec


def _moe_blocks(ctx, factor):
    """Layer 0's MoE on the data rank's rows of the input, with the
    rank's blocks of its router and experts: (y, ep_overflow_frac)."""
    from repro_torch.core.moe import moe_apply

    ffn, x = _moe_input()
    m, k = ctx.coord("model"), ctx.shape["model"]
    d, D = ctx.coord("data"), ctx.shape["data"]
    E = ffn["router"]["w"].shape[1]
    El = E // k
    local = {"router": {"w": ffn["router"]["w"][:, m * El:(m + 1) * El]},
             "experts": {n: t[m * El:(m + 1) * El]
                         for n, t in ffn["experts"].items()}}
    rows = BATCH // D
    cfg = _cfg(factor)
    with torch.no_grad():
        y, mets = moe_apply(local, torch.from_numpy(
            x[d * rows:(d + 1) * rows]), cfg, cfg.moe, dispatch="sorted",
            ctx=ctx)
    return y.numpy(), float(mets["ep_overflow_frac"])


def _trainer(ckpt, ctx=None, steps=1):
    cfg = _cfg()
    tr = Trainer(cfg, _opt(), make_iterator(cfg, global_batch=BATCH,
                                            seq_len=SEQ), ckpt, ac=AC,
                 tc=TrainConfig(checkpoint_every=1, log_every=1000),
                 log_fn=lambda s: None, device="cpu", ctx=ctx)
    out = tr.run(steps, init_params=_params())
    return tr, out


def _equal(a, b) -> bool:
    """Two trees hold the same tensors under the same key paths (the
    upcycled params order an FFN's keys as the init does not)."""
    a, b = _flat(a), _flat(b)
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def _worker(rank, world, tmp):
    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world)
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding import ShardCtx

    def ctx_of(shape):
        return dataclasses.replace(ShardCtx.for_mesh(make_debug_mesh(
            shape, ("data", "model"))), tensor_parallel=True)

    z = np.load(f"{tmp}/batches.npz")
    batches = [{k.split("/")[1]: z[k] for k in z if k.startswith(f"{s}/")}
               for s in range(STEPS)]
    ctx = ctx_of((2, 2))
    out = {"2x2": _steps(ctx, batches)}
    out["moe"] = {f: _moe_blocks(ctx, f) for f in FACTORS}
    out["coords"] = (ctx.coord("data"), ctx.coord("model"))
    for shape in ((1, 4), (4, 1)):
        out["x".join(map(str, shape))] = _steps(ctx_of(shape), batches, 1)
    small = [{k: v[:4] for k, v in b.items()} for b in batches]
    try:
        _steps(ctx, small, 1)
        out["divisibility"] = None
    except ValueError as e:
        out["divisibility"] = str(e)
    # Checkpoints: resume the one-process run's (written at step 1), and
    # write 2 steps' on the mesh for one process to restore.
    tr, res = _trainer(f"{tmp}/one", ctx)
    restored = tr.layout.gather(res["state"])
    direct, _, _ = CheckpointManager(f"{tmp}/one").restore_latest(
        init_train_state(None, _cfg(), _opt(), device="cpu"))
    out["resumed"] = (tr.stats["resumed_from"], _equal(restored, direct))
    tr, res = _trainer(f"{tmp}/mesh", ctx, steps=STEPS)
    out["trainer"] = tr.layout.gather(res["state"])
    if rank == 0:
        torch.save(out, f"{tmp}/rank0.pt")
    dist.destroy_process_group()


REFERENCE = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get_reduced
    from repro.core.moe import moe_apply
    from repro.launch.mesh import make_debug_mesh
    from repro.models import model_zoo as zoo
    from repro.models import param as pm
    from repro.optim import adafactor, constant
    from repro.sharding import ShardCtx, tree_shardings
    from repro.training.train_loop import (
        init_train_state, make_train_step, state_axes)

    tmp = sys.argv[1]
    z = np.load(f"{tmp}/params.npz")
    b = np.load(f"{tmp}/batches.npz")
    cfg = get_reduced("granite-moe-1b-a400m")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, ep="a2a", ep_budget_factor=2.0))
    name = lambda p: "/".join(
        str(getattr(k, "key", getattr(k, "idx", None))) for k in p)
    vals, _ = pm.split(jax.eval_shape(
        lambda: zoo.init_params(jax.random.PRNGKey(0), cfg)))
    vals = jax.tree_util.tree_map_with_path(
        lambda p, _: jnp.asarray(z[name(p)]), vals)
    mesh = make_debug_mesh((2, 2), ("data", "model"))
    ctx = ShardCtx.for_mesh(mesh)
    opt = adafactor(constant(1e-2), eps1=1e-6)
    state = init_train_state(None, cfg, opt, params=vals)
    state = jax.device_put(state, tree_shardings(
        state_axes(cfg), jax.eval_shape(lambda: state), mesh,
        ctx.param_rules))
    # sorted_block 16 is the port's ragged block.
    ac = zoo.ApplyCfg(dispatch="sorted", sorted_block=16, moe_impl="xla",
                      attn_impl="xla")
    step = jax.jit(make_train_step(cfg, opt, ac=ac, ctx=ctx))
    out = {"loss": [], "grad_norm": []}
    for s in range(2):
        batch = {k.split("/")[1]: b[k] for k in b if k.startswith(f"{s}/")}
        batch = jax.device_put(batch, tree_shardings(
            {k: "batch seq" if v.ndim == 2 else "batch"
             for k, v in batch.items()}, batch, mesh, ctx.act_rules))
        with mesh:
            state, m = step(state, batch)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        if s == 0:
            flat = jax.tree_util.tree_flatten_with_path(
                {"params": state["params"], "opt_state": state["opt_state"]})
            np.savez(f"{tmp}/ref_state.npz",
                     **{name(p): np.asarray(v) for p, v in flat[0]})
    ffn = jax.tree.map(lambda t: t[0],
                       vals["stack"]["segments"][0]["pos0"]["ffn"])
    x = jnp.asarray(np.load(f"{tmp}/x.npy"))
    for f in (2.0, 0.25):
        moe = dataclasses.replace(cfg.moe, ep_budget_factor=f)
        y, m = jax.jit(lambda v, x: moe_apply(
            v, x, cfg, moe, dispatch="sorted", ctx=ctx,
            implementation="xla", sorted_block=16))(ffn, x)
        np.save(f"{tmp}/ref_y_{f}.npy", np.asarray(y))
        out[f"over_{f}"] = float(m["ep_overflow_frac"])
    json.dump(out, open(f"{tmp}/ref.json", "w"))
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank 0's results, the reference's metrics and first-step state,
    one process's steps and 2-step Trainer state). The reference and the
    one-process runs go while the ranks run."""
    from repro_torch.models.convert import to_jax_values

    tmp = str(tmp_path_factory.mktemp("mesh_ep"))
    np.savez(f"{tmp}/params.npz", **_flat(to_jax_values(_params())))
    np.savez(f"{tmp}/batches.npz", **{f"{s}/{k}": v for s, b in
                                      enumerate(_batches())
                                      for k, v in b.items()})
    np.save(f"{tmp}/x.npy", _moe_input()[1])
    _trainer(f"{tmp}/one")  # the checkpoint the ranks resume
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   ["src", os.environ.get("PYTHONPATH", "")]))
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, tmp], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    procs = torch.multiprocessing.start_processes(
        _worker, args=(WORLD, tmp), nprocs=WORLD, join=False,
        start_method="spawn")
    try:
        one = _steps_one()
        one["trainer"] = _trainer(f"{tmp}/one2", steps=STEPS)[1]["state"]
        while not procs.join():
            pass
    finally:
        _, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err.decode()[-3000:]
    with open(f"{tmp}/ref.json") as f:
        want = json.load(f)
    want["state"] = dict(np.load(f"{tmp}/ref_state.npz"))
    want["y"] = {f: np.load(f"{tmp}/ref_y_{f}.npy") for f in FACTORS}
    got = torch.load(f"{tmp}/rank0.pt", weights_only=False)
    from repro_torch.checkpoint import CheckpointManager

    got["restored"] = CheckpointManager(f"{tmp}/mesh").restore_latest(
        init_train_state(None, _cfg(), _opt(), device="cpu"))
    return got, want, one


def _steps_one():
    """One process's first step: (loss, grad norm, state)."""
    cfg, opt = _cfg(), _opt()
    step = make_train_step(cfg, opt, ac=AC)
    state, m = step(init_train_state(None, cfg, opt, params=_params()),
                    _batches()[0])
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "state": state}


def _close_states(got, want, what):
    a, b = _flat(got), _flat(want)
    assert set(a) == set(b), what
    for k in a:
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]),
                                   atol=ATOL, rtol=RTOL,
                                   err_msg=f"{what} {k}")


def test_composed_step_matches_the_reference(runs):
    """(2, 2): both steps' losses and grad norms and the first step's
    params and Adafactor slots equal the reference's jitted
    ``make_train_step(ctx=)``; no assignment dropped by the budget."""
    got, want, _ = runs
    g = got["2x2"]
    assert g["token_axes"] == ("data",)
    np.testing.assert_allclose(g["loss"], want["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(g["grad_norm"], want["grad_norm"],
                               rtol=GN_RTOL)
    state = {k: v for k, v in _flat(g["state"]).items()
             if not k.endswith("step")}
    ref = want["state"]
    assert set(state) == {k for k in ref if not k.endswith("step")}
    for k, v in state.items():
        np.testing.assert_allclose(v.numpy(), ref[k], atol=ATOL, rtol=RTOL,
                                   err_msg=k)
    assert g["over"] == [0.0] * STEPS


@pytest.mark.parametrize("factor", FACTORS)
def test_moe_layer_matches_the_reference_ep(runs, factor):
    """Layer 0's MoE on each data rank's rows: outputs and
    ``ep_overflow_frac`` as the reference's EP computes them (0 at
    factor 2.0; the starved budget drops assignments, > 0)."""
    got, want, _ = runs
    y, over = got["moe"][factor]
    d = got["coords"][0]
    rows = BATCH // 2
    np.testing.assert_allclose(y, want["y"][factor][d * rows:
                                                    (d + 1) * rows],
                               rtol=MOE_RTOL, atol=MOE_ATOL)
    assert over == want[f"over_{factor}"]
    assert (over > 0) == (factor < 1)


@pytest.mark.parametrize("mesh", ["1x4", "4x1"])
def test_other_meshes_match_one_process(runs, mesh):
    """(1, 4): one data rank, each of 4 peers one group and 2 experts;
    (4, 1): no model axis, so no expert parallelism (the rules' FSDP
    step, its tokens over data)."""
    got, _, one = runs
    g = got[mesh]
    assert g["token_axes"] == ("data",)
    np.testing.assert_allclose(g["loss"][0], one["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(g["grad_norm"][0], one["grad_norm"],
                               rtol=GN_RTOL)
    _close_states(g["state"], one["state"], mesh)
    assert (g["counts"]["ep_all_to_all"] > 0) == (mesh == "1x4")


@pytest.mark.parametrize("mesh", ["2x2", "1x4", "4x1"])
def test_collective_payloads_match_the_dry_run(runs, mesh):
    """Each kind of collective's payload rank 0 counted in the first step
    equals the dry run's model: the rules' collectives, the all-to-alls
    at each peer's block and the blocks' join."""
    from repro_torch.launch.dryrun import rules_collective_payloads

    got, _, _ = runs
    shape = dict(zip(("data", "model"), map(int, mesh.split("x"))))
    cfg = _cfg()
    want = rules_collective_payloads(
        cfg, params=zoo.init_params(None, cfg, device="meta"), mesh=shape,
        dispatch="sorted", remat="none", tokens=BATCH * SEQ, itemsize=4)
    assert got[mesh]["counts"] == want
    if shape["model"] > 1:
        assert want["ep_all_to_all"] > 0 and want["ep_all_gather"] > 0


def test_dry_run_cell_models_the_composed_step():
    """``collective_bytes`` of an EP training cell under a
    ``tensor_parallel`` ctx is the rules' model (the all-to-alls and the
    blocks' join among its payloads, each sent as a ring sends it);
    without it, the expert-only layout's all-to-alls and gradient
    all-reduce."""
    from repro_torch.launch.dryrun import (
        collective_bytes,
        rules_collective_payloads,
    )

    cfg = _cfg()
    kw = dict(params=zoo.init_params(None, cfg, device="meta"),
              dispatch="sorted", remat="none", itemsize=4,
              mesh={"data": 2, "model": 2}, tokens=BATCH * SEQ)
    tp = collective_bytes(cfg, kind="train", tensor_parallel=True, **kw)
    pay = tp["payloads"]
    assert pay == rules_collective_payloads(cfg, **kw)
    assert tp["bytes"] > (pay["ep_all_to_all"] + pay["ep_all_gather"]) // 2
    only = collective_bytes(cfg, kind="train", **kw)
    assert "payloads" not in only and only["a2a_forward"] > 0


def test_group_count_divisibility_error(runs):
    """4 x 32 tokens are 2 groups of 64, which 4 ranks cannot split: the
    reference's error."""
    got, _, _ = runs
    msg = got["divisibility"]
    assert msg is not None and "G=2 groups" in msg and "G % 4 == 0" in msg


def test_checkpoints_across_world_sizes(runs):
    """The mesh resumes one process's checkpoint to the same tensors; its
    own checkpoint (rank 0 writing the global state) restores in one
    process to its gathered state, which ends where one process's 2
    steps end."""
    got, _, one = runs
    assert got["resumed"] == (1, True)
    restored, step, _ = got["restored"]
    assert step == STEPS
    assert _equal(restored, got["trainer"])
    _close_states(got["trainer"], one["trainer"], "trainer")
