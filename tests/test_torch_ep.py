"""Expert-parallel sorted dispatch (``core/ep.py``) on 4 ``gloo`` ranks,
mesh ``(data=2, model=2)``: the port of the reference's
``tests/test_ep_dispatch.py``.

``get_reduced("grok-1-314b")`` (E = 4, 2 experts a rank),
``group_size=16``, input (4, 32, d): each rank takes one row, two
routing groups. All three routers: outputs and gradients (router,
experts, input) against the port's single-process sorted path, rtol
1e-4, atol 1e-5; empty local experts; uneven load; the divisibility
error; the fallback without a capable mesh (one process). The one case
where expert parallelism changes the result — a starved send budget
that drops assignments — is held against the reference's own EP
(``repro``'s ``moe_apply`` on a forced 4-device CPU mesh, in a
subprocess) on the same inputs: outputs at rtol 1e-4, atol 1e-5, and
``ep_overflow_frac`` equal and > 0.

One spawn of the 4 ranks runs every case (rendezvous through a file
under the test's temporary directory); the ranks import torch and the
port only.
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
from repro_torch.core.moe import moe_apply, moe_init
from torch_threads import one_thread  # noqa: F401 (autouse)

ROUTERS = ["top_k", "expert_choice", "switch"]
WORLD = 4
RTOL, ATOL = 1e-4, 1e-5


def _cfg(**moe_kw):
    cfg = get_reduced("grok-1-314b")
    moe = dataclasses.replace(cfg.moe, group_size=16, ep="a2a",
                              ep_budget_factor=4.0)
    moe = dataclasses.replace(moe, **moe_kw)
    return dataclasses.replace(cfg, moe=moe)


def _inputs():
    cfg = _cfg()
    p = moe_init(torch.Generator().manual_seed(0), cfg, cfg.moe,
                 device="cpu")
    x = np.random.default_rng(1).normal(
        size=(4, 32, cfg.d_model)).astype(np.float32)
    out = {k: v.numpy() for k, v in p["experts"].items()}
    out.update(w=p["router"]["w"].numpy(), x=x)
    return out


def _params(z, w=None):
    return {"router": {"w": torch.from_numpy(z["w"] if w is None else w)},
            "experts": {k: torch.from_numpy(z[k]) for k in ("wi", "wg", "wo")
                        if k in z}}


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _grads(params, x, cfg, router, ctx, scale):
    """(y, metrics, grads of router, experts and x) of sum(y^2) +
    aux_loss * scale."""
    leaves = [params["router"]["w"], *params["experts"].values(), x]
    for t in leaves:
        t.requires_grad_(True)
    y, m = moe_apply(params, x, cfg, cfg.moe, router_kind=router,
                     dispatch="sorted", implementation="eager", ctx=ctx)
    loss = torch.sum(y ** 2) + m["aux_loss"] * scale
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    return y.detach(), m, grads


def _check(fails, name, a, b):
    try:
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    except AssertionError as e:
        fails.append(f"{name}: {str(e)[:300]}")


def _compare(case, z, cfg, router, ctx, rank, fails, w=None):
    """Rank-local EP outputs and global gradients against the
    single-process sorted path over the whole input."""
    import torch.distributed as dist

    from repro_torch.sharding import all_reduce, shard_tree

    full = _params(z, w)
    x = torch.from_numpy(z["x"])
    y1, m1, g1 = _grads({k: {kk: vv.clone() for kk, vv in v.items()}
                         for k, v in full.items()}, x.clone(), cfg, router,
                        None, 1.0)
    dims = {"router": {"w": None},
            "experts": {k: 0 for k in full["experts"]}}
    local = shard_tree(full, dims, ctx)
    # Each rank's loss adds its share of the mean aux loss.
    y2, m2, g2 = _grads(local, x[rank:rank + 1].clone(), cfg, router, ctx,
                        1.0 / dist.get_world_size())
    _check(fails, f"{case} y", y2, y1[rank:rank + 1])
    names = ["router"] + [f"experts/{k}" for k in full["experts"]]
    n = cfg.moe.num_experts // ctx.shape["model"]
    m = ctx.coord("model")
    for name, a, b in zip(names, g2[:-1], g1[:-1]):
        if name == "router":
            a = all_reduce(a, ctx.group(ctx.token_axes))
        else:
            a = all_reduce(a, ctx.group(ctx.replica_axes))
            b = b[m * n:(m + 1) * n]
        _check(fails, f"{case} d{name}", a, b)
    _check(fails, f"{case} dx", g2[-1], g1[-1][rank:rank + 1])
    return m2


def _worker(rank, world, tmp):
    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world)
    from repro_torch.launch.mesh import ep_degree, make_debug_mesh
    from repro_torch.sharding import ShardCtx

    mesh = make_debug_mesh((2, 2), ("data", "model"))
    assert ep_degree(mesh) == 2
    ctx = ShardCtx.for_mesh(mesh)
    z = dict(np.load(f"{tmp}/inputs.npz"))
    results = {}

    def run(case, fn):
        fails = []
        try:
            fn(fails)
        except Exception as e:  # reported by the test of the case
            fails.append(f"{type(e).__name__}: {e}")
        results[case] = fails

    for router in ROUTERS:
        def parity(fails, router=router):
            m = _compare(f"parity/{router}", z, _cfg(), router, ctx, rank,
                         fails)
            if float(m["ep_overflow_frac"]) != 0.0:
                fails.append("ep_overflow_frac != 0")
        run(f"parity/{router}", parity)

        def uneven(fails, router=router):
            w = z["w"].copy()
            w[:, 0] += 3.0  # expert 0 draws most assignments
            m = _compare(f"uneven/{router}", z, _cfg(capacity_factor=4.0),
                         router, ctx, rank, fails, w=w)
            if float(m["ep_overflow_frac"]) != 0.0:
                fails.append("ep_overflow_frac != 0")
        run(f"uneven/{router}", uneven)

    for router in ("top_k", "switch"):
        def empty(fails, router=router):
            # Experts 2..3 (the model=1 ranks') never win a slot: those
            # ranks receive no rows.
            w = z["w"].copy()
            w[:, 2:] = -30.0
            _compare(f"empty/{router}", z, _cfg(), router, ctx, rank,
                     fails, w=w)
        run(f"empty/{router}", empty)

    def divisibility(fails):
        cfg = _cfg()
        p = _params(z)
        from repro_torch.sharding import shard_tree

        p = shard_tree(p, {"router": {"w": None},
                           "experts": {k: 0 for k in p["experts"]}}, ctx)
        x_bad = torch.from_numpy(z["x"][rank, :24][None])  # not 16s
        try:
            moe_apply(p, x_bad, cfg, cfg.moe, dispatch="sorted", ctx=ctx)
            fails.append("no error")
        except ValueError as e:
            if "divisible" not in str(e):
                fails.append(f"wrong error: {e}")
    run("divisibility", divisibility)

    def overflow(fails):
        cfg = _cfg(ep_budget_factor=0.25, capacity_factor=4.0)
        w = z["w"].copy()
        w[:, 0] += 5.0  # pile onto one peer to force overflow
        from repro_torch.sharding import shard_tree

        p = shard_tree(_params(z, w), {"router": {"w": None}, "experts": {
            k: 0 for k in ("wi", "wg", "wo")}}, ctx)
        y, m = moe_apply(p, torch.from_numpy(z["x"][rank:rank + 1]), cfg,
                         cfg.moe, dispatch="sorted", ctx=ctx)
        ys = [torch.empty_like(y) for _ in range(world)]
        dist.all_gather(ys, y)
        if rank == 0:
            np.savez(f"{tmp}/port_overflow.npz",
                     y=torch.cat(ys).numpy(),
                     over=m["ep_overflow_frac"].numpy())
    run("overflow", overflow)

    gathered = [None] * world
    dist.all_gather_object(gathered, results)
    if rank == 0:
        merged = {k: [f"rank {r}: {m}" for r, g in enumerate(gathered)
                      for m in g[k]] for k in results}
        with open(f"{tmp}/results.json", "w") as f:
            json.dump(merged, f)
    dist.destroy_process_group()


REFERENCE = textwrap.dedent("""
    import dataclasses, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get_reduced
    from repro.core.moe import moe_apply
    from repro.launch.mesh import make_debug_mesh
    from repro.sharding import ShardCtx

    tmp = sys.argv[1]
    z = np.load(f"{tmp}/inputs.npz")
    cfg = get_reduced("grok-1-314b")
    moe = dataclasses.replace(cfg.moe, group_size=16, ep="a2a",
                              ep_budget_factor=0.25, capacity_factor=4.0)
    cfg = dataclasses.replace(cfg, moe=moe)
    w = z["w"].copy()
    w[:, 0] += 5.0
    vals = {"router": {"w": jnp.asarray(w)},
            "experts": {k: jnp.asarray(z[k]) for k in ("wi", "wg", "wo")}}
    ctx = ShardCtx.for_mesh(make_debug_mesh((2, 2), ("data", "model")))
    # One jitted call (op-by-op dispatch of the shard_map path costs
    # seconds); sorted_block 16 is the port's ragged block.
    y, m = jax.jit(lambda v, x: moe_apply(
        v, x, cfg, moe, router_kind="top_k", dispatch="sorted", ctx=ctx,
        implementation="xla", sorted_block=16))(vals, jnp.asarray(z["x"]))
    np.savez(f"{tmp}/ref_overflow.npz", y=np.asarray(y),
             over=np.asarray(m["ep_overflow_frac"]))
""")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ep"))
    np.savez(f"{tmp}/inputs.npz", **_inputs())
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   ["src", os.environ.get("PYTHONPATH", "")]))
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, tmp], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        torch.multiprocessing.spawn(_worker, args=(WORLD, tmp),
                                    nprocs=WORLD)
    finally:
        out, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err.decode()[-2000:]
    with open(f"{tmp}/results.json") as f:
        return tmp, json.load(f)


@pytest.mark.parametrize("router", ROUTERS)
def test_ep_matches_single_process_sorted(results, router):
    """Outputs and gradients (router, experts, input) against the
    single-process sorted path; no EP drops."""
    assert results[1][f"parity/{router}"] == []


@pytest.mark.parametrize("router", ["top_k", "switch"])
def test_ep_empty_local_experts(results, router):
    """The model=1 ranks own experts nobody routes to: their grouped
    kernels see all-empty segments; outputs and gradients still match
    (the dW of an empty expert is zero)."""
    assert results[1][f"empty/{router}"] == []


@pytest.mark.parametrize("router", ROUTERS)
def test_ep_uneven_load(results, router):
    assert results[1][f"uneven/{router}"] == []


def test_ep_group_count_divisibility_error(results):
    assert results[1]["divisibility"] == []


def test_ep_budget_overflow_matches_reference_ep(results):
    """A starved budget drops the same assignments as the reference's
    EP: the same outputs, the same ep_overflow_frac, > 0."""
    tmp, res = results
    assert res["overflow"] == []
    port = np.load(f"{tmp}/port_overflow.npz")
    ref = np.load(f"{tmp}/ref_overflow.npz")
    assert np.isfinite(port["y"]).all()
    np.testing.assert_allclose(port["y"], ref["y"], rtol=RTOL, atol=ATOL)
    assert float(port["over"]) == float(ref["over"])
    assert float(port["over"]) > 0.0


def test_ep_fallback_without_capable_mesh():
    """ep='a2a' with no ctx, or a mesh whose model axis has size 1, runs
    the single-device sorted path: the same outputs as ep='none', no
    overflow."""
    from repro_torch.sharding import ShardCtx

    z = _inputs()
    cfg = _cfg()
    p, x = _params(z), torch.from_numpy(z["x"])
    y0, _ = moe_apply(p, x, cfg, dataclasses.replace(cfg.moe, ep="none"),
                      dispatch="sorted")
    for ctx in (None, ShardCtx.for_mesh({"data": 2, "model": 1})):
        y, m = moe_apply(p, x, cfg, cfg.moe, dispatch="sorted", ctx=ctx)
        torch.testing.assert_close(y, y0, rtol=0, atol=0)
        assert float(m["ep_overflow_frac"]) == 0.0
