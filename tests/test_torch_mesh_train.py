"""The train step under the rules engine's placement on ``gloo`` ranks on
the CPU: FSDP of ``embed`` over ``data``, tensor parallelism of heads,
kv heads, ``mlp`` and ``vocab`` over ``model``, the MoE's experts
resident over ``model`` (``sharding.train_layout`` without expert
parallelism).

``get_reduced("granite-moe-1b-a400m")`` (4 heads, 2 KV heads, 8
experts, vocab 259) upcycled from its dense parent takes one
``make_train_step`` step with the gather, einsum and sorted dispatches
(``moe.ep="none"``) on the meshes ``(data=2, model=2)``, ``(2, 1)``
(FSDP alone) and ``(1, 2)`` (tensor parallelism alone), each against
the single-process step on the same global batch of 8 x 32 (seeded
numpy data) at the tolerances of the reference's ``tests/test_system.py``
distributed step: loss rtol 2e-4, every leaf of the gathered state —
params and optimizer slots — atol 2e-4, rtol 2e-3. The single-process
step is held against the reference by the earlier tests.

The steps run Adafactor with ``eps1 = 1e-6``: at step 1 its decay is 0,
so an unfactored leaf's update is ``g / sqrt(g^2 + eps1)`` times a
scale — ``sign(g)`` at the default 1e-30 — and an element whose
gradient lies within float32's reassociation noise takes either sign in
two correct runs. Splitting heads, ``mlp``, experts and vocabulary over
ranks reassociates sums; on these random-init stacks that moves a
leaf's gradients by up to ~1e-4 of its largest (the same code in
float64 agrees to ~1e-13), and the upcycled ViT's router gradient is
zero up to rounding (its experts are copies, its combine weights sum to
one). At 1e-6 an element below 1e-3 moves by at most ``|g| * 1e3`` of
the scale. The reduced gradients themselves are held too: every leaf
within 1e-3 of its largest single-process gradient (plus 1e-6). The
factored slots (leaves sharded on both their last two dims, and one
whose ``v_col`` the state holds sharded where the leaf is not) run the
default.

Also on ``(2, 2)``: a second run of the step repeats the first bit for
bit; int8 gradient compression (its residual held); the vocab-parallel
cross-entropy (vocab 256, with and without ``ce_chunk``); remat under
the full and the "dots" policies; heads that
need ``pad_heads_multiple`` (6 query heads over 3 KV heads, padded to
12, each rank's 6 reading their KV heads by global index); the reduced
ViT (Expert Choice, its 16-class head vocab-parallel); a batch whose
data ranks' tokens do not form whole routing groups raises; and the
bytes each rank counted through each kind of collective equal
``launch/dryrun.rules_collective_payloads``. One spawn of 4 ranks and
one of 2; rendezvous through a file under the test's temporary
directory; the ranks import torch and the port only.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.core.upcycle import upcycle_params
from repro_torch.data import make_iterator
from repro_torch.models import model_zoo as zoo
from repro_torch.optim import adafactor, constant
from repro_torch.training import TrainConfig, init_train_state, make_train_step
from torch_threads import one_thread  # noqa: F401 (autouse)

GRANITE = "granite-moe-1b-a400m"
VIT = "vit-b16-upcycled"
DISPATCHES = ("gather", "einsum", "sorted")
ATOL, RTOL, LOSS_RTOL = 2e-4, 2e-3, 2e-4
BATCH, SEQ = 8, 32


def _cfg(case):
    arch = VIT if case == "vit" else GRANITE
    cfg = get_reduced(arch)
    if case.startswith("ce"):
        cfg = dataclasses.replace(cfg, vocab_size=256)
    if case == "pad":
        cfg = dataclasses.replace(cfg, n_heads=6, n_kv_heads=3, d_head=16)
    return cfg


def _knobs(case):
    """(ApplyCfg, TrainConfig, optimizer) of a case."""
    dispatch = case.split("/")[-1] if "/" in case else "gather"
    ac = zoo.ApplyCfg(dispatch=dispatch,
                      ce_chunk=8 if case == "ce_chunk" else 0,
                      pad_heads_multiple=4 if case == "pad" else 0,
                      remat=case[6:] if case.startswith("remat_") else "none")
    tc = TrainConfig(compression="int8" if case == "int8" else "none")
    return ac, tc, adafactor(constant(1e-2), eps1=1e-6)


def _setup(case, seq=SEQ):
    """(cfg, upcycled params, the global batch) of a case."""
    cfg = _cfg(case)
    dense_cfg = cfg.dense_parent()
    dense = zoo.init_params(0, dense_cfg, device="cpu")
    params = upcycle_params(dense, dense_cfg, cfg,
                            torch.Generator().manual_seed(7))
    batch = next(make_iterator(cfg, global_batch=BATCH, seq_len=seq,
                               host_index=0, host_count=1))
    return cfg, params, batch


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        return {k: v for kk, vv in tree.items()
                for k, v in _flat(vv, f"{pre}/{kk}").items()}
    if isinstance(tree, list):
        return {k: v for i, vv in enumerate(tree)
                for k, v in _flat(vv, f"{pre}/{i}").items()}
    return {pre: tree}


def _mesh_step(case, ctx, seq=SEQ):
    """One step of ``case`` on this rank: (gathered state, metrics,
    collective payloads counted, the rank's state, the gathered reduced
    gradients on (2, 2) and of the knob cases)."""
    from repro_torch.sharding import comm, train_layout
    from repro_torch.training.train_loop import (
        batch_to,
        loss_and_grads,
        reduce_grads,
    )

    cfg, params, batch = _setup(case, seq)
    ac, tc, opt = _knobs(case)
    state = init_train_state(None, cfg, opt, params=params, tc=tc)
    layout = train_layout(ctx, cfg, ac.dispatch, state)
    state = layout.shard(state)
    i, n = layout.batch_rows()
    per = BATCH // n
    local = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
    step = make_train_step(cfg, opt, ac=ac, tc=tc, layout=layout)
    grads = None
    if "/" not in case or case.startswith("2x2"):
        grads, _ = loss_and_grads(state["params"], batch_to(local, "cpu"),
                                  cfg, ac=ac,
                                  ctx=layout.ctx,
                                  specs=layout.specs["params"])
        grads = layout.gather({"params": reduce_grads(
            grads, layout.specs["params"], layout.ctx, layout.token_axes)})
    comm.reset_counts()
    state, mets = step(state, local)
    counts = comm.counts()
    return (layout.gather(state), {k: float(v) for k, v in mets.items()},
            counts, state, grads)


def _worker(rank, world, tmp, shapes):
    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world)
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding import ShardCtx

    out = {}
    for shape in shapes:
        ctx = ShardCtx.for_mesh(make_debug_mesh(shape, ("data", "model")))
        tag = "x".join(map(str, shape))
        cases = [f"{tag}/{d}" for d in DISPATCHES]
        if shape == (2, 2):
            cases += ["int8", "ce", "ce_chunk", "pad", "vit", "remat_full",
                      "remat_dots"]
        for case in cases:
            full, mets, counts, mine, grads = _mesh_step(case, ctx)
            out[case] = {"state": full, "mets": mets, "counts": counts,
                         "grads": grads}
            if case == f"{tag}/gather" and shape == (2, 2):
                _, again, _, mine2, _ = _mesh_step(case, ctx)
                same = all(torch.equal(a, b) for a, b in zip(
                    _flat(mine).values(), _flat(mine2).values()))
                flag = torch.tensor([float(same and again == mets)])
                dist.all_reduce(flag, op=dist.ReduceOp.MIN)
                out["repeat"] = bool(flag.item())
        if shape == (2, 2):
            try:
                _mesh_step("2x2/gather", ctx, seq=24)
                out["straddle"] = None
            except ValueError as e:
                out["straddle"] = str(e)
    if rank == 0:
        torch.save(out, f"{tmp}/mesh_{world}.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    runs = {}
    for world, shapes in ((4, [(2, 2)]), (2, [(2, 1), (1, 2)])):
        d = tmp / str(world)
        d.mkdir()
        torch.multiprocessing.spawn(_worker, args=(world, str(d), shapes),
                                    nprocs=world)
        runs.update(torch.load(d / f"mesh_{world}.pt"))
    return runs


_single = {}


def _single_step(case):
    """(state, metrics, gradients) of the single-process step."""
    from repro_torch.training.train_loop import batch_to, loss_and_grads

    key = case.split("/")[-1] if "/" in case else case
    if key not in _single:
        cfg, params, batch = _setup(case)
        ac, tc, opt = _knobs(case)
        grads, _ = loss_and_grads(params, batch_to(batch, "cpu"), cfg, ac=ac)
        step = make_train_step(cfg, opt, ac=ac, tc=tc)
        state, mets = step(init_train_state(None, cfg, opt, params=params,
                                            tc=tc), batch)
        _single[key] = (state, {k: float(v) for k, v in mets.items()},
                        {"params": grads})
    return _single[key]


def _hold(got, case, leaves=True):
    state, mets, grads = _single_step(case)
    if got["grads"] is not None:
        a, b = _flat(grads), _flat(got["grads"])
        assert set(a) == set(b), case
        for k in a:
            gap = float((b[k] - a[k]).abs().max())
            assert gap <= 1e-3 * float(a[k].abs().max()) + 1e-6, (case, k,
                                                                  gap)
    np.testing.assert_allclose(got["mets"]["loss"], mets["loss"],
                               rtol=LOSS_RTOL, err_msg=case)
    np.testing.assert_allclose(got["mets"]["grad_norm"], mets["grad_norm"],
                               rtol=1e-3, err_msg=case)
    a, b = _flat(state), _flat(got["state"])
    assert set(a) == set(b), case
    for k in a if leaves else ():
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), atol=ATOL,
                                   rtol=RTOL, err_msg=f"{case} {k}")


@pytest.mark.parametrize("mesh", ["2x2", "2x1", "1x2"])
@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_mesh_step_matches_single_process_step(mesh_runs, mesh, dispatch):
    _hold(mesh_runs[f"{mesh}/{dispatch}"], f"{mesh}/{dispatch}")


@pytest.mark.parametrize("case", ["int8", "ce", "ce_chunk", "pad", "vit",
                                  "remat_full", "remat_dots"])
def test_mesh_step_knobs_match_single_process_step(mesh_runs, case):
    """int8 compression, the vocab-parallel cross-entropy with and
    without chunks, padded heads split over model, and the ViT's Expert
    Choice MoE with its vocab-parallel head. int8's levels are a
    rounding of the gradients, so a gradient within the split's
    reassociation noise of a level boundary rounds to either neighbour:
    its step is held by the loss and the gradients, and its residual
    exactly — each leaf's ``x - round(x / scale) * scale``, the scale
    the whole leaf's largest magnitude over the ranks, from the mesh's
    own gradients, bit for bit."""
    from repro_torch.training import compression

    got = mesh_runs[case]
    _hold(got, case, leaves=case != "int8")
    if case == "int8":
        grads = got["grads"]["params"]
        _, want = compression.compress(
            grads, compression.init_residual(grads), "int8")
        a, b = _flat(want), _flat(got["state"]["residual"])
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_mesh_step_repeats_bit_for_bit(mesh_runs):
    assert mesh_runs["repeat"] is True


def test_groups_straddling_data_ranks_raise(mesh_runs):
    """8 x 24 tokens over 2 data ranks: 96 a rank, not whole groups of
    64 — the single-process step's groups would straddle the ranks."""
    msg = mesh_runs["straddle"]
    assert msg is not None and "96" in msg and "64" in msg


@pytest.mark.parametrize("case", ["2x2/gather", "2x2/einsum", "2x2/sorted",
                                  "1x2/sorted", "2x1/gather", "vit",
                                  "ce_chunk", "remat_full", "remat_dots"])
def test_collective_bytes_match_the_dry_run(mesh_runs, case):
    """Every kind of collective's payload a rank counted in the step
    equals the dry run's model of it: also the vocab-parallel
    cross-entropy over checkpointed chunks (its backward recomputes the
    chunks' all-reduces) and remat's recomputed forward, under the full
    policy and the selective "dots"."""
    from repro_torch.launch.dryrun import rules_collective_payloads

    cfg = _cfg(case)
    ac, _, _ = _knobs(case)
    shape = (2, 2) if "/" not in case else tuple(
        int(x) for x in case.split("/")[0].split("x"))
    tokens = BATCH * (cfg.n_frontend_positions if case == "vit" else SEQ)
    want = rules_collective_payloads(
        cfg, params=zoo.init_params(None, cfg, device="meta"),
        mesh={"data": shape[0], "model": shape[1]}, dispatch=ac.dispatch,
        remat=ac.remat, tokens=tokens, itemsize=4, ce_chunk=ac.ce_chunk,
        seq=SEQ)
    got = mesh_runs[case]["counts"]
    assert got == want
    assert got["fsdp_all_gather"] > 0 or shape[0] == 1
    assert got["tp_all_reduce"] > 0 or shape[1] == 1


def _factored_case(ctx):
    """A stacked leaf ``(2, 256, 384)`` over (None, data, model) and an
    ``embed embed`` leaf ``(256, 256)`` (its ``v_col`` over data, the
    leaf's last dim whole), one gradient each."""
    from repro_torch.models import param as pm

    g = torch.Generator().manual_seed(3)
    params = {"a": pm.tag(torch.randn(2, 256, 384, generator=g),
                          "layer embed mlp"),
              "b": pm.tag(torch.randn(256, 256, generator=g),
                          "embed embed")}
    grads = {"a": torch.randn(2, 256, 384, generator=g),
             "b": torch.randn(256, 256, generator=g)}
    return params, grads


def _factored_worker(rank, world, tmp):
    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world)
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import param as pm
    from repro_torch.sharding import (
        ShardCtx,
        TreeLayout,
        state_axes_of,
        tree_specs,
    )
    from repro_torch.training.train_loop import leaf_shards

    ctx = ShardCtx.for_mesh(make_debug_mesh((2, 2), ("data", "model")))
    params, grads = _factored_case(ctx)
    opt = adafactor(constant(1e-2))
    state = {"params": params, "opt_state": opt.init(params)}
    axes = state_axes_of(state, pm.tree_map(pm.axes_of, params))
    layout = TreeLayout(ctx, tree_specs(axes, state, ctx.mesh,
                                        ctx.param_rules), ("data",))
    local = layout.shard(state)
    g = layout.shard({"params": grads, "opt_state": state["opt_state"]})
    out = []
    for _ in range(2):
        upd, local["opt_state"] = opt.update(
            g["params"], local["opt_state"], local["params"],
            groups=leaf_shards(local["params"], layout))
        out.append(layout.gather({"params": upd,
                                  "opt_state": local["opt_state"]}))
    if rank == 0:
        torch.save({"out": out, "specs": layout.specs}, f"{tmp}/fac.pt")
    dist.destroy_process_group()


def test_factored_slots_of_leaves_sharded_on_both_last_dims(tmp_path):
    """Adafactor's row and column means over dims split over data and
    model, two updates, against the single-process optimizer; the
    slots' placements are the reference's ``state_axes``'."""
    torch.multiprocessing.spawn(_factored_worker, args=(4, str(tmp_path)),
                                nprocs=4)
    got = torch.load(tmp_path / "fac.pt")
    specs = got["specs"]
    assert specs["params"]["a"] == (None, "data", "model")
    assert specs["opt_state"]["slots"]["a"] == {
        "v_row": (None, "data"), "v_col": (None, "model")}
    assert specs["params"]["b"] == ("data",)
    assert specs["opt_state"]["slots"]["b"] == {
        "v_row": ("data",), "v_col": ("data",)}
    params, grads = _factored_case(None)
    opt = adafactor(constant(1e-2))
    st = opt.init(params)
    for want in got["out"]:
        upd, st = opt.update(grads, st, params)
        a = _flat({"params": upd, "opt_state": st})
        b = _flat(want)
        for k in a:
            np.testing.assert_allclose(b[k].numpy(), a[k].numpy(),
                                       rtol=1e-5, atol=1e-9, err_msg=k)
