"""Training under a mesh on ``gloo`` ranks on the CPU: one
expert-parallel train step on 4 ranks (the expert-only layout,
``tensor_parallel=False``) equals the single-process step, the
launcher's ``--ep a2a`` in one process equals ``--ep none``, and under
``torchrun`` on 4 ranks (``ShardCtx.for_mesh``'s composed placement:
expert parallelism over ``model`` with the rules' tensor parallelism)
trains to the one process's losses.

``get_reduced("granite-moe-1b-a400m")`` upcycled from its dense parent,
sorted dispatch, ``ep="a2a"`` with a budget factor >= ep (no EP drops),
Adafactor: one ``make_train_step`` step on mesh ``(data=2, model=2)``
(each rank 2 of the 8 batch rows and 4 of the 8 experts) against the
single-process step on the same global batch, at the tolerances of the
reference's ``tests/test_system.py`` distributed step: loss rtol 2e-4,
params atol 2e-4, rtol 2e-3 — here every leaf of the gathered state,
the optimizer's slots included. The ranks import torch and the port
only; one spawn, rendezvous through a file under the test's temporary
directory.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.core.upcycle import upcycle_params
from repro_torch.data import make_iterator
from repro_torch.models import model_zoo as zoo
from repro_torch.models.param import tree_leaves
from repro_torch.optim import adafactor, constant
from repro_torch.training import init_train_state, make_train_step
from torch_threads import one_thread  # noqa: F401 (autouse)

WORLD = 4


def _cfg():
    cfg = get_reduced("granite-moe-1b-a400m")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, ep="a2a", ep_budget_factor=4.0))


def _setup():
    """(cfg, upcycled params, global batch of 8 x 32)."""
    cfg = _cfg()
    dense_cfg = cfg.dense_parent()
    dense = zoo.init_params(0, dense_cfg, device="cpu")
    params = upcycle_params(dense, dense_cfg, cfg,
                            torch.Generator().manual_seed(7))
    batch = next(make_iterator(cfg, global_batch=8, seq_len=32,
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


def _step_worker(rank, world, tmp):
    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world)
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding import ShardCtx, train_layout

    # The expert-only layout, asked for explicitly: ``for_mesh``'s ctx
    # composes expert parallelism with the rules' placement.
    ctx = dataclasses.replace(
        ShardCtx.for_mesh(make_debug_mesh((2, 2), ("data", "model"))),
        tensor_parallel=False)
    cfg, params, batch = _setup()
    opt = adafactor(constant(1e-2))
    ac = zoo.ApplyCfg(dispatch="sorted")
    state = init_train_state(None, cfg, opt, params=params)
    layout = train_layout(ctx, cfg, ac.dispatch, state)
    state = layout.shard(state)
    assert state["params"]["stack"]["segments"][0]["pos0"]["ffn"][
        "experts"]["wi"].shape[1] == cfg.moe.num_experts // 2
    per = 8 // world
    local = {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}
    step = make_train_step(cfg, opt, ac=ac, layout=layout)
    state, mets = step(state, local)
    full = layout.gather(state)
    if rank == 0:
        torch.save({"state": full,
                    "mets": {k: float(v) for k, v in mets.items()}},
                   f"{tmp}/dist_step.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def dist_step(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dist_step"))
    torch.multiprocessing.spawn(_step_worker, args=(WORLD, tmp),
                                nprocs=WORLD)
    return torch.load(f"{tmp}/dist_step.pt")


def test_mesh_step_matches_single_process_step(dist_step):
    cfg, params, batch = _setup()
    opt = adafactor(constant(1e-2))
    step = make_train_step(cfg, opt, ac=zoo.ApplyCfg(dispatch="sorted"))
    state, mets = step(init_train_state(None, cfg, opt, params=params),
                       batch)
    d = dist_step
    np.testing.assert_allclose(d["mets"]["loss"], float(mets["loss"]),
                               rtol=2e-4)
    assert d["mets"]["ep_overflow_frac_sum"] == 0.0
    a, b = _flat(state), _flat(d["state"])
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), atol=2e-4,
                                   rtol=2e-3, err_msg=k)


def _launch(tmp, *extra):
    from repro_torch.launch.train import main

    return main(["--arch", "granite-moe-1b-a400m", "--reduced", "--steps",
                 "2", "--batch", "2", "--seq", "16", "--dispatch",
                 "sorted", "--device", "cpu", "--ckpt-dir", tmp, *extra])


def test_launcher_ep_a2a_in_one_process_equals_ep_none(tmp_path):
    """One process has no mesh: --ep a2a falls back to the single-device
    sorted path, the same state bit for bit as --ep none."""
    a = _launch(str(tmp_path / "a2a"), "--ep", "a2a")
    b = _launch(str(tmp_path / "none"), "--ep", "none")
    for x, y in zip(tree_leaves(a["state"]), tree_leaves(b["state"])):
        assert torch.equal(x, y)
    assert json.dumps(a["metrics"]) == json.dumps(b["metrics"])


def test_launcher_ep_a2a_on_four_ranks_matches_one_process(tmp_path):
    """``torchrun --nproc-per-node 4 ... --ep a2a``: mesh (data=1,
    model=4), ``ShardCtx.for_mesh``'s ctx, so ``train_layout`` composes
    expert parallelism (2 of the 8 experts a rank, one of the 4 routing
    groups of 64 a rank through the all-to-all) with the rules' tensor
    parallelism (a query head a rank, vocabulary and ``mlp`` blocks).
    Two steps at 8 x 32 end at the one process's loss (printed to 4
    decimals; atol 2e-4)."""
    args = ["-m", "repro_torch.launch.train", "--arch",
            "granite-moe-1b-a400m", "--reduced", "--steps", "2", "--batch",
            "8", "--seq", "32", "--dispatch", "sorted", "--device", "cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        ["src", os.environ.get("PYTHONPATH", "")]))
    runs = []
    for pre in ([], ["-m", "torch.distributed.run", "--standalone",
                     "--nproc-per-node", "4"]):
        run = subprocess.run(
            [sys.executable, *pre, *args, "--ep", "a2a", "--ckpt-dir",
             str(tmp_path / str(len(pre)))],
            env=env, capture_output=True, text=True, timeout=300)
        assert run.returncode == 0, run.stderr[-3000:]
        m = re.search(r"finished at step (\d+), loss ([0-9.]+)", run.stdout)
        assert m, run.stdout[-2000:]
        runs.append((int(m.group(1)), float(m.group(2)), run.stdout))
    (s1, l1, _), (s4, l4, out) = runs
    assert "ranks=4 mesh={'data': 1, 'model': 4}" in out
    assert s1 == s4 == 2
    assert abs(l4 - l1) <= 2e-4
