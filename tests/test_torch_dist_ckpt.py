"""Checkpoints across world sizes, and the launcher under ``torchrun``,
on ``gloo`` ranks on the CPU.

A ``Trainer`` checkpoint holds the global train state in the
single-process format whatever the world size: one written by one
process restores on 2 ranks of mesh ``(data=1, model=2)`` (each rank
its 4 of the 8 experts, exactly the checkpoint's slices), and one
written by the 2 ranks (expert-parallel, rank 0 writing) restores in
one process to the same tensors. On the data-parallel mesh ``(data=2,)``
(no ``model`` axis: FSDP, each ``embed`` dim split over the ranks) a
``Trainer`` checkpoints, resumes, and its gathered state ends where one
process on the whole batch ends (params atol 2e-4, rtol 2e-3, as
``tests/test_system.py``). Then ``torchrun
--nproc-per-node 2 -m repro_torch.launch.train ... --device cpu``, with
``--ep a2a`` and with the default ``--ep none``, trains 2 steps to the
single-process launcher's loss (printed to 4 decimals; atol 2e-4).
"""
import dataclasses
import os
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_reduced
from repro_torch.data import make_iterator
from repro_torch.models import model_zoo as zoo
from repro_torch.models.param import tree_leaves
from repro_torch.optim import adafactor, constant
from repro_torch.training import TrainConfig, Trainer, init_train_state
from torch_threads import one_thread  # noqa: F401 (autouse)

WORLD = 2


def _cfg():
    cfg = get_reduced("granite-moe-1b-a400m")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, ep="a2a", ep_budget_factor=2.0))


def _trainer(ckpt, ctx=None):
    cfg = _cfg()
    return Trainer(cfg, adafactor(constant(1e-2)),
                   make_iterator(cfg, global_batch=4, seq_len=32), ckpt,
                   ac=zoo.ApplyCfg(dispatch="sorted"),
                   tc=TrainConfig(checkpoint_every=1, log_every=1000),
                   log_fn=lambda s: None, device="cpu", ctx=ctx)


def _like():
    cfg = _cfg()
    return init_train_state(None, cfg, adafactor(constant(1e-2)),
                            device="cpu")


def _worker(rank, world, tmp):
    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world)
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding import ShardCtx

    ctx = ShardCtx.for_mesh(make_debug_mesh((1, 2), ("data", "model")))
    # 1 -> 2: resume the one-process run's checkpoint (step 1 of 1).
    tr = _trainer(f"{tmp}/one", ctx)
    out = tr.run(1)
    assert tr.stats["resumed_from"] == 1
    restored = tr.layout.gather(out["state"])
    direct, step, _ = CheckpointManager(f"{tmp}/one").restore_latest(
        _like())
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(restored),
                                                 tree_leaves(direct)))
    # 2 -> 1: train 2 expert-parallel steps, checkpointing each.
    tr = _trainer(f"{tmp}/two", ctx)
    out = tr.run(2)
    full = tr.layout.gather(out["state"])
    # Data parallel: 1 step checkpointed, then resumed for the second.
    dp = ShardCtx.for_mesh(make_debug_mesh((2,), ("data",)))
    _trainer(f"{tmp}/dp", dp).run(1)
    tr = _trainer(f"{tmp}/dp", dp)
    out = tr.run(2)
    dp_resumed = tr.stats["resumed_from"]
    dp_state = tr.layout.gather(out["state"])
    if rank == 0:
        torch.save({"full": full, "same": same, "dp": dp_state,
                    "dp_resumed": dp_resumed}, f"{tmp}/two.pt")
    dist.destroy_process_group()


def test_checkpoints_restore_across_world_sizes(tmp_path):
    tmp = str(tmp_path)
    _trainer(f"{tmp}/one").run(1)
    torch.multiprocessing.spawn(_worker, args=(WORLD, tmp), nprocs=WORLD)
    got = torch.load(f"{tmp}/two.pt")
    assert got["same"], "2 ranks did not restore the 1-process checkpoint"
    restored, step, _ = CheckpointManager(f"{tmp}/two").restore_latest(
        _like())
    assert step == 2
    for a, b in zip(tree_leaves(restored), tree_leaves(got["full"])):
        assert torch.equal(a, b)
    assert got["dp_resumed"] == 1
    one = _trainer(f"{tmp}/dp_one").run(2)["state"]
    for a, b in zip(tree_leaves(one["params"]),
                    tree_leaves(got["dp"]["params"])):
        torch.testing.assert_close(b, a, atol=2e-4, rtol=2e-3)


def _loss(text):
    m = re.search(r"finished at step (\d+), loss ([0-9.]+)", text)
    assert m, text[-2000:]
    return int(m.group(1)), float(m.group(2))


ARGS = ["-m", "repro_torch.launch.train", "--arch", "granite-moe-1b-a400m",
        "--reduced", "--steps", "2", "--batch", "4", "--seq", "32",
        "--dispatch", "sorted", "--device", "cpu"]


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        ["src", os.environ.get("PYTHONPATH", "")]))


@pytest.fixture(scope="module")
def one_process_loss(tmp_path_factory):
    one = subprocess.run(
        [sys.executable, *ARGS, "--ckpt-dir",
         str(tmp_path_factory.mktemp("one"))],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert one.returncode == 0, one.stderr[-3000:]
    return _loss(one.stdout)


@pytest.mark.parametrize("ep", ["a2a", "none"])
def test_launcher_under_torchrun(tmp_path, one_process_loss, ep):
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(WORLD), *ARGS, "--ep", ep,
         "--ckpt-dir", str(tmp_path / "tr")],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "ranks=2" in run.stdout
    (s2, l2), (s1, l1) = _loss(run.stdout), one_process_loss
    assert s2 == s1 == 2
    assert abs(l2 - l1) <= 2e-4
