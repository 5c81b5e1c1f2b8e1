"""The rules engine's placement of a train state over a mesh, on ``gloo``
ranks on the CPU (``sharding.train_layout`` without expert parallelism).

``get_reduced("granite-moe-1b-a400m")`` at d_model 128 and d_ff 128 (so
that the experts' and the embedding's Adafactor slots are factored) on
``(data=2, model=2)``: each rank's block of every leaf of the train
state — params, ``v_row``/``v_col``/``v`` slots, steps — is exactly the
block that the reference's ``NamedSharding`` of
``tree_specs(state_axes(cfg))`` gives the device at the rank's place in
the mesh (computed by the JAX package in a subprocess of 4 forced host
devices), ``shard`` then ``gather`` gives the state back bit for bit,
and a ``Trainer`` checkpoint written on ``(2, 2)`` (rank 0 writing the
gathered state) restores in one process and on 2 ranks of ``(1, 2)`` to
the same tensors. One spawn of 4 ranks and one of 2; rendezvous through
a file under the test's temporary directory; the ranks import torch and
the port only.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_reduced
from repro_torch.data import make_iterator
from repro_torch.models import model_zoo as zoo
from repro_torch.optim import adafactor, constant
from repro_torch.training import TrainConfig, Trainer, init_train_state
from torch_threads import one_thread  # noqa: F401 (autouse)

ARCH = "granite-moe-1b-a400m"
WIDTH = dict(d_model=128, d_ff=128)


def _cfg():
    return dataclasses.replace(get_reduced(ARCH), **WIDTH)


def _state():
    cfg = _cfg()
    return init_train_state(torch.Generator().manual_seed(0), cfg,
                            adafactor(constant(1e-2)), device="cpu")


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        return {k: v for kk, vv in tree.items()
                for k, v in _flat(vv, f"{pre}/{kk}").items()}
    if isinstance(tree, list):
        return {k: v for i, vv in enumerate(tree)
                for k, v in _flat(vv, f"{pre}/{i}").items()}
    return {pre: tree}


def _trainer(ckpt, ctx=None):
    cfg = _cfg()
    return Trainer(cfg, adafactor(constant(1e-2)),
                   make_iterator(cfg, global_batch=8, seq_len=32), ckpt,
                   ac=zoo.ApplyCfg(dispatch="gather"),
                   tc=TrainConfig(checkpoint_every=1, log_every=1000),
                   log_fn=lambda s: None, device="cpu", ctx=ctx)


def _worker(rank, world, tmp, shape):
    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world)
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.param import tree_leaves
    from repro_torch.sharding import ShardCtx, train_layout

    ctx = ShardCtx.for_mesh(make_debug_mesh(shape, ("data", "model")))
    out = {}
    if shape == (2, 2):
        state = _state()
        layout = train_layout(ctx, _cfg(), "gather", state)
        local = layout.shard(state)
        back = layout.gather(local)
        out["local"] = local
        out["round_trip"] = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(state), tree_leaves(back)))
        tr = _trainer(f"{tmp}/ckpt", ctx)
        res = tr.run(1)
        out["trained"] = tr.layout.gather(res["state"])
    else:
        tr = _trainer(f"{tmp}/../4/ckpt", ctx)
        res = tr.run(1)
        out["resumed_from"] = tr.stats["resumed_from"]
        out["restored"] = tr.layout.gather(res["state"])
    torch.save(out, f"{tmp}/rank{rank}.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("layout")
    out = {}
    for world, shape in ((4, (2, 2)), (2, (1, 2))):
        d = tmp / str(world)
        d.mkdir()
        torch.multiprocessing.spawn(_worker, args=(world, str(d), shape),
                                    nprocs=world)
        out[world] = [torch.load(d / f"rank{r}.pt") for r in range(world)]
    out["ckpt"] = str(tmp / "4" / "ckpt")
    return out


REFERENCE = textwrap.dedent(
    """
    import dataclasses, json, os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import numpy as np
    from repro.configs import get_reduced
    from repro.launch.mesh import make_debug_mesh
    from repro.optim import adafactor, constant
    from repro.sharding import ShardCtx, tree_shardings
    from repro.training.train_loop import init_train_state, state_axes

    cfg = dataclasses.replace(get_reduced(%r), **%r)
    opt = adafactor(constant(1e-2))
    shapes = jax.eval_shape(
        lambda: init_train_state(jax.random.PRNGKey(0), cfg, opt))
    mesh = make_debug_mesh((2, 2), ("data", "model"))
    ctx = ShardCtx.for_mesh(mesh)
    sh = tree_shardings(state_axes(cfg), shapes, mesh, ctx.param_rules)
    place = {d.id: i for i, d in enumerate(np.asarray(mesh.devices).flat)}
    out = {}
    for (path, s), a in zip(jax.tree_util.tree_flatten_with_path(sh)[0],
                            jax.tree_util.tree_leaves(shapes)):
        name = "".join("/" + str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[name] = {
            place[d.id]: [[sl.start or 0, n if sl.stop is None else sl.stop]
                          for sl, n in zip(idx, a.shape)]
            for d, idx in s.devices_indices_map(a.shape).items()}
    print(json.dumps(out))
    """
) % (ARCH, WIDTH)


@pytest.fixture(scope="module")
def reference_blocks():
    env = dict(os.environ, PYTHONPATH="src")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", REFERENCE], env=env, cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("rank", range(4))
def test_each_rank_holds_the_block_the_reference_spec_names(
        runs, reference_blocks, rank):
    glob = _flat(_state())
    assert set(glob) == set(reference_blocks)
    local = _flat(runs[4][rank]["local"])
    assert set(local) == set(glob)
    sharded = 0
    for name, t in glob.items():
        block = reference_blocks[name][str(rank)]
        want = t[tuple(slice(a, b) for a, b in block)]
        assert torch.equal(local[name], want), name
        sharded += local[name].numel() < t.numel()
    # The placement shards: embed over data, heads and experts over
    # model, the factored slots with them.
    assert sharded >= 10


def test_shard_then_gather_is_the_identity(runs):
    assert all(got["round_trip"] for got in runs[4])


def test_checkpoint_from_2x2_restores_on_one_rank(runs):
    trained = _flat(runs[4][0]["trained"])
    one, step, _ = CheckpointManager(runs["ckpt"]).restore_latest(_state())
    assert step == 1
    for name, t in _flat(one).items():
        assert torch.equal(t, trained[name]), name


def test_checkpoint_from_2x2_restores_on_1x2(runs):
    trained = _flat(runs[4][0]["trained"])
    for got in runs[2]:
        assert got["resumed_from"] == 1
        for name, t in _flat(got["restored"]).items():
            assert torch.equal(t, trained[name]), name
