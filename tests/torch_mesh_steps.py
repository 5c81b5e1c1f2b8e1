"""One train step of a family under the rules' placement on ``gloo``
ranks, the same step in one process, and the reference's sharded step
(``make_train_step(ctx=)`` on a forced 4-device (2, 2) debug mesh, run
in a subprocess): the parts that ``tests/test_torch_mesh_encdec.py`` and
``tests/test_torch_mesh_families.py`` share, and the spawn of the ranks
(:func:`spawn_ranks`, :func:`join_ranks`) with the rank step whose live
bytes ``tests/test_torch_memory.py`` counts (:func:`memory_worker`).

Every case starts from the port's random weights (seed 0; an upcycled
case from its dense parent at seed 0, routers from seed 7; conditioned,
:func:`condition`), carried to
the reference by ``models/convert.to_jax_values``, and takes one step
of Adafactor at ``eps1 = 1e-6`` on a global batch of 8 x 32 from
``make_iterator`` (numpy arrays handed to the reference): at the default
1e-30 an unfactored leaf's first update is ``sign(g)``, and an element
whose gradient lies within float32's reassociation noise takes either
sign in two correct runs (``tests/test_torch_mesh_train.py``). The
module imports torch and the port only; the reference runs from the
text :data:`REFERENCE`.
"""
import dataclasses
import textwrap

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.core.upcycle import upcycle_params
from repro_torch.data import make_iterator
from repro_torch.models import model_zoo as zoo
from repro_torch.optim import adafactor, constant
from repro_torch.training import init_train_state, make_train_step

BATCH, SEQ = 8, 32
ATOL, RTOL, LOSS_RTOL, GN_RTOL = 2e-4, 2e-3, 2e-4, 1e-3
ARCHS = {"t5": "t5-base-upcycled", "t5_straddle": "t5-base-upcycled",
         "whisper": "whisper-base", "jamba": "jamba-1.5-large-398b",
         "pixtral": "pixtral-12b", "rwkv": "rwkv6-7b"}
# T5's routing groups: 32 tokens, so that a data rank's 4 x 32 encoder
# and 4 x 8 decoder tokens form whole groups (the one process's); at the
# reduced config's 64 a data rank holds half a decoder group, which
# ``moe_apply`` refuses (``t5_straddle``).
T5_GROUP = 32
# The reference's default dispatch.
AC = zoo.ApplyCfg(dispatch="gather")


def cfg_of(case):
    cfg = get_reduced(ARCHS[case])
    if case == "t5":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, group_size=T5_GROUP))
    return cfg


def optimizer():
    return adafactor(constant(1e-2), eps1=1e-6)


def condition(params, cfg) -> None:
    """Rescale the random weights in place as ``chip_smoke`` conditions
    them (``condition_attention``, ``condition_rwkv``): every attention
    projection (the encoder's, the decoder's self and cross attention)
    to fan-in d, an rwkv time mix's ``w0`` interleaved over the heads and
    its ``wr``, ``wk``, ``wv``, ``wg`` at fan-in d. At the reference's
    init (fan-in = the head count) the model is chaotic: the split's
    float32 reassociation moves a pixtral embedding's Adafactor slot by
    2% and an rwkv step's gradient norm by 1e-3."""
    H, Kh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    for key in ("encoder", "stack"):
        for seg in params.get(key, {"segments": []})["segments"]:
            for pos in seg.values():
                for m in (pos[n] for n in ("mixer", "cross") if n in pos):
                    if "wq" in m:
                        m["wq"] *= (H / d) ** 0.5
                        m["wk"] *= (Kh / d) ** 0.5
                        m["wv"] *= (Kh / d) ** 0.5
                    if "w0" in m:
                        K = cfg.ssm.head_size
                        Hr = d // K
                        reps = m["w0"].shape[0]
                        m["w0"].copy_(m["w0"].reshape(reps, Hr, K)
                                      .transpose(1, 2).reshape(reps, d))
                        for n in ("wr", "wk", "wv", "wg"):
                            m[n] *= (Hr / d) ** 0.5


def setup(case):
    """(cfg, params, the global batch) of a case (weights conditioned,
    :func:`condition`)."""
    cfg = cfg_of(case)
    if cfg.moe is not None and cfg.moe.expert_init == "copy" \
            and cfg.structure == "encoder_decoder":
        dense_cfg = cfg.dense_parent()
        dense = zoo.init_params(0, dense_cfg, device="cpu")
        params = upcycle_params(dense, dense_cfg, cfg,
                                torch.Generator().manual_seed(7))
    else:
        params = zoo.init_params(0, cfg, device="cpu")
    condition(params, cfg)
    batch = next(make_iterator(cfg, global_batch=BATCH, seq_len=SEQ,
                               host_index=0, host_count=1))
    return cfg, params, batch


def flat(tree, pre=""):
    if isinstance(tree, dict):
        return {k: v for kk, vv in tree.items()
                for k, v in flat(vv, f"{pre}/{kk}" if pre else kk).items()}
    if isinstance(tree, list):
        return {k: v for i, vv in enumerate(tree)
                for k, v in flat(vv, f"{pre}/{i}").items()}
    return {pre: tree}


def save_inputs(tmp, cases):
    """Each case's params (the reference's layout) and global batch, as
    npz files the reference reads."""
    from repro_torch.models.convert import to_jax_values

    for case in cases:
        _, params, batch = setup(case)
        np.savez(f"{tmp}/{case}_params.npz", **flat(to_jax_values(params)))
        np.savez(f"{tmp}/{case}_batch.npz",
                 **{k: np.asarray(v) for k, v in batch.items()})


def mesh_step(case, ctx):
    """One step of ``case`` on this rank under ``train_layout``:
    {gathered state, metrics, collective payloads counted, gathered
    reduced gradients}."""
    from repro_torch.sharding import comm, train_layout
    from repro_torch.training.train_loop import (
        batch_to,
        loss_and_grads,
        reduce_grads,
    )

    cfg, params, batch = setup(case)
    ac, opt = AC, optimizer()
    state = init_train_state(None, cfg, opt, params=params)
    layout = train_layout(ctx, cfg, ac.dispatch, state)
    state = layout.shard(state)
    i, n = layout.batch_rows()
    per = BATCH // n
    local = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
    step = make_train_step(cfg, opt, ac=ac, layout=layout)
    grads, _ = loss_and_grads(state["params"], batch_to(local, "cpu"), cfg,
                              ac=ac, ctx=layout.ctx,
                              specs=layout.specs["params"])
    grads = layout.gather({"params": reduce_grads(
        grads, layout.specs["params"], layout.ctx, layout.token_axes)})
    comm.reset_counts()
    state, mets = step(state, local)
    counts = comm.counts()
    return {"state": layout.gather(state),
            "mets": {k: float(v) for k, v in mets.items()},
            "counts": counts, "grads": grads}


def one_step(case):
    """(state, metrics, gradients) of the one-process step."""
    from repro_torch.training.train_loop import batch_to, loss_and_grads

    cfg, params, batch = setup(case)
    ac, opt = AC, optimizer()
    grads, _ = loss_and_grads(params, batch_to(batch, "cpu"), cfg, ac=ac)
    step = make_train_step(cfg, opt, ac=ac)
    state, mets = step(init_train_state(None, cfg, opt, params=params),
                       batch)
    return state, {k: float(v) for k, v in mets.items()}, {"params": grads}


def hold(got, one, ref):
    """A case's mesh step against the one process's (every leaf of the
    state, the optimizer's slots included; the reduced gradients within
    1e-3 of each leaf's largest) and the reference's sharded step (loss,
    gradient norm, every parameter)."""
    state, mets, grads = one
    a, b = flat(grads), flat(got["grads"])
    assert set(a) == set(b)
    for k in a:
        gap = float((b[k] - a[k]).abs().max())
        assert gap <= 1e-3 * float(a[k].abs().max()) + 1e-6, (k, gap)
    for want in (mets, ref):
        np.testing.assert_allclose(got["mets"]["loss"], want["loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["mets"]["grad_norm"],
                                   want["grad_norm"], rtol=GN_RTOL)
    a, b = flat(state), flat(got["state"])
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), atol=ATOL,
                                   rtol=RTOL, err_msg=k)
    from repro_torch.models.convert import to_jax_values

    mine = flat(to_jax_values(got["state"]["params"]))
    assert set(mine) == set(ref["params"])
    for k, v in ref["params"].items():
        np.testing.assert_allclose(mine[k], v, atol=ATOL, rtol=RTOL,
                                   err_msg=f"reference {k}")


def spawn_ranks(worker, tmp, *args, world: int = 4):
    """``world`` spawned ranks of ``worker(rank, world, tmp, *args)``,
    not joined: the caller runs its one process meanwhile, then
    :func:`join_ranks`."""
    return torch.multiprocessing.start_processes(
        worker, args=(world, tmp, *args), nprocs=world, join=False,
        start_method="spawn")


def join_ranks(procs, tmp, world: int = 4) -> list:
    """Wait for the ranks; each rank's ``rank{r}.pt`` under ``tmp``."""
    while not procs.join():
        pass
    return [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
            for r in range(world)]


def init_rank(rank, world, tmp) -> None:
    """A rank's process group (gloo, rendezvous through a file under
    ``tmp``), one torch thread."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world)


# The train cell whose rank step ``tests/test_torch_memory.py`` counts:
# the reduced granite at BATCH x SEQ under the ``optimized`` profile's
# rules on (2, 2), the plain versions (the CPU's), as ``launch/specs.
# build_cell`` builds it (its Adafactor, TrainConfig and int32 batch).
MEMORY_ARCH, MEMORY_PROFILE = "granite-moe-1b-a400m", "optimized"
MEMORY_AC = dict(dispatch="gather", compute_dtype="float32", remat="none",
                 ce_chunk=0, pad_heads_multiple=0, moe_impl="eager",
                 attn_impl="eager", mixer_impl="eager")


def memory_worker(rank, world, tmp):
    """A rank's step of the memory cell on the CPU under
    ``launch/memory.measure``: its report to ``rank{rank}.pt``."""
    import torch.distributed as dist

    from repro_torch.launch.memory import measure
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.specs import PROFILES, make_ctx
    from repro_torch.optim import adafactor, inverse_sqrt
    from repro_torch.sharding import train_layout
    from repro_torch.training import TrainConfig

    init_rank(rank, world, tmp)
    cfg = get_reduced(MEMORY_ARCH)
    ctx = make_ctx(make_debug_mesh((2, 2), ("data", "model")), cfg,
                   PROFILES[MEMORY_PROFILE])
    ac = zoo.ApplyCfg(**MEMORY_AC)
    opt = adafactor(inverse_sqrt(peak=0.01, warmup_steps=10_000))
    state = init_train_state(0, cfg, opt, device="cpu")
    layout = train_layout(ctx, cfg, ac.dispatch, state)
    state = layout.shard(state)
    i, n = layout.batch_rows()
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (BATCH // n, SEQ), dtype=np.int32))
        for k in ("tokens", "targets")}
    step = make_train_step(cfg, opt, ac=ac, tc=TrainConfig(), layout=layout)
    _, rep = measure(step, state, batch)
    torch.save(rep, f"{tmp}/rank{rank}.pt")
    dist.destroy_process_group()


def payloads(case):
    from repro_torch.launch.dryrun import rules_collective_payloads

    cfg = cfg_of(case)
    return rules_collective_payloads(
        cfg, params=zoo.init_params(None, cfg, device="meta"),
        mesh={"data": 2, "model": 2}, dispatch=AC.dispatch,
        remat="none", tokens=BATCH * SEQ, itemsize=4)


def load_reference(tmp, case):
    with np.load(f"{tmp}/ref_{case}.npz") as z:
        out = {"params": {k[2:]: z[k] for k in z.files if k[:2] == "p:"}}
        out.update(loss=float(z["loss"]), grad_norm=float(z["grad_norm"]))
    return out


# The reference's sharded step of each case named on the command line:
# the state placed by the rules (``tree_shardings(state_axes(cfg))``) on
# a (data=2, model=2) debug mesh, one jitted ``make_train_step(ctx=)``.
REFERENCE = textwrap.dedent("""
    import dataclasses, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get_reduced
    from repro.launch.mesh import make_debug_mesh
    from repro.models import model_zoo as zoo
    from repro.models import param as pm
    from repro.optim import adafactor, constant
    from repro.sharding import ShardCtx, tree_shardings
    from repro.training.train_loop import (
        init_train_state, make_train_step, state_axes)

    tmp, *cases = sys.argv[1:]
    archs = {archs}
    name = lambda p: "/".join(
        str(getattr(k, "key", getattr(k, "idx", None))) for k in p)
    mesh = make_debug_mesh((2, 2), ("data", "model"))
    ctx = ShardCtx.for_mesh(mesh)
    opt = adafactor(constant(1e-2), eps1=1e-6)
    ac = zoo.ApplyCfg(dispatch="gather", moe_impl="xla", attn_impl="xla")
    for case in cases:
        cfg = get_reduced(archs[case])
        if case == "t5":
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, group_size={group}))
        z = np.load(f"{{tmp}}/{{case}}_params.npz")
        vals, _ = pm.split(jax.eval_shape(
            lambda: zoo.init_params(jax.random.PRNGKey(0), cfg)))
        vals = jax.tree_util.tree_map_with_path(
            lambda p, _: jnp.asarray(z[name(p)]), vals)
        batch = {{k: jnp.asarray(v) for k, v in
                  np.load(f"{{tmp}}/{{case}}_batch.npz").items()}}
        state = init_train_state(jax.random.PRNGKey(0), cfg, opt,
                                 params=vals)
        sh = tree_shardings(state_axes(cfg), jax.eval_shape(lambda: state),
                            mesh, ctx.param_rules)
        step = jax.jit(make_train_step(cfg, opt, ac=ac, ctx=ctx))
        with mesh:
            new, m = step(jax.device_put(state, sh), batch)
        out = {{"p:" + name(p): np.asarray(v) for p, v in
               jax.tree_util.tree_flatten_with_path(new["params"])[0]}}
        np.savez(f"{{tmp}}/ref_{{case}}.npz", loss=np.asarray(m["loss"]),
                 grad_norm=np.asarray(m["grad_norm"]), **out)
""").format(archs=repr(ARCHS), group=T5_GROUP)
