"""Port parity for the optimizers and what feeds them: ``repro_torch.
optim`` (AdamW, SGD, the four schedules), gradient accumulation and
gradient compression (``make_train_step``,
``repro_torch.training.compression``) and per-host data slicing
(``repro_torch.data``) against the JAX package, on numpy inputs from a
seed and the reduced granite and ViT; a compressed Trainer checkpoint
restored across the packages, both ways; ``python -m
repro_torch.obs.lint``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint import store as jstore
from repro.configs import get_reduced as jax_reduced
from repro.data import make_iterator as jmake_iterator
from repro.models import model_zoo as jzoo
from repro.models import param as jpm
from repro.optim import adafactor as jadafactor
from repro.optim import adamw as jadamw
from repro.optim import schedules as jsched
from repro.optim import sgd as jsgd
from repro.training import compression as jcomp
from repro.training import train_loop as jtl
from repro_torch.checkpoint import CheckpointManager, store
from repro_torch.configs import get_reduced
from repro_torch.data import make_iterator
from repro_torch.models import model_zoo as zoo
from repro_torch.models.convert import from_jax_values, to_jax_values
from repro_torch.optim import adafactor, adamw, schedules, sgd
from repro_torch.training import (
    TrainConfig,
    Trainer,
    compression,
    init_train_state,
    make_train_step,
)
from torch_threads import one_thread  # noqa: F401 (autouse)

ARCH, VIT = "granite-moe-1b-a400m", "vit-b16-upcycled"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _init(jcfg):
    """The JAX init's values (seed 0), traced once: eager it dispatches
    thousands of small ops."""
    return _np(jax.jit(lambda k: jpm.split(jzoo.init_params(k, jcfg))[0])(
        jax.random.PRNGKey(0)))


def _equal_trees(t, j):
    ft, tt = jax.tree.flatten(t)
    fj, tj = jax.tree.flatten(j)
    assert tt == tj
    for a, b in zip(ft, fj):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

# (name, kwargs, the steps: 0, the warmup's end, the cooldown's start
# and end, and steps between and past them).
SCHEDULES = [
    ("constant", dict(lr=0.3), [0, 1, 7, 1000]),
    ("inverse_sqrt", dict(peak=0.01, warmup_steps=10), [0, 5, 10, 11, 400]),
    ("rsqrt_with_cooldown", dict(peak=4e-4, warmup_steps=10, timescale=100,
                                 cooldown_start=50, cooldown_steps=20),
     [0, 1, 5, 10, 11, 49, 50, 60, 70, 71, 500]),
    ("rsqrt_with_cooldown", dict(peak=1e-3, warmup_steps=0, timescale=7),
     [0, 1, 6, 7, 8, 10_000]),
    ("cosine", dict(peak=0.1, total_steps=100, warmup_steps=10, floor=1e-3),
     [0, 1, 5, 10, 11, 50, 99, 100, 150]),
    ("cosine", dict(peak=0.1, total_steps=30), [0, 1, 15, 29, 30, 31]),
]


@pytest.mark.parametrize("name,kw,steps", SCHEDULES)
def test_schedules_match_the_reference(name, kw, steps):
    """f32 on both sides; the transcendental (sqrt, cos) may round one
    ulp apart: rtol 1e-6, and exact zeros where the cooldown ends."""
    jf, tf = getattr(jsched, name)(**kw), getattr(schedules, name)(**kw)
    for s in steps:
        t = tf(torch.tensor(s, dtype=torch.int32))
        j = jf(jnp.asarray(s, jnp.int32))
        assert t.dtype == torch.float32
        np.testing.assert_allclose(float(t), float(j), rtol=1e-6, atol=0,
                                   err_msg=f"step {s}")


# ---------------------------------------------------------------------------
# AdamW and SGD
# ---------------------------------------------------------------------------

LEAVES = {"w": (64, 48), "stack": {"experts": (2, 3, 16, 8)}, "b": (7,)}


def _tree(rng, shapes, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    return (rng.normal(size=shapes) * scale).astype(np.float32)


@pytest.mark.parametrize("name,kw", [
    ("adamw", {}),
    ("adamw", dict(b1=0.8, b2=0.99, eps=1e-6, weight_decay=0.1)),
    ("sgd", {}),
    ("sgd", dict(momentum=0.0)),
])
def test_optimizers_match_the_reference(name, kw):
    """10 steps on the same gradients (their scale swept over 1e-3..1e2)
    under the vision schedule, each step's updates and state, and the
    params, at rtol 1e-5 (f32 elementwise math; pow and sqrt may round
    apart); the state keeps the reference's key paths."""
    sched = dict(peak=0.05, warmup_steps=3, timescale=10, cooldown_start=6,
                 cooldown_steps=4)
    jopt = {"adamw": jadamw, "sgd": jsgd}[name](
        jsched.rsqrt_with_cooldown(**sched), **kw)
    topt = {"adamw": adamw, "sgd": sgd}[name](
        schedules.rsqrt_with_cooldown(**sched), **kw)
    rng = np.random.default_rng(0)
    p0 = _tree(rng, LEAVES)
    jp, tp = jax.tree.map(jnp.asarray, p0), from_jax_values(p0)
    js, ts = jopt.init(jp), topt.init(tp)
    assert jax.tree.structure(_np(js)) == jax.tree.structure(
        to_jax_values(ts))
    for i in range(10):
        g = _tree(rng, LEAVES, scale=10.0 ** (i % 6 - 3))
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = topt.update(from_jax_values(g), ts, tp)
        for t, j in ((tu, ju), (ts, js)):
            for a, b in zip(jax.tree.leaves(to_jax_values(t)),
                            jax.tree.leaves(_np(j))):
                np.testing.assert_allclose(a, b, rtol=1e-5,
                                           atol=1e-5 * np.abs(b).max())
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        tp = jax.tree.map(lambda p, u: p + u, tp, tu)
    assert int(ts["step"]) == int(js["step"]) == 10
    for a, b in zip(jax.tree.leaves(to_jax_values(tp)),
                    jax.tree.leaves(_np(jp))):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_adafactor_zero_rows_beside_huge_rows_match_the_reference():
    """A reference fault the port copies (ROADMAP.md queue 3): where a
    factored leaf's gradient has zero rows beside rows of ~1e9, the
    zero rows' 1e-30 floor over the row mean underflows, its rsqrt is
    inf and 0 * inf makes the update NaN (the RMS clip then spreads it
    over the leaf), with a finite gradient norm that the non-finite
    guard passes. granite's reference init (gradient norm ~5e11) with
    int8 compression hits it on the card."""
    rng = np.random.default_rng(0)
    g = np.zeros((256, 128), np.float32)
    g[:4] = 1e9 * rng.normal(size=(4, 128))
    p = rng.normal(size=(256, 128)).astype(np.float32)
    jopt = jadafactor(jsched.constant(0.01))
    topt = adafactor(schedules.constant(0.01))
    ju, _ = jopt.update({"w": jnp.asarray(g)},
                        jopt.init({"w": jnp.asarray(p)}),
                        {"w": jnp.asarray(p)})
    tu, _ = topt.update({"w": torch.tensor(g)},
                        topt.init({"w": torch.tensor(p)}),
                        {"w": torch.tensor(p)})
    assert not np.isfinite(np.asarray(ju["w"])).any()
    assert not bool(torch.isfinite(tu["w"]).any())
    g[:4] = 1e3 * rng.normal(size=(4, 128))  # a row mean far below 1e15
    tu, _ = topt.update({"w": torch.tensor(g)},
                        topt.init({"w": torch.tensor(p)}),
                        {"w": torch.tensor(p)})
    assert bool(torch.isfinite(tu["w"]).all())


@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_optimizer_state_checkpoints_cross_packages(tmp_path, name):
    """An AdamW / SGD state saved by either package's store loads in the
    other's bit for bit (the same key paths and leaf files)."""
    rng = np.random.default_rng(1)
    p0 = _tree(rng, LEAVES)
    g = _tree(rng, LEAVES)
    sched = dict(peak=0.01, warmup_steps=2)
    jopt = {"adamw": jadamw, "sgd": jsgd}[name](jsched.inverse_sqrt(**sched))
    topt = {"adamw": adamw, "sgd": sgd}[name](schedules.inverse_sqrt(**sched))
    _, ts = topt.update(from_jax_values(g), topt.init(from_jax_values(p0)),
                        from_jax_values(p0))
    _, js = jopt.update(jax.tree.map(jnp.asarray, g),
                        jopt.init(jax.tree.map(jnp.asarray, p0)),
                        jax.tree.map(jnp.asarray, p0))
    store.save_tree(str(tmp_path / "port"), ts)
    _equal_trees(_np(jstore.load_tree(str(tmp_path / "port"), js)),
                 to_jax_values(ts))
    jstore.save_tree(str(tmp_path / "ref"), js)
    _equal_trees(to_jax_values(store.load_tree(str(tmp_path / "ref"), ts)),
                 _np(js))


# ---------------------------------------------------------------------------
# gradient accumulation
# ---------------------------------------------------------------------------

JAC = {ARCH: dict(dispatch="sorted", sorted_block=8, moe_impl="xla",
                  attn_impl="xla"),
       VIT: dict(dispatch="gather", moe_impl="xla", attn_impl="xla")}
TAC = {ARCH: dict(dispatch="sorted"), VIT: dict(dispatch="gather")}


def _condition(params, cfg):
    """Attention projections rescaled to fan-in d (the reference's
    fan-in rule makes random models chaotic: ROADMAP.md queue 3)."""
    H, Kh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    scale = {"wq": (H / d) ** 0.5, "wk": (Kh / d) ** 0.5,
             "wv": (Kh / d) ** 0.5}
    out = jax.tree.map(np.array, params)
    for seg in out["stack"]["segments"]:
        for pos in seg.values():
            for k, c in scale.items():
                pos["mixer"][k] = pos["mixer"][k] * np.float32(c)
    return out


@pytest.mark.parametrize("arch", [ARCH, VIT])
def test_grad_accumulation_matches_the_reference(arch):
    """grad_accum=2 on batches of 4 (Expert Choice groups form per
    microbatch in both packages), 2 Adafactor steps from the same
    conditioned state: losses at rtol 2e-5, gradient norms at 2e-4, the
    params at the step parity's 1e-5 / 1e-4."""
    jcfg, tcfg = jax_reduced(arch), get_reduced(arch)
    vals = _init(jcfg)
    sched = dict(peak=0.01, warmup_steps=2)
    jopt = jadafactor(jsched.inverse_sqrt(**sched))
    topt = adafactor(schedules.inverse_sqrt(**sched))
    js = jtl.init_train_state(
        jax.random.PRNGKey(0), jcfg, jopt,
        params=jax.tree.map(jnp.asarray, _condition(vals, jcfg)))
    ts = from_jax_values(_np(js))
    jstep = jax.jit(jtl.make_train_step(
        jcfg, jopt, ac=jzoo.ApplyCfg(**JAC[arch]),
        tc=jtl.TrainConfig(grad_accum=2)))
    tstep = make_train_step(tcfg, topt, ac=zoo.ApplyCfg(**TAC[arch]),
                            tc=TrainConfig(grad_accum=2))
    it = jmake_iterator(jcfg, global_batch=4, seq_len=16, host_index=0,
                        host_count=1)
    for _ in range(2):
        b = next(it)
        js, jm = jstep(js, b)
        ts, tm = tstep(ts, b)
        assert float(tm["skipped"]) == 0.0
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=2e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=2e-4)
    for a, b in zip(jax.tree.leaves(to_jax_values(ts["params"])),
                    jax.tree.leaves(_np(js["params"]))):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4)


def test_grad_accumulation_equivalence_with_sgd():
    """The reference's test_grad_accumulation_equivalence on the port:
    one SGD step with grad_accum=2 equals one with the whole batch, on a
    dense model (no routing groups to split): params within 1e-5."""
    cfg = get_reduced(ARCH).dense_parent()
    opt = sgd(schedules.constant(0.1), momentum=0.0)
    batch = next(make_iterator(cfg, global_batch=4, seq_len=16))
    out = []
    for accum in (1, 2):
        state = init_train_state(0, cfg, opt, device="cpu")
        step = make_train_step(cfg, opt, tc=TrainConfig(grad_accum=accum))
        state, _ = step(state, batch)
        out.append(state["params"])
    for a, b in zip(jax.tree.leaves(to_jax_values(out[0])),
                    jax.tree.leaves(to_jax_values(out[1]))):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_compression_is_the_reference_bit_for_bit(kind):
    """5 steps of error feedback on the same gradients (leaf scales
    spread 1e-2..1e2): the compressed gradients and the residual equal
    the reference's jitted ones bit for bit."""
    rng = np.random.default_rng(0)

    def grads():
        return {k: (rng.normal(size=s) * rng.uniform(1e-2, 1e2)).astype(
            np.float32) for k, s in (("a", (64, 33)), ("b", (7,)),
                                     ("c", (3, 5, 11)))}

    g0 = grads()
    je = jcomp.init_residual(jax.tree.map(jnp.asarray, g0))
    te = compression.init_residual(from_jax_values(g0))
    step = jax.jit(lambda g, e: jcomp.compress(g, e, kind))
    for _ in range(5):
        g = grads()
        jg, je = step(jax.tree.map(jnp.asarray, g), je)
        tg, te = compression.compress(from_jax_values(g), te, kind)
        _equal_trees(to_jax_values(tg), _np(jg))
        _equal_trees(to_jax_values(te), _np(je))
    assert max(float(np.abs(x).max()) for x in jax.tree.leaves(
        to_jax_values(te))) > 0


def test_compression_none_and_unknown_kind():
    g = {"a": torch.ones(3)}
    e = compression.init_residual(g)
    assert compression.compress(g, e, "none") == (g, e)
    with pytest.raises(ValueError, match="unknown compression 'fp4'"):
        compression.compress(g, e, "fp4")
    with pytest.raises(ValueError, match="unknown compression 'fp4'"):
        jcomp.compress({"a": jnp.ones(3)}, {"a": jnp.zeros(3)}, "fp4")


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_compressed_checkpoint_restores_across_packages(tmp_path, writer):
    """A Trainer with int8 compression and grad_accum 2 trains 2 steps
    of reduced granite's dense parent to a checkpoint (the residual
    included) in one package; the other package restores it bit for bit
    and its Trainer resumes from it to step 3."""
    jcfg = jax_reduced(ARCH).dense_parent()
    tcfg = get_reduced(ARCH).dense_parent()
    vals = _init(jcfg)
    kw = dict(grad_accum=2, compression="int8", checkpoint_every=2,
              log_every=1000)
    jtc, tc = jtl.TrainConfig(**kw), TrainConfig(**kw)
    d = str(tmp_path / "run")
    sched = dict(peak=0.01, warmup_steps=2)

    def jax_trainer():
        it = jmake_iterator(jcfg, global_batch=4, seq_len=8, host_index=0,
                            host_count=1)
        return jtl.Trainer(jcfg, jadafactor(jsched.inverse_sqrt(**sched)),
                           it, d, ac=jzoo.ApplyCfg(moe_impl="xla",
                                                   attn_impl="xla"),
                           tc=jtc, log_fn=lambda s: None)

    def port_trainer():
        it = make_iterator(tcfg, global_batch=4, seq_len=8)
        return Trainer(tcfg, adafactor(schedules.inverse_sqrt(**sched)), it,
                       d, tc=tc, log_fn=lambda s: None, device="cpu")

    if writer == "reference":
        out = jax_trainer().run(2, init_params=jax.tree.map(jnp.asarray,
                                                            vals))
        saved = _np(out["state"])
        like = init_train_state(0, tcfg, adafactor(schedules.constant(0.0)),
                                device="cpu", tc=tc)
        restored, step, _ = CheckpointManager(d).restore_latest(like)
        restored, resume = to_jax_values(restored), port_trainer
    else:
        out = port_trainer().run(2, init_params=from_jax_values(_np(vals)))
        saved = to_jax_values(out["state"])
        like = jtl.init_train_state(jax.random.PRNGKey(0), jcfg,
                                    jadafactor(jsched.constant(0.0)), tc=jtc)
        restored, step, _ = JManager(d).restore_latest(like)
        restored, resume = _np(restored), jax_trainer
    assert step == 2
    assert set(saved) == {"params", "opt_state", "step", "residual"}
    _equal_trees(restored, saved)
    assert max(float(np.abs(x).max())
               for x in jax.tree.leaves(saved["residual"])) > 0
    out = resume().run(3)
    assert int(out["state"]["step"]) == 3
    assert np.isfinite(float(out["metrics"]["loss"]))


# ---------------------------------------------------------------------------
# per-host data slicing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [ARCH, "vit-b16-upcycled"])
def test_host_sharding_partitions_batch(arch):
    """The reference's test on the port: two hosts' slices of a global
    batch of 8 concatenate to the one-host batch, and each host's slice
    is the reference's for that host, leaf by leaf."""
    jcfg, tcfg = jax_reduced(arch), get_reduced(arch)
    kw = dict(global_batch=8, seq_len=16)
    hosts = [make_iterator(tcfg, host_index=i, host_count=2, **kw)
             for i in range(2)]
    full = next(make_iterator(tcfg, host_index=0, host_count=1, **kw))
    got = [next(it) for it in hosts]
    for k, v in full.items():
        assert got[0][k].shape[0] == 4
        np.testing.assert_array_equal(np.concatenate([g[k] for g in got]), v)
    for i, g in enumerate(got):
        want = next(jmake_iterator(jcfg, host_index=i, host_count=2, **kw))
        assert sorted(g) == sorted(want)
        for k in g:
            np.testing.assert_array_equal(g[k], want[k])
    assert hosts[1].state() == {"step": 1, "skipped_batches": 0}


def test_make_iterator_reads_the_process_group(monkeypatch):
    """Without a process group the iterator is host 0 of 1; with one it
    takes the group's rank and world size."""
    import torch.distributed as dist

    cfg = get_reduced(ARCH)
    it = make_iterator(cfg, global_batch=8, seq_len=8)
    assert (it.host_index, it.host_count) == (0, 1)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    it = make_iterator(cfg, global_batch=8, seq_len=8)
    assert (it.host_index, it.host_count) == (1, 4)
    batch = next(it)
    full = next(make_iterator(cfg, global_batch=8, seq_len=8, host_index=0,
                              host_count=1))
    np.testing.assert_array_equal(batch["tokens"], full["tokens"][2:4])


# ---------------------------------------------------------------------------
# the metric-name lint and the serve shim
# ---------------------------------------------------------------------------


def test_obs_lint_passes(capsys):
    from repro_torch.obs import lint

    assert lint.main() == 0
    assert "[obs-lint] OK" in capsys.readouterr().out


def test_obs_lint_fails_on_an_undocumented_name(tmp_path):
    from repro_torch.obs import lint

    rows = [{"kind": "counter", "name": "serve.admissions", "t": 0},
            {"kind": "train", "t": 1, "loss": 1.0, "new_field": 2.0}]
    doc = lint.documented_names()
    assert sorted(n for n in lint.emitted_names(rows) if n not in doc) == [
        "new_field"]


def test_training_serve_shim():
    from repro_torch import serve
    from repro_torch.training import serve as shim

    assert shim.ServeEngine is serve.ServeEngine
    assert shim.ServeConfig is serve.ServeConfig
    assert shim.Request is serve.Request
