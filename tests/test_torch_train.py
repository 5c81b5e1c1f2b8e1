"""Port parity for the training slice: the data stream, the LR
schedules and Adafactor, the upcycling surgery, ``loss_fn`` and its
gradients, and dense-parent -> upcycle -> MoE training steps of
``repro_torch`` against the JAX package, on reduced granite and its
reduced dense parent (float32; the JAX model runs its "xla" paths, the
kernels' parity is held in test_torch_attention.py / test_torch_moe.py).
Also: the JAX train state crosses to the port and back, and the
training launcher runs on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.core import upcycle as jup
from repro.data import make_iterator as jmake_iterator
from repro.models import model_zoo as jzoo
from repro.models import param as jpm
from repro.optim import adafactor as jadafactor
from repro.optim import schedules as jsched
from repro.training import train_loop as jtl
from repro_torch.configs import get_reduced
from repro_torch.core import upcycle as tup
from repro_torch.data import make_iterator
from repro_torch.models import model_zoo as zoo
from repro_torch.models.convert import from_jax_values, to_jax_values
from repro_torch.models.param import tree_leaves
from repro_torch.optim import adafactor, schedules
from repro_torch.training import init_train_state, make_train_step
from repro_torch.training.train_loop import batch_to, loss_and_grads

ARCH = "granite-moe-1b-a400m"
# The JAX model's sorted dispatch on its CPU ("xla") paths; the port
# runs its plain versions on the CPU.
JAC = jzoo.ApplyCfg(dispatch="sorted", sorted_block=8, moe_impl="xla",
                    attn_impl="xla")
TAC = zoo.ApplyCfg(dispatch="sorted")
# Batches of 4 x 32 tokens: two routing groups of the reduced config's 64.
B, S = 4, 32


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _condition(params, cfg):
    """The JAX init's attention projections rescaled to fan-in d (its
    fan-in rule takes the head count, which makes random models chaotic:
    ROADMAP.md queue 3), so gradients of two f32 implementations can be
    held at 2e-4."""
    H, Kh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    scale = {"wq": (H / d) ** 0.5, "wk": (Kh / d) ** 0.5,
             "wv": (Kh / d) ** 0.5}
    out = jax.tree.map(np.array, params)
    for seg in out["stack"]["segments"]:
        for pos in seg.values():
            for k, c in scale.items():
                pos["mixer"][k] = pos["mixer"][k] * np.float32(c)
    return out


def _close_trees(t, j, *, atol, rtol=0.0, exact=False):
    ft, tt = jax.tree.flatten(to_jax_values(t))
    fj, tj = jax.tree.flatten(_np(j))
    assert tt == tj
    for a, b in zip(ft, fj):
        if exact:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def cfgs():
    j = jax_reduced(ARCH)
    t = get_reduced(ARCH)
    return j, t, j.dense_parent(), t.dense_parent()


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def test_make_iterator_batches_identical(cfgs):
    jcfg, tcfg, _, _ = cfgs
    jit = jmake_iterator(jcfg, global_batch=3, seq_len=16, host_index=0,
                         host_count=1)
    tit = make_iterator(tcfg, global_batch=3, seq_len=16)
    for _ in range(3):
        jb, tb = next(jit), next(tit)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])
    jit.restore({"step": 11})
    tit.restore({"step": 11})
    np.testing.assert_array_equal(next(tit)["tokens"], next(jit)["tokens"])
    assert tit.state()["step"] == jit.state()["step"] == 12


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,kw", [
    ("constant", dict(lr=0.3)),
    ("inverse_sqrt", dict(peak=0.01, warmup_steps=10)),
    ("inverse_sqrt", dict(peak=0.3, warmup_steps=1)),
    ("inverse_sqrt", dict(peak=1e-3, warmup_steps=100)),
])
def test_schedules_match_jax(name, kw):
    steps = np.array([0, 1, 4, 5, 9, 10, 33, 39, 100], np.int32)
    jf, tf = getattr(jsched, name)(**kw), getattr(schedules, name)(**kw)
    for s in steps:
        np.testing.assert_allclose(float(tf(torch.tensor(s))),
                                   float(jf(jnp.asarray(s))), rtol=1e-6)


# Leaves: factored (both last dims >= 128), unfactored, a stacked
# (layer, expert, d, f) leaf whose update RMS and parameter scale span
# the whole leaf, a stacked small leaf left unfactored, a vector.
ADA_LEAVES = {"fac": (160, 130), "unfac": (3, 50),
              "stacked": (2, 3, 140, 130), "norms": (4, 200), "vec": (7,)}


@pytest.mark.parametrize("kw", [
    {},
    dict(beta1=0.9, weight_decay=0.1, multiply_by_parameter_scale=False),
])
def test_adafactor_matches_jax(kw):
    rng = np.random.default_rng(0)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in ADA_LEAVES.items()}
    jopt = jadafactor(jsched.inverse_sqrt(peak=0.01, warmup_steps=2), **kw)
    topt = adafactor(schedules.inverse_sqrt(peak=0.01, warmup_steps=2), **kw)
    jp = jax.tree.map(jnp.asarray, params)
    tp = from_jax_values(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(3):
        g = {k: (rng.normal(size=s) * 10.0 ** (i - 1)).astype(np.float32)
             for k, s in ADA_LEAVES.items()}
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = topt.update(from_jax_values(g), ts, tp)
        _close_trees(tu, ju, atol=1e-6, rtol=1e-5)
        _close_trees(ts, js, atol=1e-6, rtol=1e-5)
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        tp = {k: tp[k] + tu[k] for k in tp}
    assert set(ts["slots"]["fac"]) == {"v_row", "v_col"} | (
        {"m"} if "beta1" in kw else set())
    assert set(ts["slots"]["stacked"]) >= {"v_row", "v_col"}
    assert "v" in ts["slots"]["norms"] and "v" in ts["slots"]["unfac"]


# ---------------------------------------------------------------------------
# the upcycling surgery
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dense_jax(cfgs):
    _, _, jd, _ = cfgs
    vals, _ = jpm.split(jzoo.init_params(jax.random.PRNGKey(0), jd))
    return _condition(vals, jd)


def _jax_upcycle(jd, jcfg, vals):
    _, axes = jpm.split(jzoo.init_params(jax.random.PRNGKey(0), jd))
    sw = jup.upcycle_params(jpm.wrap(vals, axes), jd, jcfg,
                            jax.random.PRNGKey(7))
    return jpm.split(sw)[0]


def _routers(jsparse):
    w = np.asarray(jsparse["stack"]["segments"][0]["pos0"]["ffn"]["router"]
                   ["w"])
    return [w[l] for l in range(w.shape[0])]


def test_upcycle_params_exact_with_jax_routers(cfgs, dense_jax):
    jcfg, tcfg, jd, td = cfgs
    jsparse = _jax_upcycle(jd, jcfg, dense_jax)
    tsparse = tup.upcycle_params(from_jax_values(_np(dense_jax)), td, tcfg,
                                 routers=_routers(jsparse))
    _close_trees(tsparse, jsparse, atol=0, exact=True)
    # Drawn routers: the reference's init (normal, std 0.02), experts
    # copies of the dense MLP.
    drawn = tup.upcycle_params(from_jax_values(_np(dense_jax)), td, tcfg,
                               torch.Generator().manual_seed(3))
    ffn = drawn["stack"]["segments"][0]["pos0"]["ffn"]
    assert abs(float(ffn["router"]["w"].std()) - 0.02) < 0.004
    dense_wi = from_jax_values(_np(dense_jax))["stack"]["segments"][0][
        "pos0"]["ffn"]["wi"]
    for e in range(tcfg.moe.num_experts):
        assert torch.equal(ffn["experts"]["wi"][:, e], dense_wi)


@pytest.mark.parametrize("expert_init", ["copy_noise", "random"])
def test_upcycle_expert_init_ablations(cfgs, dense_jax, expert_init):
    """The paper's ablations (§B.5): experts copied with Gaussian noise
    drawn from the generator, or drawn from scratch with the MoE init."""
    _, tcfg, _, td = cfgs
    moe = dataclasses.replace(tcfg.moe, expert_init=expert_init,
                              init_noise_std=0.01)
    dense = from_jax_values(_np(dense_jax))
    sparse = tup.upcycle_params(dense, td, tcfg.with_moe(moe),
                                torch.Generator().manual_seed(4))
    wi = sparse["stack"]["segments"][0]["pos0"]["ffn"]["experts"]["wi"]
    dense_wi = dense["stack"]["segments"][0]["pos0"]["ffn"]["wi"]
    diff = wi - dense_wi[:, None]
    assert wi.shape == (td.n_layers, moe.num_experts, td.d_model, td.d_ff)
    if expert_init == "copy_noise":
        assert abs(float(diff.std()) - 0.01) < 1e-3
    else:
        assert float(diff.abs().mean()) > 0.05
        assert not torch.equal(wi[:, 0], wi[:, 1])


def test_upcycle_opt_state_and_depth_tile_match_jax(cfgs, dense_jax):
    jcfg, tcfg, jd, td = cfgs
    jopt = jadafactor(jsched.constant(0.01))
    topt = adafactor(schedules.constant(0.01))
    jsparse = _jax_upcycle(jd, jcfg, dense_jax)
    # A dense state with non-zero slots and step.
    rng = np.random.default_rng(1)
    grads = jax.tree.map(
        lambda v: jnp.asarray(rng.normal(size=v.shape), jnp.float32),
        dense_jax)
    _, jdense_state = jopt.update(grads, jopt.init(dense_jax), dense_jax)
    jout = jup.upcycle_opt_state(jopt.init(jsparse), jdense_state, jd, jcfg)
    tout = tup.upcycle_opt_state(
        topt.init(from_jax_values(_np(jsparse))),
        from_jax_values(_np(jdense_state)), td, tcfg)
    _close_trees(tout, jout, atol=0, exact=True)

    _, axes = jpm.split(jzoo.init_params(jax.random.PRNGKey(0), jd))
    jt, jtc = jup.depth_tile(jpm.wrap(dense_jax, axes), jd, 2)
    tt, ttc = tup.depth_tile(from_jax_values(_np(dense_jax)), td, 2)
    assert ttc.n_layers == jtc.n_layers == 2 * td.n_layers
    _close_trees(tt, jpm.split(jt)[0], atol=0, exact=True)


def test_upcycled_moe_preserves_the_dense_function(cfgs, dense_jax):
    """Paper Fig. 15: with renormalised combine weights and no drops the
    upcycled MoE computes the dense parent's function."""
    _, tcfg, _, td = cfgs
    moe = dataclasses.replace(tcfg.moe, normalize_combine_weights=True,
                              capacity_factor=float(tcfg.moe.num_experts))
    tcfg = tcfg.with_moe(moe)
    dense = from_jax_values(_np(dense_jax))
    sparse = tup.upcycle_params(dense, td, tcfg, 5)
    batch = batch_to(next(make_iterator(tcfg, global_batch=B, seq_len=S)),
                     "cpu")
    ld, _ = zoo.forward_train(dense, batch, td)
    ls, _ = zoo.forward_train(sparse, batch, tcfg)
    torch.testing.assert_close(ls, ld, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# loss, gradients and steps
# ---------------------------------------------------------------------------


def _jax_batch(jcfg, step=0):
    it = jmake_iterator(jcfg, global_batch=B, seq_len=S, host_index=0,
                        host_count=1)
    it.restore({"step": step})
    return next(it)


@pytest.mark.parametrize("which", ["dense", "moe"])
def test_loss_and_grads_match_jax(cfgs, dense_jax, which):
    jcfg, tcfg, jd, td = cfgs
    if which == "dense":
        jc, tc, vals = jd, td, dense_jax
    else:
        jc, tc, vals = jcfg, tcfg, _jax_upcycle(jd, jcfg, dense_jax)
    batch = _jax_batch(jc)
    batch["targets"][0, :5] = -1  # masked targets
    (jl, jm), jg = jax.value_and_grad(jzoo.loss_fn, has_aux=True)(
        vals, jax.tree.map(jnp.asarray, batch), jc, ac=JAC)
    tg, tm = loss_and_grads(from_jax_values(_np(vals)),
                            batch_to(batch, "cpu"), tc, ac=TAC)
    for k in ("loss", "ce", "aux_loss", "z_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-4,
                                   err_msg=k)
    # Gradients: rtol 2e-4 of each leaf's largest entry (f32 summation
    # order through 4 layers; entries near zero are held to the same
    # absolute bound).
    for t, j in zip(jax.tree.leaves(to_jax_values(tg)),
                    jax.tree.leaves(_np(jg))):
        np.testing.assert_allclose(t, j, rtol=2e-4,
                                   atol=2e-4 * np.abs(j).max())


def test_dense_upcycle_moe_steps_match_jax(cfgs):
    """The slice end to end (examples/quickstart.py's path): 2 dense
    Adafactor steps, upcycle with expert_init="copy" (the JAX routers
    handed in), the step counter carried over, 3 MoE steps. Both start
    from the JAX initial state, converted; the port's steps update the
    converted tensors in place. Losses agree at rtol 2e-5 (measured on
    the CPU: at most 1.7e-7 relative over the five steps)."""
    jcfg, tcfg, jd, td = cfgs
    opt_args = dict(peak=0.01, warmup_steps=2)
    jopt = jadafactor(jsched.inverse_sqrt(**opt_args))
    topt = adafactor(schedules.inverse_sqrt(**opt_args))
    js = jtl.init_train_state(jax.random.PRNGKey(0), jd, jopt)
    js["params"] = jax.tree.map(jnp.asarray, _condition(js["params"], jd))
    ts = from_jax_values(_np(js))
    _close_trees(ts, js, atol=0, exact=True)  # the state crosses exactly
    jit = jmake_iterator(jd, global_batch=B, seq_len=S, host_index=0,
                         host_count=1)
    tit = make_iterator(td, global_batch=B, seq_len=S)
    jstep = jax.jit(jtl.make_train_step(jd, jopt, ac=JAC))
    tstep = make_train_step(td, topt, ac=TAC)
    losses = []
    for _ in range(2):
        js, jm = jstep(js, next(jit))
        ts, tm = tstep(ts, next(tit))
        losses.append((float(tm["loss"]), float(jm["loss"])))
    _close_trees(ts["params"], js["params"], atol=1e-5, rtol=1e-4)

    jsparse = _jax_upcycle(jd, jcfg, js["params"])
    tsparse = tup.upcycle_params(ts["params"], td, tcfg,
                                 routers=_routers(jsparse))
    js2 = jtl.init_train_state(jax.random.PRNGKey(0), jcfg, jopt,
                               params=jsparse)
    js2["step"] = js["step"]
    ts2 = init_train_state(0, tcfg, topt, params=tsparse)
    ts2["step"] = ts["step"]
    jstep2 = jax.jit(jtl.make_train_step(jcfg, jopt, ac=JAC))
    tstep2 = make_train_step(tcfg, topt, ac=TAC)
    for _ in range(3):
        js2, jm = jstep2(js2, next(jit))
        ts2, tm = tstep2(ts2, next(tit))
        losses.append((float(tm["loss"]), float(jm["loss"])))
        assert float(tm["skipped"]) == 0.0
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=2e-4)
    t, j = np.array(losses).T
    np.testing.assert_allclose(t, j, rtol=2e-5)
    assert int(ts2["step"]) == int(js2["step"]) == 5
    _close_trees(ts2["params"], js2["params"], atol=1e-4, rtol=1e-3)


def test_non_finite_guard_skips_the_update(cfgs):
    _, _, _, td = cfgs
    opt = adafactor(schedules.constant(0.01))
    state = init_train_state(0, td, opt, device="cpu")
    state["params"]["final_norm"]["scale"][0] = float("nan")
    before = [p.clone() for p in tree_leaves(state["params"])]
    batch = next(make_iterator(td, global_batch=2, seq_len=8))
    state, mets = make_train_step(td, opt)(state, batch)
    assert float(mets["skipped"]) == 1.0
    assert int(state["step"]) == 1 and int(state["opt_state"]["step"]) == 0
    for b, p in zip(before, tree_leaves(state["params"])):
        torch.testing.assert_close(p, b, equal_nan=True, atol=0, rtol=0)


def test_launch_train_runs_on_cpu(capsys, tmp_path):
    from repro_torch.launch import train

    train.main(["--arch", ARCH, "--reduced", "--steps", "2", "--batch", "2",
                "--seq", "16", "--device", "cpu",
                "--ckpt-dir", str(tmp_path / "run")])
    out = capsys.readouterr().out
    assert "[train] kernels: moe=eager attn=eager dispatch=gather" in out
    assert "[train] finished at step 2, loss" in out


def test_profile_step_traces_a_train_step_on_cpu(capsys):
    """``launch/profile_step.py --train`` (the source of PERF.md's train
    step trace): on the CPU it counts the step's host ops and leaves
    every device number null."""
    import json

    from repro_torch.launch import profile_step

    profile_step.main(["--train", "--reduced", "--device", "cpu",
                       "--steps", "1", "--batch", "2", "--seq", "16"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["step"] == "train" and out["wall_ms"] > 0
    assert out["host_ops_per_layer"] > 100
    assert all(out[k] is None for k in ("device_kernels", "device_busy_ms",
                                        "idle_share", "kernels", "top"))
