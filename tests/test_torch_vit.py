"""Port parity for the vision slice: vit-b16-upcycled (the paper's
"Vision B/16 Sparse 978M") at the reduced config — the patch data, the
encoder-only ``forward_train``/``loss_fn`` with Expert Choice MoE layers
in the last half of the stack and the gather dispatch, the
``last_half`` upcycling of parameters and optimizer state, the
dense -> upcycle -> MoE steps, the full config's parameter count and the
launcher. Inputs are made with numpy from a seed and go through both
packages; each comparison states its tolerance."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.core import upcycle as jup
from repro.data import make_iterator as jmake_iterator
from repro.models import model_zoo as jzoo
from repro.models import param as jpm
from repro.models import stack as jstk
from repro.optim import adafactor as jadafactor
from repro.optim import schedules as jsched
from repro.training import train_loop as jtl
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import upcycle as tup
from repro_torch.data import make_iterator
from repro_torch.models import model_zoo as zoo
from repro_torch.models.convert import from_jax_values, to_jax_values
from repro_torch.models.param import count_params
from repro_torch.optim import adafactor, schedules
from repro_torch.training import init_train_state, make_train_step
from repro_torch.training.train_loop import batch_to, loss_and_grads

ARCH = "vit-b16-upcycled"
# The reference's default dispatch on its CPU ("xla") paths; the port
# runs its plain versions on the CPU.
JAC = jzoo.ApplyCfg(dispatch="gather", moe_impl="xla", attn_impl="xla")
# 4 images x 16 patches: one routing group of the reduced config's 64.
B = 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _condition(params, cfg):
    """The JAX init's attention projections rescaled to fan-in d (its
    fan-in rule takes the head count, which makes random models chaotic:
    ROADMAP.md queue 3), as ``chip_smoke.condition_attention`` does."""
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


def _routers(sparse, cfg):
    """Per-layer router weights of a sparse values tree (None for dense
    layers), walking the stack's segments in layer order."""
    out = []
    for si, (reps, pdescs) in enumerate(
            jstk.find_segments(jstk.layer_descs(cfg))):
        seg = sparse["stack"]["segments"][si]
        for r in range(reps):
            for i in range(len(pdescs)):
                ffn = seg[f"pos{i}"]["ffn"]
                out.append(np.asarray(ffn["router"]["w"])[r]
                           if "router" in ffn else None)
    return out


def _perturb_experts(vals, seed):
    """Freshly upcycled experts are copies of one MLP, so the router's
    gradient is rounding noise (with normalised combine weights, equal
    expert outputs make each token's output independent of its
    weights), and Adafactor's scale-free update turns that noise into a
    framework-dependent step. The same small numpy noise on every
    expert, in the one tree both frameworks start from, gives the router
    a real gradient to hold."""
    vals = jax.tree.map(np.array, vals)
    rng = np.random.default_rng(seed)
    for seg in vals["stack"]["segments"]:
        for pos in seg.values():
            ex = pos["ffn"].get("experts")
            for k in ex or ():
                ex[k] = (ex[k] + 0.05 * ex[k].std()
                         * rng.normal(size=ex[k].shape)).astype(np.float32)
    return vals


def _jax_batch(jcfg, step=0, batch=B):
    it = jmake_iterator(jcfg, global_batch=batch, seq_len=0, host_index=0,
                        host_count=1)
    it.restore({"step": step})
    return next(it)


def test_config_and_segments_match_the_reference(cfgs):
    """The config is the reference's, field by field; MoE sits in the
    last half of the layers (one segment of n positions, as the
    reference's smallest-period split finds it)."""
    from repro_torch.models import stack as tstk

    for name in ("full", "reduced"):
        j = jax_config(ARCH) if name == "full" else cfgs[0]
        t = get_config(ARCH) if name == "full" else cfgs[1]
        for f in dataclasses.fields(t):
            want = getattr(j, f.name)
            got = getattr(t, f.name)
            if f.name == "moe":
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
            elif f.name != "sharding_overrides":
                assert got == want, f.name
        tdescs, jdescs = tstk.layer_descs(t), jstk.layer_descs(j)
        assert [d.ffn for d in tdescs] == [d.ffn for d in jdescs]
        n = t.n_layers
        assert [d.ffn for d in tdescs] == ["dense"] * (n // 2) + ["moe"] * (
            n // 2)
        assert [(r, len(p)) for r, p in tstk.find_segments(tdescs)] == [
            (r, len(p)) for r, p in jstk.find_segments(jdescs)]


def test_patch_batches_identical(cfgs):
    jcfg, tcfg, _, _ = cfgs
    jit = jmake_iterator(jcfg, global_batch=3, seq_len=0, host_index=0,
                         host_count=1)
    tit = make_iterator(tcfg, global_batch=3, seq_len=0)
    for _ in range(3):
        jb, tb = next(jit), next(tit)
        assert sorted(jb) == sorted(tb) == ["labels", "patch_embeds"]
        for k in jb:
            assert tb[k].dtype == jb[k].dtype
            np.testing.assert_array_equal(tb[k], jb[k])
    # The full width's batch: 104 images of 196 patches, as chip_smoke
    # trains it, bit for bit.
    full = get_config(ARCH)
    tb = next(make_iterator(full, global_batch=104, seq_len=0))
    assert tb["patch_embeds"].shape == (104, 196, 768)
    jb = _jax_batch(jax_config(ARCH), batch=104)
    np.testing.assert_array_equal(tb["labels"], jb["labels"])
    np.testing.assert_array_equal(tb["patch_embeds"], jb["patch_embeds"])


def test_count_params_of_full_matches_the_reference():
    """~0.96 B parameters, counted without allocating them: the port's
    init on the meta device, the reference's under ``jax.eval_shape``."""
    jcfg, tcfg = jax_config(ARCH), get_config(ARCH)
    for jc, tc in ((jcfg, tcfg), (jcfg.dense_parent(), tcfg.dense_parent())):
        shapes = jax.eval_shape(
            lambda k, jc=jc: jpm.split(jzoo.init_params(k, jc))[0],
            jax.random.PRNGKey(0))
        want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
        got = count_params(zoo.init_params(None, tc, device="meta"))
        assert got == want
    assert 0.9e9 < got < 1.0e9 or 80e6 < got < 90e6


@pytest.mark.parametrize("which", ["dense", "moe"])
def test_forward_and_loss_and_grads_match_jax(cfgs, dense_jax, which):
    """Encoder-only forward (bidirectional attention, learned positions,
    average pooling, Expert Choice MoE through the gather dispatch):
    logits at atol 1e-5; loss and metrics at rtol 2e-4; gradients
    against ``jax.value_and_grad`` at rtol 2e-4 of each leaf's largest
    entry, on attention-conditioned weights."""
    jcfg, tcfg, jd, td = cfgs
    if which == "dense":
        jc, tc, vals = jd, td, dense_jax
    else:
        jc, tc = jcfg, tcfg
        vals = _perturb_experts(_jax_upcycle(jd, jcfg, dense_jax), 4)
    batch = _jax_batch(jc)
    jb = jax.tree.map(jnp.asarray, batch)
    jlogits, _ = jzoo.forward_train(vals, jb, jc, ac=JAC)
    tvals = from_jax_values(_np(vals))
    tb = batch_to(batch, "cpu")
    tlogits, tmets = zoo.forward_train(tvals, tb, tc)
    assert tlogits.shape == (B, tc.vocab_size)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=1e-5)
    if which == "moe":
        assert float(tmets["moe_layer_count"]) == tc.n_layers // 2
    (jl, jm), jg = jax.value_and_grad(jzoo.loss_fn, has_aux=True)(
        vals, jb, jc, ac=JAC)
    tg, tm = loss_and_grads(tvals, tb, tc)
    for k in ("loss", "ce", "aux_loss", "z_loss", "dropped_frac_sum"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-4,
                                   atol=1e-7, err_msg=k)
    for t, j in zip(jax.tree.leaves(to_jax_values(tg)),
                    jax.tree.leaves(_np(jg))):
        np.testing.assert_allclose(t, j, rtol=2e-4,
                                   atol=2e-4 * np.abs(j).max())


@pytest.mark.parametrize("dispatch", ["einsum", "sorted"])
def test_the_three_dispatches_train_alike(cfgs, dense_jax, dispatch):
    """Expert Choice decides the same slots for every dispatch, so the
    einsum and sorted dispatches give the gather dispatch's loss and
    gradients (f32 reassociation only: rtol 1e-5 of each leaf's largest
    entry)."""
    jcfg, tcfg, jd, _ = cfgs
    tvals = from_jax_values(
        _perturb_experts(_jax_upcycle(jd, jcfg, dense_jax), 5))
    tb = batch_to(_jax_batch(jcfg), "cpu")
    g0, m0 = loss_and_grads(tvals, tb, tcfg)
    g1, m1 = loss_and_grads(tvals, tb, tcfg,
                            ac=zoo.ApplyCfg(dispatch=dispatch))
    np.testing.assert_allclose(float(m1["loss"]), float(m0["loss"]),
                               rtol=1e-6)
    for a, b in zip(jax.tree.leaves(to_jax_values(g1)),
                    jax.tree.leaves(to_jax_values(g0))):
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())


def test_upcycle_last_half_exact_with_jax_routers(cfgs, dense_jax):
    """``upcycle_params`` (experts copied into the last half's layers,
    the JAX routers handed in) and ``upcycle_opt_state`` (Adafactor
    slots broadcast over the experts, routers' slots fresh, the step
    kept) equal the reference's exactly."""
    jcfg, tcfg, jd, td = cfgs
    jsparse = _jax_upcycle(jd, jcfg, dense_jax)
    routers = _routers(jsparse, jcfg)
    assert [r is None for r in routers] == [True, True, False, False]
    tsparse = tup.upcycle_params(from_jax_values(_np(dense_jax)), td, tcfg,
                                 routers=routers)
    _close_trees(tsparse, jsparse, atol=0, exact=True)
    # Drawn routers: normal, std 0.02, from the params' device (the tree
    # has no "embed" to read it from).
    drawn = tup.upcycle_params(from_jax_values(_np(dense_jax)), td, tcfg, 3)
    w = drawn["stack"]["segments"][0]["pos2"]["ffn"]["router"]["w"]
    assert w.shape == (1, td.d_model, tcfg.moe.num_experts)
    assert abs(float(w.std()) - 0.02) < 0.006

    jopt = jadafactor(jsched.constant(0.01))
    topt = adafactor(schedules.constant(0.01))
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


def test_dense_upcycle_moe_steps_match_jax(cfgs):
    """The vision recipe end to end at the reduced width: 2 dense
    Adafactor steps, upcycle (JAX routers handed in) with the optimizer
    state carried over (§B.6) and the step counter kept, 3 MoE steps
    through Expert Choice and the gather dispatch. Both start from the
    JAX initial state, converted; the MoE steps start from one sparse
    tree whose experts carry the same small noise (_perturb_experts).
    Losses agree at rtol 2e-5 and gradient norms at rtol 2e-4, as on the
    granite path; parameters at atol 1e-4, rtol 1e-3."""
    jcfg, tcfg, jd, td = cfgs
    opt_args = dict(peak=0.01, warmup_steps=2)
    jopt = jadafactor(jsched.inverse_sqrt(**opt_args))
    topt = adafactor(schedules.inverse_sqrt(**opt_args))
    js = jtl.init_train_state(jax.random.PRNGKey(0), jd, jopt)
    js["params"] = jax.tree.map(jnp.asarray, _condition(js["params"], jd))
    ts = from_jax_values(_np(js))
    jit = jmake_iterator(jd, global_batch=B, seq_len=0, host_index=0,
                         host_count=1)
    tit = make_iterator(td, global_batch=B, seq_len=0)
    jstep = jax.jit(jtl.make_train_step(jd, jopt, ac=JAC))
    tstep = make_train_step(td, topt)
    losses = []
    for _ in range(2):
        js, jm = jstep(js, next(jit))
        ts, tm = tstep(ts, next(tit))
        losses.append((float(tm["loss"]), float(jm["loss"])))
    _close_trees(ts["params"], js["params"], atol=1e-5, rtol=1e-4)

    jsparse = _jax_upcycle(jd, jcfg, js["params"])
    tsparse = tup.upcycle_params(ts["params"], td, tcfg,
                                 routers=_routers(jsparse, jcfg))
    _close_trees(tsparse, jsparse, atol=1e-5, rtol=1e-4)
    # One sparse tree for both, its experts perturbed (_perturb_experts).
    jsparse = _perturb_experts(jsparse, 6)
    tsparse = from_jax_values(jsparse)
    jsparse = jax.tree.map(jnp.asarray, jsparse)
    js2 = jtl.init_train_state(jax.random.PRNGKey(0), jcfg, jopt,
                               params=jsparse)
    js2["opt_state"] = jup.upcycle_opt_state(js2["opt_state"],
                                             js["opt_state"], jd, jcfg)
    js2["step"] = js["step"]
    ts2 = init_train_state(0, tcfg, topt, params=tsparse)
    ts2["opt_state"] = tup.upcycle_opt_state(ts2["opt_state"],
                                             ts["opt_state"], td, tcfg)
    ts2["step"] = ts["step"]
    jstep2 = jax.jit(jtl.make_train_step(jcfg, jopt, ac=JAC))
    tstep2 = make_train_step(tcfg, topt)
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


def test_launch_train_vit_runs_on_cpu(capsys, tmp_path):
    from repro_torch.launch import train

    train.main(["--arch", ARCH, "--reduced", "--steps", "3", "--batch", "4",
                "--device", "cpu", "--ckpt-dir", str(tmp_path / "run")])
    out = capsys.readouterr().out
    assert "[train] kernels: moe=eager attn=eager dispatch=gather" in out
    last = out.strip().splitlines()[-1]
    assert last.startswith("[train] finished at step 3, loss")
    assert np.isfinite(float(last.rsplit(" ", 1)[1]))


def test_profile_step_traces_a_vit_train_step_on_cpu(capsys):
    """``launch/profile_step.py --train --arch vit-b16-upcycled`` (the
    source of PERF.md's ViT step trace): on the CPU it counts the step's
    host ops and leaves every device number null."""
    import json

    from repro_torch.launch import profile_step

    profile_step.main(["--train", "--arch", ARCH, "--reduced", "--device",
                       "cpu", "--steps", "1", "--batch", "4"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["step"] == "train" and out["arch"] == ARCH
    assert out["dispatch"] == "gather" and out["batch"] == 4
    assert out["wall_ms"] > 0 and out["host_ops_per_layer"] > 20
    assert all(out[k] is None for k in ("device_kernels", "device_busy_ms",
                                        "idle_share", "kernels", "top"))
