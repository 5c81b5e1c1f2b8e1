"""Port parity for jamba's mamba layers (``models/ssm.py``) and the
hybrid stack around them, against the JAX package on reduced configs,
on the CPU.

Weights come from the reference (``init_params``/``mamba_init``,
``pm.split``, ``from_jax_values``); every other input is made with
numpy from a seed. The reference runs its XLA path, the port its plain
one. Tolerances: 1e-5 for float32 modules and whole forwards, whose only
difference is summation order; the reference's own 3e-3 where the port
of its prefill/decode test holds a serve step against the training
forward; losses and gradients at rtol 2e-4, as for the other families.
Greedy decoding must be token-identical.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.configs import get_reduced as jax_reduced
from repro.core import upcycle as jup
from repro.models import model_zoo as jzoo
from repro.models import param as jpm
from repro.models import ssm as jssm
from repro.optim import adafactor as jadafactor
from repro.optim import schedules as jsched
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.training import train_loop as jtl
from repro_torch.checkpoint import store
from repro_torch.configs import get_reduced
from repro_torch.core import upcycle as tup
from repro_torch.models import model_zoo as zoo
from repro_torch.models import ssm
from repro_torch.models import stack as stk
from repro_torch.models.convert import from_jax_values, to_jax_values
from repro_torch.optim import adafactor, schedules
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.training import init_train_state, make_train_step
from repro_torch.training.train_loop import loss_and_grads
from torch_threads import one_thread  # noqa: F401 (autouse)

ARCH = "jamba-1.5-large-398b"
ATOL = 1e-5
# Whole-model logits through the serve path: 8 layers whose float32
# recurrences and projections the two packages sum in their own order
# (at 1e-5, 1 logit in 512 of the jamba prefill parts by 1.07e-5).
STACK_ATOL = 5e-5
JAC = jzoo.ApplyCfg(dispatch="gather", moe_impl="xla", attn_impl="xla")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _dropless(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))


@pytest.fixture(scope="module")
def jamba():
    """(jax cfg, torch cfg, JAX values, port values) of reduced jamba,
    dropless (8 layers: mamba but for the attention layer 4, MoE in the
    odd layers)."""
    jcfg, cfg = _dropless(jax_reduced(ARCH)), _dropless(get_reduced(ARCH))
    vals, _ = jpm.split(jzoo.init_params(jax.random.PRNGKey(0), jcfg))
    vals = _np(vals)
    return jcfg, cfg, vals, from_jax_values(vals)


def _mamba_params(cfg, seed=0):
    p = _np(jpm.split(jssm.mamba_init(jax.random.PRNGKey(seed), cfg))[0])
    # A non-zero conv bias, so that its place in the sum is checked.
    p["conv_b"] = np.random.default_rng(seed).normal(
        size=p["conv_b"].shape).astype(np.float32) * 0.1
    return p, from_jax_values(p)


@pytest.mark.parametrize("T", [1, 2, 17])
def test_mamba_apply_matches_the_reference(T):
    """train over T positions; prefill of T positions from an empty
    cache (T = 1 and 2 shorter than the conv window's d_conv - 1 = 3,
    whose left padding the cache keeps) then 3 decode steps rolling the
    window: outputs and both cache leaves at atol 1e-5. A reversed tap
    order would pass a symmetric kernel, not these random ones."""
    cfg = get_reduced(ARCH)
    jp, tp = _mamba_params(cfg)
    rng = np.random.default_rng(T)
    B = 2
    x = rng.normal(size=(B, T + 3, cfg.d_model)).astype(np.float32)
    want, _ = jssm.mamba_apply(jp, jnp.asarray(x[:, :T]), cfg, mode="train")
    got, none = ssm.mamba_apply(tp, _t(x[:, :T]), cfg, mode="train")
    assert none is None and got.shape == (B, T, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)

    jc = jssm.mamba_cache_init(cfg, B)
    tc = ssm.mamba_cache_init(cfg, B)
    assert tc["ssm"].dtype == torch.float32
    steps = [("prefill", slice(0, T))] + [
        ("decode", slice(t, t + 1)) for t in range(T, T + 3)]
    for mode, sl in steps:
        want, jc = jssm.mamba_apply(jp, jnp.asarray(x[:, sl]), cfg,
                                    cache=jc, mode=mode)
        got, tc = ssm.mamba_apply(tp, _t(x[:, sl]), cfg, cache=tc,
                                  mode=mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=ATOL, err_msg=mode)
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       atol=ATOL, rtol=ATOL, err_msg=k)
    # The cached path is the training forward, position by position.
    full, _ = ssm.mamba_apply(tp, _t(x), cfg, mode="train")
    np.testing.assert_allclose(got.numpy(), full[:, -1:].numpy(), atol=ATOL,
                               rtol=ATOL)


def test_mamba_modes_are_checked():
    cfg = get_reduced(ARCH)
    _, tp = _mamba_params(cfg)
    x = torch.zeros(1, 2, cfg.d_model)
    cache = ssm.mamba_cache_init(cfg, 1)
    with pytest.raises(ValueError, match="one position"):
        ssm.mamba_apply(tp, x, cfg, cache=cache, mode="decode")
    with pytest.raises(ValueError, match="needs"):
        ssm.mamba_apply(tp, x, cfg, mode="prefill")
    with pytest.raises(ValueError, match="takes no"):
        ssm.mamba_apply(tp, x, cfg, cache=cache)


def test_mamba_init_matches_the_reference_layout(jamba):
    """Leaf names, shapes and dtypes equal those of the reference's
    init (a mamba layer of the reference's jamba init); the
    deterministic leaves equal its values (``conv_b`` 0 and ``D`` 1
    exactly, ``A_log`` = log 1..N to the ulp of the dtype: the two
    libraries' float32 logs differ by one); ``softplus(dt_b)`` lies in
    [1e-3, 1e-1] and spreads over it; the random leaves have the
    reference's scales (fan-in normal, conv std 0.02) at d_model 256. In
    float32 and bfloat16."""
    _, cfg, vals, _ = jamba
    jp = {k: v[0] for k, v in
          vals["stack"]["segments"][0]["pos0"]["mixer"].items()}
    for dtype in (torch.float32, torch.bfloat16):
        tp = ssm.mamba_init(torch.Generator().manual_seed(1), cfg,
                            dtype=dtype)
        assert sorted(tp) == sorted(jp)
        for k, v in tp.items():
            assert tuple(v.shape) == jp[k].shape and v.dtype == dtype, k
        for k in ("conv_b", "D"):
            np.testing.assert_array_equal(tp[k].float().numpy(),
                                          jp[k].astype(np.float32))
        np.testing.assert_allclose(tp["A_log"].float().numpy(),
                                   jp["A_log"], atol=0,
                                   rtol=torch.finfo(dtype).eps)
    big = dataclasses.replace(cfg, d_model=256)
    tp = ssm.mamba_init(torch.Generator().manual_seed(1), big)
    dt = torch.nn.functional.softplus(tp["dt_b"])
    assert 1e-3 * 0.99 <= float(dt.min()) and float(dt.max()) <= 0.101
    assert float(dt.max()) / float(dt.min()) > 30
    d_in, dt_rank = 2 * 256, 16
    assert tp["x_proj"].shape == (d_in, dt_rank + 2 * big.ssm.d_state)
    for k, std in (("in_proj", 256 ** -0.5), ("conv_w", 0.02),
                   ("out_proj", d_in ** -0.5)):
        assert abs(float(tp[k].std()) / std - 1) < 0.15, k


def _condition(vals, cfg):
    """Attention projections at fan-in d, as ``chip_smoke`` conditions
    every attention stack (ROADMAP.md queue 3)."""
    vals = jax.tree.map(np.array, vals)
    H, Kh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    for seg in vals["stack"]["segments"]:
        for pos in seg.values():
            m = pos["mixer"]
            if "wq" in m:
                m["wq"] *= np.float32((H / d) ** 0.5)
                m["wk"] *= np.float32((Kh / d) ** 0.5)
                m["wv"] *= np.float32((Kh / d) ** 0.5)
    return vals


def _batch(cfg, B=2, S=16, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (B, S + 1))
    return {"tokens": toks[:, :S], "targets": toks[:, 1:]}


def test_jamba_forward_loss_grads_and_step_match_jax(jamba):
    """Reduced jamba (mamba, attention, dense and top-2 MoE layers):
    the descs are the reference's; logits at atol 1e-5; loss and
    metrics at rtol 2e-4 and every gradient at rtol 2e-4 of its leaf's
    largest entry against ``jax.value_and_grad``; one Adafactor step's
    loss and gradient norm at rtol 2e-4."""
    jcfg, cfg, vals, _ = jamba
    descs = stk.layer_descs(cfg)
    assert [(d.mixer, d.ffn) for d in descs] == [
        (d.mixer, d.ffn) for d in jzoo.stk.layer_descs(jcfg)]
    assert [d.mixer for d in descs] == ["mamba"] * 4 + ["attn"] + \
        ["mamba"] * 3
    vals = _condition(vals, jcfg)
    tvals = from_jax_values(vals)
    batch = _batch(cfg)
    jb = jax.tree.map(jnp.asarray, batch)
    tb = {k: _t(v) for k, v in batch.items()}

    def reference(v, b):  # one compile for the loss, grads and logits
        (_, m), g = jax.value_and_grad(functools.partial(
            jzoo.loss_fn, cfg=jcfg, ac=JAC), has_aux=True)(v, b)
        return m, g, jzoo.forward_train(v, b, jcfg, ac=JAC)[0]

    jm, jg, jlogits = jax.jit(reference)(vals, jb)
    tlogits, _ = zoo.forward_train(tvals, tb, cfg)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=ATOL, rtol=ATOL)
    tg, tm = loss_and_grads(tvals, tb, cfg)
    assert float(tm["moe_layer_count"]) == 4.0
    for k in ("loss", "ce", "aux_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-4,
                                   err_msg=k)
    for t, j in zip(jax.tree.leaves(to_jax_values(tg)),
                    jax.tree.leaves(_np(jg))):
        np.testing.assert_allclose(t, j, rtol=2e-4,
                                   atol=2e-4 * np.abs(j).max())

    # The port's train step reports the reference's loss and gradient
    # norm at these params, and moves every leaf.
    topt = adafactor(schedules.constant(0.01))
    ts = init_train_state(0, cfg, topt, params=from_jax_values(vals))
    ts, tm = make_train_step(cfg, topt)(ts, tb)
    jnorm = np.sqrt(sum(float(np.sum(np.square(np.asarray(g, np.float64))))
                        for g in jax.tree.leaves(jg)))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=2e-4)
    np.testing.assert_allclose(float(tm["grad_norm"]), jnorm, rtol=2e-4)
    assert int(ts["step"]) == 1 and float(tm["skipped"]) == 0.0
    moved = [not np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(to_jax_values(ts["params"])), jax.tree.leaves(vals))]
    assert all(moved)


def test_jamba_remat_policies_are_bit_identical(jamba):
    """Under every remat policy the loss and gradients are those of
    ``remat="none"`` bit for bit: the mamba loop runs inside the
    checkpointed body and is recomputed exactly."""
    _, cfg, _, tvals = jamba
    tb = {k: _t(v) for k, v in _batch(cfg, S=12).items()}
    base_g, base_m = loss_and_grads(tvals, tb, cfg)
    for remat in ("full", "dots", "moe"):
        g, m = loss_and_grads(tvals, tb, cfg, ac=zoo.ApplyCfg(remat=remat))
        assert torch.equal(m["loss"], base_m["loss"]), remat
        for a, b in zip(jax.tree.leaves(to_jax_values(g)),
                        jax.tree.leaves(to_jax_values(base_g))):
            np.testing.assert_array_equal(a, b, err_msg=remat)


def test_jamba_bfloat16_compute_matches_jax(jamba):
    """``compute_dtype="bfloat16"``: the mamba layers compute in
    bfloat16 with the SSM state, dt, B and C in float32 (as the
    reference casts); the loss is held against the reference's bf16 loss
    at rtol 2e-3 (two bf16 implementations round their products in
    their own order: ~2^-8 a product, averaged over the tokens) and the
    f32 loss at rtol 2e-2; the gradients reach the float32 masters."""
    jcfg, cfg, vals, tvals = jamba
    batch = _batch(cfg)
    jb = jax.tree.map(jnp.asarray, batch)
    tb = {k: _t(v) for k, v in batch.items()}
    jl, _ = jax.jit(functools.partial(
        jzoo.loss_fn, cfg=jcfg, ac=dataclasses.replace(
            JAC, compute_dtype="bfloat16")))(vals, jb)
    tg, tm = loss_and_grads(tvals, tb, cfg,
                            ac=zoo.ApplyCfg(compute_dtype="bfloat16"))
    f32, _ = zoo.loss_fn(tvals, tb, cfg)
    np.testing.assert_allclose(float(tm["loss"]), float(jl), rtol=2e-3)
    np.testing.assert_allclose(float(tm["loss"]), float(f32), rtol=2e-2)
    leaves = jax.tree.leaves(to_jax_values(tg))
    assert all(g.dtype == np.float32 for g in leaves)
    m = tg["stack"]["segments"][0]["pos0"]["mixer"]
    assert float(m["A_log"].abs().max()) > 0 and \
        float(m["conv_w"].abs().max()) > 0


@pytest.mark.parametrize("arch", [ARCH, "pixtral-12b"])
def test_prefill_decode_matches_train_forward(arch, request):
    """The port of the reference's ``tests/test_serve.py`` consistency
    test for jamba (dropless) and pixtral (patches over the first
    positions): the prefill's last logits and one decode step against
    the training forward at the reference's atol/rtol 3e-3, and the
    prefill logits against the reference's prefill at STACK_ATOL."""
    if arch == ARCH:
        jcfg, cfg, vals, tvals = request.getfixturevalue("jamba")
    else:
        jcfg, cfg = jax_reduced(arch), get_reduced(arch)
        vals = _np(jpm.split(jzoo.init_params(jax.random.PRNGKey(0),
                                              jcfg))[0])
        tvals = from_jax_values(vals)
    B, S = 2, 16
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
    batch = {"tokens": _t(toks), "targets": _t(toks)}
    pe = None
    if cfg.frontend == "patch":
        pe = rng.normal(size=(B, min(cfg.n_frontend_positions, S),
                              cfg.d_model)).astype(np.float32)
        batch["patch_embeds"] = _t(pe)
    full, _ = zoo.forward_train(tvals, batch, cfg)
    cache = zoo.init_serve_cache(cfg, B, S + 8, dtype=torch.float32,
                                 device="cpu")
    pre = {"tokens": _t(toks[:, :S])}
    jpre = {"tokens": jnp.asarray(toks[:, :S])}
    if pe is not None:
        pre["patch_embeds"] = _t(pe)
        jpre["patch_embeds"] = jnp.asarray(pe)
    cache, lg = zoo.prefill(tvals, pre, cache, cfg)
    torch.testing.assert_close(lg[:, 0], full[:, S - 1], atol=3e-3,
                               rtol=3e-3)
    jc = jzoo.init_serve_cache(jcfg, B, S + 8, dtype=jnp.float32)
    _, jl = jzoo.prefill(vals, jpre, jc, jcfg)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=STACK_ATOL,
                               rtol=STACK_ATOL)
    cache, lg = zoo.decode_step(tvals, _t(toks[:, S:]), cache, S, cfg)
    torch.testing.assert_close(lg[:, 0], full[:, S], atol=3e-3, rtol=3e-3)


PROMPTS = [[5, 6, 7, 8, 9], [11, 12], [3] * 9, [200, 1, 17]]


def test_static_engine_greedy_matches_jax_jamba(jamba):
    """``ServeEngine(paged=False).generate`` on reduced jamba (right-
    padded prompts: the pads enter the conv windows and SSM states, as
    in the reference) is token-identical to the reference's engine."""
    jcfg, cfg, vals, tvals = jamba
    sc = dict(max_batch=4, max_len=64)
    want = JServeEngine(vals, jcfg, JServeConfig(**sc)).generate(
        PROMPTS, max_new=6)
    teng = ServeEngine(tvals, cfg, ServeConfig(**sc), device="cpu")
    assert teng.generate(PROMPTS, max_new=6) == want
    assert teng.last_stats["mode"] == "static"


def test_paged_engine_and_cache_refuse_jamba(jamba):
    jcfg, cfg, _, tvals = jamba
    with pytest.raises(ValueError, match="attention-only decoder stack"):
        jzoo.init_paged_serve_cache(jcfg, 4, 16)
    with pytest.raises(ValueError, match=r"attention-only decoder stack "
                       r"\(got \['attn', 'mamba'\]"):
        zoo.init_paged_serve_cache(cfg, 4, 16, device="cpu")
    with pytest.raises(ValueError, match="static engine"):
        ServeEngine(tvals, cfg, ServeConfig(paged=True), device="cpu")
    with pytest.raises(ValueError, match="attention mixers only"):
        stk.stack_paged_cache_init(cfg, stk.layer_descs(cfg), 4, 16,
                                   device="cpu")


def test_jamba_upcycle_matches_the_reference():
    """jamba's dense parent (mamba leaves and all) upcycles to the
    target's layer pattern: the mamba and attention mixers and the
    dense layers' MLPs copied verbatim, the odd layers' MLP copied
    into each expert; with the reference's routers handed in the tree
    equals the reference's exactly."""
    jcfg, cfg = jax_reduced(ARCH), get_reduced(ARCH)
    jd, td = jcfg.dense_parent(), cfg.dense_parent()
    dense_w = jzoo.init_params(jax.random.PRNGKey(0), jd)
    dense = _np(jpm.split(dense_w)[0])
    jsparse = _np(jpm.split(jup.upcycle_params(
        jpm.wrap(dense, jpm.split(dense_w)[1]), jd, jcfg,
        jax.random.PRNGKey(7)))[0])
    seg = jsparse["stack"]["segments"][0]
    routers = [np.asarray(seg[f"pos{i}"]["ffn"]["router"]["w"][0])
               if "router" in seg[f"pos{i}"]["ffn"] else None
               for i in range(cfg.n_layers)]
    assert [r is not None for r in routers] == [i % 2 == 1 for i in
                                                range(8)]
    tsparse = tup.upcycle_params(from_jax_values(dense), td, cfg,
                                 routers=routers)
    ft, tt = jax.tree.flatten(to_jax_values(tsparse))
    fj, tj = jax.tree.flatten(jsparse)
    assert tt == tj
    for a, b in zip(ft, fj):
        np.testing.assert_array_equal(a, b)
    dseg = dense["stack"]["segments"][0]
    for i in (0, 1, 3):
        for k, v in dseg[f"pos{i}"]["mixer"].items():
            np.testing.assert_array_equal(
                tsparse["stack"]["segments"][0][f"pos{i}"]["mixer"][k]
                .numpy(), v)
    ex = tsparse["stack"]["segments"][0]["pos1"]["ffn"]["experts"]["wi"]
    assert ex.shape[1] == cfg.moe.num_experts
    for e in range(cfg.moe.num_experts):
        np.testing.assert_array_equal(ex[0, e].numpy(),
                                      dseg["pos1"]["ffn"]["wi"][0])


def test_jamba_checkpoint_crosses_both_ways(jamba, tmp_path):
    """A reduced jamba train state (mamba, attention and MoE leaves,
    Adafactor slots, step) saved by the port restores in the reference
    bit for bit, and the other way."""
    jcfg, cfg, vals, _ = jamba
    jopt = jadafactor(jsched.constant(0.01))
    topt = adafactor(schedules.constant(0.01))
    js = _np(jtl.init_train_state(jax.random.PRNGKey(0), jcfg, jopt,
                                  params=vals))
    ts = init_train_state(3, cfg, topt, device="cpu")
    p = str(tmp_path / "port")
    store.save_tree(p, ts, metadata={"step": 3})
    back = jstore.load_tree(p, js)
    ft, tt = jax.tree.flatten(to_jax_values(ts))
    fj, tj = jax.tree.flatten(_np(back))
    assert tt == tj
    for a, b in zip(ft, fj):
        np.testing.assert_array_equal(a, b)
    p = str(tmp_path / "ref")
    jstore.save_tree(p, js, metadata={"step": 3})
    out = store.load_tree(p, ts)
    for a, b in zip(jax.tree.leaves(to_jax_values(out)),
                    jax.tree.leaves(js)):
        np.testing.assert_array_equal(a, b)
