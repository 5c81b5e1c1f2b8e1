"""Port parity for the rwkv slice: the WKV-6 plain versions, the RWKV-6
time-mix and channel-mix, the static engine's ``prefill`` and
``decode_step``, and ``ServeEngine(paged=False).generate`` against the
JAX package, on reduced configs, on the CPU.

Weights come from the reference (``zoo.init_params``, ``pm.split``,
``from_jax_values``); every other input is made with numpy from a seed.
Tolerances: the reference's own for the WKV kernels (2e-4 in float32,
3e-2 with bfloat16 inputs); 1e-5 for f32 modules and whole steps, whose
only difference is summation order, except whole steps through the
chunked WKV (``CHUNKED_ATOL``, reason there). Greedy decoding must be
token-identical.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import MoECfg as JMoECfg
from repro.configs import get_reduced as jax_reduced
from repro.core import upcycle as jup
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.rwkv6_kernel import rwkv6_pallas
from repro.models import model_zoo as jzoo
from repro.models import param as jpm
from repro.models import rwkv as jrwkv
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import MoECfg, get_config, get_reduced
from repro_torch.core import upcycle as tup
from repro_torch.kernels import ops, ref
from repro_torch.models import model_zoo as zoo
from repro_torch.models import rwkv
from repro_torch.models.convert import from_jax_values, to_jax_values
from repro_torch.serve import ServeConfig, ServeEngine
from torch_threads import one_thread  # noqa: F401 (autouse)

ATOL = 1e-5
ARCH = "rwkv6-7b"

# B, T, H, K, V, chunk, with_state, dtype: the reference's own cases
# (tests/test_kernels.py): T not a multiple of the chunk, a carried
# state, V != K, bfloat16 inputs.
RWKV_CASES = [
    (2, 32, 2, 8, 8, 8, False, "float32"),
    (1, 37, 4, 16, 16, 16, True, "float32"),
    (2, 64, 2, 8, 12, 32, False, "float32"),
    (1, 16, 2, 8, 8, 4, True, "bfloat16"),
]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _wkv_inputs(case, seed=0):
    B, T, H, K, V, _, with_state, _ = case
    rng = np.random.default_rng(seed)
    f32 = np.float32
    r, k = (0.5 * rng.normal(size=(B, T, H, K))).astype(f32), \
        (0.5 * rng.normal(size=(B, T, H, K))).astype(f32)
    v = (0.5 * rng.normal(size=(B, T, H, V))).astype(f32)
    w = (0.6 / (1 + np.exp(-rng.normal(size=(B, T, H, K)))) + 0.3).astype(f32)
    u = (0.3 * rng.normal(size=(H, K))).astype(f32)
    s0 = (0.2 * rng.normal(size=(B, H, K, V))).astype(f32) \
        if with_state else None
    return r, k, v, w, u, s0


@pytest.mark.parametrize("ref_impl", ["pallas", "xla", "ref"])
@pytest.mark.parametrize("case", RWKV_CASES)
def test_wkv_plain_versions_match_the_reference(case, ref_impl):
    """The port's chunked version (``ops.rwkv6`` "eager") and its
    sequential oracle against the reference's Pallas kernel (interpret
    mode), its chunked XLA path and its sequential oracle."""
    chunk, dtype = case[5], case[7]
    r, k, v, w, u, s0 = _wkv_inputs(case)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jin = [jnp.asarray(x).astype(jdt) for x in (r, k, v)] + \
        [jnp.asarray(w), jnp.asarray(u)]
    js0 = None if s0 is None else jnp.asarray(s0)
    if ref_impl == "pallas":
        want = rwkv6_pallas(*jin, initial_state=js0, chunk=chunk,
                            interpret=True)
    elif ref_impl == "xla":
        want = jops.rwkv6(*jin, initial_state=js0, chunk=chunk,
                          implementation="xla")
    else:
        want = jref.rwkv6_ref(*jin, initial_state=js0)
    tin = [_t(x).to(tdt) for x in (r, k, v)] + [_t(w), _t(u)]
    ts0 = None if s0 is None else _t(s0)
    tol = 3e-2 if dtype == "bfloat16" else 2e-4
    for got in (ops.rwkv6(*tin, initial_state=ts0, chunk=chunk,
                          implementation="eager"),
                ref.rwkv6_ref(*tin, initial_state=ts0)):
        assert got[0].dtype == tdt and got[1].dtype == torch.float32
        np.testing.assert_allclose(got[0].float().numpy(),
                                   np.asarray(want[0], np.float32),
                                   atol=tol, rtol=tol)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   atol=tol, rtol=tol)


def test_wkv_state_chaining():
    """[first half; second half from the carried state] == the whole
    sequence, on the chunked version (the decode loop's contract)."""
    case = (1, 32, 2, 8, 8, 8, False, "float32")
    r, k, v, w, u, _ = (None if x is None else _t(x)
                        for x in _wkv_inputs(case, seed=3))
    o_full, s_full = ref.rwkv6_ref(r, k, v, w, u)
    h = 16
    o1, s1 = ops.rwkv6(r[:, :h], k[:, :h], v[:, :h], w[:, :h], u, chunk=8)
    o2, s2 = ops.rwkv6(r[:, h:], k[:, h:], v[:, h:], w[:, h:], u,
                       initial_state=s1, chunk=8)
    torch.testing.assert_close(torch.cat([o1, o2], 1), o_full, atol=2e-4,
                               rtol=2e-4)
    torch.testing.assert_close(s2, s_full, atol=2e-4, rtol=2e-4)
    # Step by step, as decode runs it (T = 1, chunk 1).
    s = None
    for t in range(32):
        o, s = ops.rwkv6(r[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1],
                         w[:, t:t + 1], u, initial_state=s)
        torch.testing.assert_close(o[:, 0], o_full[:, t], atol=2e-4,
                                   rtol=2e-4)


def test_wkv_cuda_path_launches_or_raises(monkeypatch):
    """A CUDA-resolved call never falls back to the plain version: under
    autograd it refuses (the kernel is forward-only), and otherwise it
    goes to the kernel wrapper, which refuses CPU tensors."""
    case = (1, 8, 2, 8, 8, 8, False, "float32")
    r, k, v, w, u, _ = (None if x is None else _t(x)
                        for x in _wkv_inputs(case))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.rwkv6(r, k, v, w, u, implementation="cuda")
    monkeypatch.setattr(ops, "resolve", lambda impl, x: "cuda")
    rg = r.clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="mixer_impl='eager'"):
        ops.rwkv6(rg, k, v, w, u)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.rwkv6(r, k, v, w, u)
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA tensor"):
            ops.rwkv6(rg, k, v, w, u)
    # The eager version is differentiable by autograd.
    monkeypatch.undo()
    o, _ = ops.rwkv6(rg, k, v, w, u, implementation="eager")
    o.sum().backward()
    assert rg.grad is not None and bool(torch.isfinite(rg.grad).all())


def _fma(a, b, c):
    """float32 fma(a, b, c): the product exact in float64, one rounding
    to float32 (a second rounding of the float64 sum aside)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _wkv_lane_split(r, k, v, w, u, s0, P):
    """A float32 mirror of the WKV kernel's order (csrc/rwkv6.cu), numpy
    arrays in and out: each step's bonus scalar beta = sum_i r_i u_i k_i
    as 32 lane sums (lane l over i = l, l + 32, ...) and a shuffle tree;
    state column j's rows split over P lanes, lane p holding the 4-row
    chunks p, p + P, ..., its running sum acc = fma(r, S, acc) over its
    rows in order and S = fma(w, S, k v), the lanes' shuffle tree, then
    o = fma(v, beta, sum)."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    f32 = np.float32
    S = (np.zeros((B, H, K, V), f32) if s0 is None else s0.astype(f32))
    NC = K // (4 * P)
    # rows[p, cc, q]: lane p's row q of its chunk cc.
    rows = 4 * (np.arange(NC)[None, :, None] * P
                + np.arange(P)[:, None, None]) + np.arange(4)
    lane = np.arange(32)
    o = np.empty((B, T, H, V), f32)
    for t in range(T):
        rt, kt, wt, vt = r[:, t], k[:, t], w[:, t], v[:, t]
        part = np.zeros((B, H, 32), f32)
        for i0 in range(0, K, 32):
            n = min(32, K - i0)
            i = slice(i0, i0 + n)
            part[..., :n] = _fma(rt[..., i] * u[None, :, i], kt[..., i],
                                 part[..., :n])
        for m in (16, 8, 4, 2, 1):
            part = part + part[..., lane ^ m]
        beta = part[..., 0]
        tot = np.zeros((B, H, P, V), f32)
        Sl = S[:, :, rows]  # (B, H, P, NC, 4, V)
        for cc in range(NC):
            for q in range(4):
                i = rows[:, cc, q]
                ri, ki, wi = (x[:, :, i][..., None] for x in (rt, kt, wt))
                tot = _fma(ri, Sl[:, :, :, cc, q], tot)
                Sl[:, :, :, cc, q] = _fma(wi, Sl[:, :, :, cc, q],
                                          ki * vt[:, :, None, :])
        S[:, :, rows] = Sl
        m = 1
        while m < P:
            tot = tot + tot[:, :, np.arange(P) ^ m]
            m <<= 1
        o[:, t] = _fma(vt, beta[..., None], tot[:, :, 0])
    return o, S


def _wkv_config_inputs(B, T, H, K, seed):
    """WKV inputs as chip_smoke.wkv_case makes them: r, k, v standard
    normal, u ~ 0.3 N(0, 1), s0 standard normal, and the config's decays
    w = exp(-exp(w0 + 0.5 N(0, 1))) over time_mix_init's w0 spread (-5
    at the first channel to 3 at the last), some w near 1, some below
    1e-9."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    d = H * K
    w0 = -5.0 + 8.0 * (np.arange(d) / (d - 1)) ** 0.7
    w = np.exp(-np.exp(w0 + 0.5 * rng.normal(size=(B, T, d))))
    r, k, v = (rng.normal(size=(B, T, H, K)).astype(f32) for _ in range(3))
    return (r, k, v, w.reshape(B, T, H, K).astype(f32),
            (0.3 * rng.normal(size=(H, K))).astype(f32),
            rng.normal(size=(B, H, K, K)).astype(f32))


@pytest.mark.parametrize("inputs", ["card test", "config decays"])
def test_wkv_kernel_order_matches_the_oracles(inputs):
    """The WKV kernel's summation order, mirrored in float32 (bonus
    factored out, 8 lanes a column, their shuffle tree), against the
    port's sequential oracle and the reference's, at T 512 and K = V =
    64: element by element within the card test's float32 tolerance
    (1e-5) on its inputs, and within chip_smoke's (WKV_RTOL["oracle"]:
    1e-5 of the largest |o| and, apart, of the largest |S|) at the
    config's decays, whose state grows over ~150 steps."""
    B, T, H, K = 1, 512, 2, 64
    if inputs == "card test":
        r, k, v, w, u, s0 = _wkv_inputs((B, T, H, K, K, 0, True, ""),
                                        seed=5)
    else:
        r, k, v, w, u, s0 = _wkv_config_inputs(B, T, H, K, seed=5)
    got = _wkv_lane_split(r, k, v, w, u, s0, P=8)
    ts = [_t(x) for x in (r, k, v, w, u, s0)]
    tref = ref.rwkv6_ref(*ts[:5], initial_state=ts[5])
    jw = jref.rwkv6_ref(*(jnp.asarray(x) for x in (r, k, v, w, u)),
                        initial_state=jnp.asarray(s0))
    for want in ((tref[0].numpy(), tref[1].numpy()),
                 (np.asarray(jw[0]), np.asarray(jw[1]))):
        for a, b in zip(got, want):
            assert np.isfinite(a).all()
            if inputs == "card test":
                np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
            else:
                assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


def test_wkv_kernel_order_with_two_lanes():
    """K = 8 runs 2 lanes a column: the mirror with P = 2 against the
    sequential oracle, as above."""
    r, k, v, w, u, s0 = _wkv_inputs((2, 40, 2, 8, 12, 0, True, ""), seed=6)
    got = _wkv_lane_split(r, k, v, w, u, s0, P=2)
    ts = [_t(x) for x in (r, k, v, w, u, s0)]
    want = ref.rwkv6_ref(*ts[:5], initial_state=ts[5])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b.numpy(), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# time-mix and channel-mix
# ---------------------------------------------------------------------------


def _condition_mixer(mixer, cfg):
    """``wr/wk/wv/wg (d, H, K)`` rescaled to fan-in d.

    The reference's init takes ``fan_in = shape[-2]``, the head count,
    for these projections (as for attention's ``wq``; ROADMAP queue 3):
    r, k and v come out with std ~sqrt(d/H) and the WKV outputs span
    several orders of magnitude within one call, so the two packages'
    f32 WKV sums, taken in other orders, part by more than ATOL in the
    largest outputs and the per-head group norm carries that into the
    rows of small |o|. At fan-in d the same module comparisons hold to
    ATOL. Both packages get the same rescaled values."""
    scale = (cfg.n_heads / cfg.d_model) ** 0.5
    return dict(mixer, **{n: mixer[n] * scale
                          for n in ("wr", "wk", "wv", "wg")})


def _condition(vals, cfg):
    segs = [{pos: dict(lp, mixer=_condition_mixer(lp["mixer"], cfg))
             for pos, lp in seg.items()}
            for seg in vals["stack"]["segments"]]
    return dict(vals, stack={"segments": segs})


@pytest.fixture(scope="module")
def mix_params():
    """Reference time-mix and channel-mix params of the reduced config,
    conditioned (:func:`_condition`), with a nonzero decay LoRA B (zeros
    at init) so the data-dependent decay is exercised."""
    cfg = jax_reduced(ARCH)
    tm, _ = jpm.split(jrwkv.time_mix_init(jax.random.PRNGKey(1), cfg))
    tm = _condition_mixer(tm, cfg)
    rng = np.random.default_rng(4)
    tm["w_lora_b"] = jnp.asarray(
        0.1 * rng.normal(size=tm["w_lora_b"].shape), jnp.float32)
    tm["u"] = jnp.asarray(0.3 * rng.normal(size=tm["u"].shape), jnp.float32)
    cm, _ = jpm.split(jrwkv.channel_mix_init(jax.random.PRNGKey(2), cfg))
    return cfg, get_reduced(ARCH), _np(tm), _np(cm)


def _mix_cache(cfg, B, seed):
    rng = np.random.default_rng(seed)
    H, K = cfg.d_model // cfg.ssm.head_size, cfg.ssm.head_size
    return {"x_prev": rng.normal(size=(B, cfg.d_model)).astype(np.float32),
            "wkv": rng.normal(size=(B, H, K, K)).astype(np.float32)}


@pytest.mark.parametrize("mode,T", [("train", 13), ("prefill", 13),
                                    ("decode", 1)])
def test_time_mix_matches_jax(mix_params, mode, T):
    jcfg, cfg, tm, _ = mix_params
    B = 2
    x = np.random.default_rng(5).normal(size=(B, T, cfg.d_model)).astype(
        np.float32)
    cache = None if mode == "train" else _mix_cache(cfg, B, 6)
    jy, jc = jrwkv.time_mix_apply(
        jax.tree.map(jnp.asarray, tm), jnp.asarray(x), jcfg,
        cache=None if cache is None else jax.tree.map(jnp.asarray, cache),
        mode=mode)
    tc = None if cache is None else from_jax_values(cache)
    ty, tc = rwkv.time_mix_apply(from_jax_values(tm), _t(x), cfg, cache=tc)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL,
                               rtol=ATOL)
    if mode == "train":
        assert tc is None and jc is None
        return
    for key in ("x_prev", "wkv"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("with_cache", [False, True])
def test_channel_mix_pre_matches_jax(mix_params, with_cache):
    _, cfg, _, cm = mix_params
    B, T = 2, 7
    x = np.random.default_rng(8).normal(size=(B, T, cfg.d_model)).astype(
        np.float32)
    cache = ({"x_prev": _mix_cache(cfg, B, 9)["x_prev"]} if with_cache
             else None)
    jxk, jr, jc = jrwkv.channel_mix_pre(
        jax.tree.map(jnp.asarray, cm), jnp.asarray(x),
        cache=None if cache is None else jax.tree.map(jnp.asarray, cache))
    txk, tr, tc = rwkv.channel_mix_pre(
        from_jax_values(cm), _t(x),
        cache=None if cache is None else from_jax_values(cache))
    np.testing.assert_allclose(txk.numpy(), np.asarray(jxk), atol=ATOL)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=ATOL)
    if with_cache:
        np.testing.assert_allclose(tc["x_prev"].numpy(),
                                   np.asarray(jc["x_prev"]), atol=0)


# ---------------------------------------------------------------------------
# the static serve path
# ---------------------------------------------------------------------------


def _dropless(cfg):
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))


@pytest.fixture(scope="module")
def rwkv_model():
    jcfg = jax_reduced(ARCH)
    vals, _ = jpm.split(jzoo.init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, get_reduced(ARCH), vals, from_jax_values(_np(vals))


def test_rwkv_tree_round_trips(rwkv_model):
    _, cfg, vals, tvals = rwkv_model
    flat_j, tree_j = jax.tree.flatten(_np(vals))
    flat_b, tree_b = jax.tree.flatten(to_jax_values(tvals))
    assert tree_j == tree_b
    for a, b in zip(flat_j, flat_b):
        assert a.shape == b.shape and np.array_equal(a, b)
    # The port's own init builds the same tree (key paths and shapes).
    own = to_jax_values(zoo.init_params(0, cfg, device="cpu"))
    flat_o, tree_o = jax.tree.flatten(own)
    assert tree_o == tree_j
    assert [a.shape for a in flat_o] == [a.shape for a in flat_j]


# Whole prefill/decode steps through the chunked WKV (both packages'
# default path): its log-space cumulative decay loses 2^-24 * sum |log w|
# relative per decay factor (|log w| reaches e^3 a step at w0 = 3), in
# each package in other roundings, and the per-head group norm scales
# that up in rows of small variance: more than ATOL on these logits (the
# reference's own chunked and sequential paths part by as much). Through
# the sequential oracle on both sides the steps hold to ATOL.
CHUNKED_ATOL = 1e-4


@pytest.mark.parametrize("wkv", ["sequential", "chunked"])
def test_prefill_and_decode_match_jax_and_train_forward(rwkv_model,
                                                        monkeypatch, wkv):
    jcfg, cfg, vals, tvals = rwkv_model
    if wkv == "sequential":
        jac, atol = jzoo.ApplyCfg(mixer_impl="ref"), ATOL
        monkeypatch.setattr(
            ops._ref, "rwkv6_chunked_ref",
            lambda *a, chunk=64, **kw: ref.rwkv6_ref(*a, **kw))
    else:
        jac, atol = jzoo.ApplyCfg(mixer_impl="xla"), CHUNKED_ATOL
    B, S = 2, 16
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S + 2))
    jcache = jzoo.init_serve_cache(jcfg, B, S + 8, dtype=jnp.float32)
    jcache, jl = jzoo.prefill(vals, {"tokens": jnp.asarray(toks[:, :S])},
                              jcache, jcfg, ac=jac)
    tcache = zoo.init_serve_cache(cfg, B, S + 8, dtype=torch.float32,
                                  device="cpu")
    tcache, tl = zoo.prefill(tvals, {"tokens": _t(toks[:, :S])}, tcache, cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol,
                               rtol=ATOL)
    steps = []
    for i in range(2):
        jcache, jl = jzoo.decode_step(
            vals, jnp.asarray(toks[:, S + i:S + i + 1]), jcache,
            jnp.asarray(S + i, jnp.int32), jcfg, ac=jac)
        tcache, tl = zoo.decode_step(tvals, _t(toks[:, S + i:S + i + 1]),
                                     tcache, S + i, cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol,
                                   rtol=ATOL)
        steps.append(tl[:, 0])
    # Every cache leaf (x_prev and wkv of both mixes, every layer), to
    # ATOL relative to the leaf's largest entry: a wkv state sums up to
    # 18 k v^T terms of |k v| up to ~1e2, and its f32 rounding follows
    # the largest of them, not each entry.
    for got, want in zip(jax.tree.leaves(to_jax_values(tcache)),
                         jax.tree.leaves(_np(jcache))):
        assert np.abs(got - want).max() <= atol * max(
            1.0, np.abs(want).max()), np.abs(got - want).max()
    # ... and against the port's own training forward.
    full, _ = zoo.forward_train(tvals, {"tokens": _t(toks)}, cfg)
    torch.testing.assert_close(steps[0], full[:, S], atol=ATOL, rtol=ATOL)
    torch.testing.assert_close(steps[1], full[:, S + 1], atol=ATOL,
                               rtol=ATOL)


PROMPTS = [[5, 6, 7, 8, 9], [11, 12], [3] * 9, [200, 1, 17]]


def _generate_both(jcfg, cfg, vals, tvals, *, jac=None, max_new=6):
    sc = dict(max_batch=4, max_len=64)
    jeng = JServeEngine(vals, jcfg, JServeConfig(**sc),
                        **({} if jac is None else {"ac": jac}))
    teng = ServeEngine(tvals, cfg, ServeConfig(**sc), device="cpu")
    return (jeng.generate(PROMPTS, max_new=max_new),
            teng.generate(PROMPTS, max_new=max_new), teng)


@pytest.mark.parametrize("mixer_impl", ["xla", "pallas"])
def test_static_engine_greedy_matches_jax_rwkv(rwkv_model, mixer_impl):
    jcfg, cfg, vals, tvals = rwkv_model
    want, got, teng = _generate_both(
        jcfg, cfg, vals, tvals, jac=jzoo.ApplyCfg(mixer_impl=mixer_impl))
    assert got == want
    st = teng.last_stats
    assert st["mode"] == "static" and st["batch"] == 4
    assert st["prompt_len"] == 9 and st["decode_steps"] == 5


@pytest.fixture(scope="module")
def upcycled_rwkv():
    """Both packages upcycle the same dense rwkv values (expert_init
    copy) into the channel-mix MoE of ``rwkv6_7b.upcycled`` at the
    reduced size (every other layer, top-2, dropless); the reference's
    routers are handed to the port."""
    jd = jax_reduced(ARCH)
    jcfg = _dropless(jd.with_moe(JMoECfg(num_experts=4, router="top_k")))
    tcfg = _dropless(get_reduced(ARCH).with_moe(
        MoECfg(num_experts=4, router="top_k")))
    wrapped = jzoo.init_params(jax.random.PRNGKey(0), jd)
    dense, _ = jpm.split(wrapped)
    jsparse, _ = jpm.split(jup.upcycle_params(wrapped, jd, jcfg,
                                              jax.random.PRNGKey(7)))
    w = np.asarray(jsparse["stack"]["segments"][0]["pos1"]["ffn"]["router"]
                   ["w"])
    routers = [None, w[0], None, w[1]]
    tsparse = tup.upcycle_params(from_jax_values(_np(dense)),
                                 get_reduced(ARCH), tcfg, routers=routers)
    return jcfg, tcfg, jsparse, tsparse


def test_upcycle_rwkv_matches_jax(upcycled_rwkv):
    """Every mixer and channel-mix leaf is copied, every other layer's
    FFN is tiled into the experts: the port's tree equals the
    reference's exactly."""
    _, tcfg, jsparse, tsparse = upcycled_rwkv
    flat_j, tree_j = jax.tree.flatten(_np(jsparse))
    flat_t, tree_t = jax.tree.flatten(to_jax_values(tsparse))
    assert tree_t == tree_j
    for a, b in zip(flat_j, flat_t):
        assert a.shape == b.shape and np.array_equal(a, b)
    seg = tsparse["stack"]["segments"][0]
    assert set(seg) == {"pos0", "pos1"} and "experts" in seg["pos1"]["ffn"]
    assert seg["pos1"]["ffn"]["experts"]["wi"].shape[:2] == (2, 4)
    for pos in ("pos0", "pos1"):
        assert {"mixer", "cm", "ffn"} <= set(seg[pos])


def test_static_engine_greedy_matches_jax_upcycled_rwkv(upcycled_rwkv):
    jcfg, tcfg, jsparse, tsparse = upcycled_rwkv
    want, got, teng = _generate_both(jcfg, tcfg, jsparse, tsparse)
    assert got == want
    # The static engine keeps the reference's gather dispatch.
    assert teng.ac.dispatch == "gather"


def test_static_engine_greedy_matches_jax_granite():
    """The static attention path: dense KV caches, the flash forward at
    prefill and the plain decode attention, the gather MoE."""
    jcfg = _dropless(jax_reduced("granite-moe-1b-a400m"))
    cfg = _dropless(get_reduced("granite-moe-1b-a400m"))
    vals, _ = jpm.split(jzoo.init_params(jax.random.PRNGKey(0), jcfg))
    want, got, _ = _generate_both(jcfg, cfg, vals,
                                  from_jax_values(_np(vals)))
    assert got == want


def test_static_granite_prefill_and_decode_match_jax():
    jcfg = _dropless(jax_reduced("granite-moe-1b-a400m"))
    cfg = _dropless(get_reduced("granite-moe-1b-a400m"))
    vals, _ = jpm.split(jzoo.init_params(jax.random.PRNGKey(0), jcfg))
    tvals = from_jax_values(_np(vals))
    B, S = 2, 12
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S + 1))
    jc = jzoo.init_serve_cache(jcfg, B, S + 4, dtype=jnp.float32)
    jc, jl = jzoo.prefill(vals, {"tokens": jnp.asarray(toks[:, :S])}, jc,
                          jcfg)
    tc = zoo.init_serve_cache(cfg, B, S + 4, dtype=torch.float32,
                              device="cpu")
    tc, tl = zoo.prefill(tvals, {"tokens": _t(toks[:, :S])}, tc, cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=ATOL)
    jc, jl = jzoo.decode_step(vals, jnp.asarray(toks[:, S:]), jc,
                              jnp.asarray(S, jnp.int32), jcfg)
    tc, tl = zoo.decode_step(tvals, _t(toks[:, S:]), tc, S, cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=ATOL)
    for got, want in zip(jax.tree.leaves(to_jax_values(tc)),
                         jax.tree.leaves(_np(jc))):
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=ATOL)


def test_paged_engine_rejects_rwkv_and_launcher_serves_it_static(
        rwkv_model, capsys):
    _, cfg, _, tvals = rwkv_model
    with pytest.raises(ValueError, match="attention mixers only"):
        ServeEngine(tvals, cfg, ServeConfig(paged=True), device="cpu")
    with pytest.raises(ValueError, match="paged=True"):
        ServeEngine(tvals, cfg, device="cpu").serve([])
    from repro_torch.launch import serve as launch

    launch.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                 "--max-new", "3"])
    out = capsys.readouterr().out
    assert "mode=static" in out and "req2: [7, 7, 7, 7] -> [" in out


def test_temperature_sampling_is_seeded():
    """The static engine's temperature draws come from a torch generator
    (the reference's jax.random draws are not reproducible here, so they
    are held to greedy only): the same seed gives the same tokens."""
    cfg = get_reduced(ARCH)
    p = zoo.init_params(0, cfg, device="cpu")
    eng = ServeEngine(p, cfg, ServeConfig(max_batch=2, temperature=0.8),
                      device="cpu")
    a = eng.generate([[1, 2], [3]], max_new=5, seed=3)
    b = eng.generate([[1, 2], [3]], max_new=5, seed=3)
    assert a == b and all(len(s) in (7, 6) for s in a)


def test_profile_step_static_reports_host_ops_on_cpu(tmp_path, capsys):
    """``launch/profile_step.py --static`` (the source of PERF.md's rwkv
    trace): on the CPU it counts each phase's host ops and leaves every
    device number null."""
    import json

    from repro_torch.launch import profile_step

    out_file = tmp_path / "trace.json"
    profile_step.main(["--static", "--arch", ARCH, "--reduced", "--device",
                       "cpu", "--steps", "1", "--out", str(out_file)])
    out = json.loads(out_file.read_text())
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert out["step"] == "static"
    assert out["layers"] == get_reduced(ARCH).n_layers
    for phase in ("prefill", "decode"):
        ph = out[phase]
        assert ph["host_ops_per_layer"] > 10 and ph["wall_ms"] > 0
        assert all(ph[k] is None for k in ("device_busy_ms", "idle_share",
                                           "kernels", "top"))


def test_reference_init_is_chaotic_until_conditioned():
    """Why ``chip_smoke.py`` conditions the random rwkv6 models
    (``condition_rwkv``): at the reference's init a deep rwkv stack
    amplifies a 1e-6 relative change of the embeddings into visible
    logit changes, so two correct f32 implementations cannot be held
    token for token; rescaling ``wr/wk/wv/wg`` to fan-in d alone does not
    tame it, interleaving ``w0`` across the heads as well does. 16 layers
    at d 256 on the CPU."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
    import chip_smoke

    cfg = dataclasses.replace(get_reduced(ARCH), n_layers=16, d_model=256,
                              n_heads=4, n_kv_heads=4, d_ff=512,
                              vocab_size=1024, ssm=get_config(ARCH).ssm)
    toks = torch.randint(1, 1024, (2, 64),
                         generator=torch.Generator().manual_seed(0))

    def drift(p):
        out = []
        for eps in (0.0, 1e-6):
            q = dict(p, embed={"tokens": p["embed"]["tokens"] * (1 + eps)})
            cache = zoo.init_serve_cache(cfg, 2, 64, dtype=torch.float32,
                                         device="cpu")
            with torch.no_grad():
                out.append(zoo.prefill(q, {"tokens": toks}, cache, cfg)[1])
        return float((out[0] - out[1]).abs().max())

    chaotic = drift(zoo.init_params(0, cfg, device="cpu"))
    p = zoo.init_params(0, cfg, device="cpu")
    for seg in p["stack"]["segments"]:
        for pos in seg.values():
            for n in ("wr", "wk", "wv", "wg"):
                pos["mixer"][n] *= (cfg.n_heads / cfg.d_model) ** 0.5
    rescaled = drift(p)
    p = zoo.init_params(0, cfg, device="cpu")
    chip_smoke.condition_rwkv(p, cfg)
    calm = drift(p)
    assert chaotic > 1e-2 and rescaled > 10 * calm and calm < 1e-4, (
        chaotic, rescaled, calm)
