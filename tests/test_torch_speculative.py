"""Port parity for speculative decoding on the reduced granite model: the
dense-parent draft (``models/draft.py``), exact rejection sampling
(``serve/speculative.py``), ``zoo.paged_verify_step`` and the
speculating ``ServeEngine``, each against the JAX package on the same
weights (carried across by ``models/convert.py``) and the same seeds.

Float32 throughout: verify logits within 1e-5 of the reference's (and
the verify lanes' attention within 1e-5 of ``reference_attention``);
the draft trees, the acceptance decisions, the served tokens and the
terminal records equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.core.upcycle import upcycle_params as jupcycle
from repro.models import model_zoo as jzoo
from repro.models import param as jpm
from repro.models.draft import dense_parent_params as jdense_parent
from repro.serve import ChaosConfig as JChaosConfig
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import speculative as jspec
from repro_torch.configs import get_reduced
from repro_torch.models import model_zoo as zoo
from repro_torch.models.attention import reference_attention
from repro_torch.models.convert import from_jax_values
from repro_torch.models.draft import (
    DRAFT_KINDS,
    dense_parent_params,
    make_draft,
    top1_cfg,
)
from repro_torch.serve import ChaosConfig, Request, ServeConfig, ServeEngine
from repro_torch.serve import speculative as spec
from torch_threads import one_thread  # noqa: F401 (autouse)

BS = 8
ATOL = 1e-5


def _dropless(cfg, **moe):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts), **moe))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def granite():
    jcfg = _dropless(jax_reduced("granite-moe-1b-a400m"))
    vals, _ = jpm.split(jzoo.init_params(jax.random.PRNGKey(0), jcfg))
    return (jcfg, vals, _dropless(get_reduced("granite-moe-1b-a400m")),
            from_jax_values(_np(vals)))


@pytest.fixture(scope="module")
def upcycled():
    """A freshly upcycled checkpoint (copy init, normalised combine
    weights: the MoE computes what its dense parent computes), as the
    reference's ``upcycled`` fixture builds it."""
    jcfg = _dropless(jax_reduced("granite-moe-1b-a400m"),
                     normalize_combine_weights=True)
    dcfg = jcfg.dense_parent()
    dp = jzoo.init_params(jax.random.PRNGKey(1), dcfg)
    up, _ = jpm.split(jupcycle(dp, dcfg, jcfg, jax.random.PRNGKey(2)))
    dvals, _ = jpm.split(dp)
    cfg = _dropless(get_reduced("granite-moe-1b-a400m"),
                    normalize_combine_weights=True)
    return jcfg, up, cfg, from_jax_values(_np(up)), _np(dvals)


def _reqs(R):
    # Staggered arrivals, varied prompt lengths, a budget-1 request (the
    # reference's trace).
    return [
        R(rid=0, prompt=[5, 9, 3, 7, 2, 11], max_new=10, arrival=0),
        R(rid=1, prompt=[8, 1, 4], max_new=1, arrival=0),
        R(rid=2, prompt=[5, 9, 3, 7, 2, 11, 6, 6, 13, 2], max_new=7,
          arrival=2),
        R(rid=3, prompt=[42, 17], max_new=9, arrival=4),
    ]


BASE = dict(max_batch=3, max_len=64, paged=True, block_size=BS,
            chunk_size=8, chunks_per_step=2)


def _serve_both(jcfg, jvals, cfg, tvals, reqs, *, rng=None, **kw):
    """The same trace through the reference's engine and the port's; the
    port's session seed is the one the reference draws from ``rng``."""
    jeng = JServeEngine(jvals, jcfg, JServeConfig(**BASE, **kw))
    jo, jf = jeng.serve(reqs(JRequest), rng=rng)
    seed = int(jax.random.randint(
        jax.random.PRNGKey(0) if rng is None else rng, (), 0, 2 ** 31 - 1))
    tkw = dict(kw)
    if isinstance(tkw.get("chaos"), JChaosConfig):
        tkw["chaos"] = ChaosConfig(**dataclasses.asdict(tkw["chaos"]))
    teng = ServeEngine(tvals, cfg, ServeConfig(**BASE, **tkw), device="cpu")
    to, tf = teng.serve(reqs(Request), seed=seed)
    return (jo, jf, jeng.last_stats), (to, tf, teng.last_stats)


# ---------------------------------------------------------------------------
# drafts
# ---------------------------------------------------------------------------


def test_dense_parent_matches_the_reference(upcycled):
    """Slicing expert 0 out of the upcycled tree gives the reference's
    tree, and on a copy-init upcycle that is the dense parent bit for
    bit."""
    jcfg, up, cfg, tup, dvals = upcycled
    want, wcfg = jdense_parent(up, jcfg)
    got, gcfg = dense_parent_params(tup, cfg)
    assert gcfg.moe is None and gcfg.name == wcfg.name
    flat_w, tree_w = jax.tree.flatten(_np(want))
    flat_g, tree_g = jax.tree.flatten(jax.tree.map(
        lambda t: t.numpy(), got))
    assert tree_w == tree_g
    for a, b in zip(flat_w, flat_g):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(dvals), flat_g):
        np.testing.assert_array_equal(a, b)
    # The embedding, head and norms are shared, not copied.
    assert got["embed"]["tokens"] is tup["embed"]["tokens"]


def test_make_draft_kinds(granite):
    _, _, cfg, tvals = granite
    assert DRAFT_KINDS == ("none", "dense", "top1")
    assert make_draft(tvals, cfg, "none") == (None, None)
    p1, c1 = make_draft(tvals, cfg, "top1")
    assert p1 is tvals and c1.moe.top_k == 1
    assert top1_cfg(cfg).name.endswith("-top1")
    with pytest.raises(ValueError, match="unknown draft kind"):
        make_draft(tvals, cfg, "medusa")
    with pytest.raises(ValueError, match="nothing to slice"):
        dense_parent_params(tvals, cfg.dense_parent())


# ---------------------------------------------------------------------------
# exact rejection sampling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.3])
def test_verify_accept_matches_the_reference(temperature):
    """The same drafts, q and p rows and seeds give the same emitted
    tokens and acceptance counts, draws and all, over a sweep of rows
    whose drafts the target agrees with and rejects."""
    rng = np.random.default_rng(int(temperature * 10))
    V, decisions = 24, set()
    for trial in range(60):
        k = int(rng.integers(0, 5))
        p_rows = rng.normal(size=(k + 1, V)) * 2.0
        q_logits = p_rows[:k] + rng.normal(size=(k, V)) * (trial % 3)
        if temperature > 0:
            q_rows = [jspec.draft_probs(q, temperature) for q in q_logits]
            drafts = [spec.draft_sample(q, temperature, 5, 9, 3 + j)[0]
                      for j, q in enumerate(q_logits)]
            for q, want in zip(q_logits, q_rows):
                np.testing.assert_array_equal(
                    spec.draft_probs(q, temperature), want)
        else:
            q_rows = [None] * k
            drafts = [int(q.argmax()) for q in q_logits]
        seed0, rid, n0 = int(rng.integers(1 << 30)), trial, trial % 7
        want = jspec.verify_accept(drafts, q_rows, p_rows, temperature,
                                   seed0, rid, n0)
        got = spec.verify_accept(drafts, q_rows, p_rows, temperature,
                                 seed0, rid, n0)
        assert got == want
        decisions.add(want[1] == k)
    assert decisions == {True, False}  # both full accepts and rejects
    for n in range(5):
        row = rng.normal(size=V)
        assert spec.sample_token(row, temperature, 3, 4, n) == \
            jspec.sample_token(row, temperature, 3, 4, n)


# ---------------------------------------------------------------------------
# the verify step
# ---------------------------------------------------------------------------


def _random_cache(cfg, P, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, P, BS, cfg.n_kv_heads, cfg.head_dim)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    mk = lambda f: {"stack": {"segments": [  # noqa: E731
        {"pos0": {"mixer": {"k": f(k), "v": f(v)}}}]}}
    return mk(jnp.asarray), mk(lambda a: torch.from_numpy(a.copy()))


def _verify_args(seed):
    """4 verify lanes of K1 = 4 rows (lens 4, 1, 0, 3; starts inside
    blocks) and 2 chunk lanes of one request (the second idle)."""
    rng = np.random.default_rng(seed)
    B, K1, NC, C, nb = 4, 4, 2, 8, 4
    tabs = np.arange(1, 1 + (B + 1) * nb).reshape(B + 1, nb).astype(np.int32)
    vlen = np.array([4, 1, 0, 3], np.int32)
    return dict(
        verify_tokens=rng.integers(1, 259, (B, K1)).astype(np.int32),
        chunk_tokens=rng.integers(1, 259, (NC, C)).astype(np.int32),
        verify_tables=tabs[:B] * (vlen > 0)[:, None],
        verify_starts=np.array([13, 5, 0, 22], np.int32),
        verify_lens=vlen,
        chunk_tables=np.stack([tabs[B], np.zeros(nb, np.int32)]),
        chunk_starts=np.array([0, 0], np.int32),
        chunk_lens=np.array([C, 0], np.int32),
    ), 1 + (B + 1) * nb


def test_verify_step_matches_jax(granite):
    """``paged_verify_step``: the logits at every live verify row and at
    the live chunk lane, and every pool row the step wrote, agree with
    the reference's."""
    jcfg, vals, cfg, tvals = granite
    args, P = _verify_args(1)
    jc, tc = _random_cache(cfg, P, seed=2)
    jc, jl = jzoo.paged_verify_step(
        vals, cache=jc, cfg=jcfg,
        ac=jzoo.ApplyCfg(dispatch="sorted", sorted_block=8),
        **{k: jnp.asarray(v) for k, v in args.items()})
    tc, tl = zoo.paged_verify_step(
        tvals, cache=tc, cfg=cfg, ac=zoo.ApplyCfg(dispatch="sorted"),
        **{k: torch.from_numpy(v) for k, v in args.items()})
    B, K1 = args["verify_tokens"].shape
    live = [b * K1 + j for b in range(B)
            for j in range(args["verify_lens"][b])] + [B * K1]
    assert tl.shape == (B * K1 + 2, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               atol=ATOL, rtol=ATOL)
    for name in ("k", "v"):
        got = tc["stack"]["segments"][0]["pos0"]["mixer"][name].numpy()
        want = np.asarray(jc["stack"]["segments"][0]["pos0"]["mixer"][name])
        np.testing.assert_allclose(got[:, 1:], want[:, 1:], atol=1e-4,
                                   rtol=ATOL)


def test_verify_lanes_match_reference_attention(granite):
    """The mixed step's verify lanes (attention alone, one layer): each
    live row of a lane starting inside a block attends exactly the
    positions up to its own, as ``reference_attention`` over the lane's
    blocks gathered dense computes it; rows past a lane's length and
    idle lanes come out zero."""
    from repro_torch.models.attention import MixedMeta, attention_apply

    _, _, cfg, tvals = granite
    layer = {k: v[0] for k, v in
             tvals["stack"]["segments"][0]["pos0"]["mixer"].items()}
    args, P = _verify_args(3)
    _, tc = _random_cache(cfg, P, seed=4)
    pools = {n: t[0] for n, t in
             tc["stack"]["segments"][0]["pos0"]["mixer"].items()}
    B, K1 = args["verify_tokens"].shape
    t = {k: torch.from_numpy(v) for k, v in args.items()}
    x = torch.randn(B * K1, 1, cfg.d_model, generator=torch.Generator()
                    .manual_seed(5))
    pos = (t["verify_starts"][:, None] + torch.arange(K1)[None]).reshape(-1)
    meta = MixedMeta(num_decode=0, num_chunks=0, chunk_tokens=0,
                     chunk_lens=torch.zeros(0, dtype=torch.int32),
                     num_verify=B, verify_tokens=K1,
                     verify_lens=t["verify_lens"])

    captured = {}
    import repro_torch.kernels.ops as ops
    orig = ops.prefill_attention

    def spy(q, kp, vp, tab, starts, lens, **kw):
        y = orig(q, kp, vp, tab, starts, lens, **kw)
        captured.update(q=q, y=y)
        return y

    ops.prefill_attention = spy
    try:
        attention_apply(layer, x, cfg, cache=pools, cache_index=pos,
                        block_tables=torch.repeat_interleave(
                            t["verify_tables"], K1, dim=0),
                        mixed=meta, implementation="eager")
    finally:
        ops.prefill_attention = orig
    q, y = captured["q"], captured["y"]
    for b in range(B):
        n, st = int(args["verify_lens"][b]), int(args["verify_starts"][b])
        assert torch.equal(y[b, n:], torch.zeros_like(y[b, n:]))
        if not n:
            continue
        tab = t["verify_tables"][b].long()
        k = pools["k"][tab].reshape(1, -1, *pools["k"].shape[2:])
        v = pools["v"][tab].reshape(1, -1, *pools["v"].shape[2:])
        want = reference_attention(q[b:b + 1, :n], k, v, causal=True,
                                   q_offset=st)
        torch.testing.assert_close(y[b:b + 1, :n], want, atol=ATOL,
                                   rtol=ATOL)


# ---------------------------------------------------------------------------
# the speculating engine
# ---------------------------------------------------------------------------


def test_spec_validation_matches_the_reference(granite):
    jcfg, vals, cfg, tvals = granite
    for kw, match in ((dict(draft="medusa"), "draft kind"),
                      (dict(draft="top1", spec_k=0), "spec_k"),
                      (dict(draft="top1", admission="prefill_on_join"),
                       "chunked")):
        with pytest.raises(ValueError, match=match) as want:
            JServeEngine(vals, jcfg, JServeConfig(**BASE, **kw))
        with pytest.raises(ValueError, match=match) as got:
            ServeEngine(tvals, cfg, ServeConfig(**BASE, **kw), device="cpu")
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kind", ["dense", "top1"])
def test_greedy_spec_matches_the_reference(granite, kind):
    """Greedy serving with each draft kind: tokens, terminal records
    (drafted and accepted counts included) and the engine's counters
    equal the reference's, and the drafts reproduce vanilla greedy
    decoding with one verify shape and two draft shapes."""
    jcfg, vals, cfg, tvals = granite
    (jo, jf, js), (to, tf, ts) = _serve_both(jcfg, vals, cfg, tvals, _reqs,
                                             draft=kind, spec_k=3)
    assert to == jo and tf == jf
    for key in ("mixed_steps", "spec_drafted", "spec_accepted",
                "compile_count", "chunk_rows_used", "acceptance_rate",
                "spec", "draft_compile_count"):
        assert ts[key] == js[key], key
    assert ts["draft_compile_count"] == 2
    vanilla, _ = ServeEngine(tvals, cfg, ServeConfig(**BASE),
                             device="cpu").serve(_reqs(Request))
    assert to == vanilla


def test_temperature_spec_matches_the_reference(upcycled):
    """At temperature 0.8 on the fresh upcycle (q == p) the dense draft
    accepts everything, and the tokens equal the reference's and the
    port's vanilla run, given the reference session's seed."""
    jcfg, up, cfg, tup, _ = upcycled
    rng = jax.random.PRNGKey(7)
    (jo, jf, js), (to, tf, ts) = _serve_both(
        jcfg, up, cfg, tup, _reqs, rng=rng, temperature=0.8,
        draft="dense", spec_k=3)
    assert to == jo and tf == jf
    assert ts["acceptance_rate"] == js["acceptance_rate"] == 1.0
    seed = int(jax.random.randint(rng, (), 0, 2 ** 31 - 1))
    vanilla, _ = ServeEngine(tup, cfg, ServeConfig(**BASE, temperature=0.8),
                             device="cpu").serve(_reqs(Request), seed=seed)
    assert to == vanilla


def test_spec_under_chaos_matches_the_reference(granite):
    """Seeded chaos with speculation (the reference's test settings):
    the same terminal records and tokens in both packages, one verify
    shape, audits every tick."""
    jcfg, vals, cfg, tvals = granite

    def mk(R):
        return [R(rid=rid, prompt=[(37 * rid + 11 * i) % 97 + 1
                                   for i in range(10 + (3 * rid) % 12)],
                  max_new=4 + rid % 4, arrival=rid) for rid in range(5)]

    for seed in range(2):
        chaos = JChaosConfig(seed=seed, evict_prob=0.15, hold_prob=0.2,
                             hold_max_blocks=3, hold_ticks=2,
                             burst_prob=0.1, burst_size=2, burst_plen=9,
                             burst_max_new=3)
        (jo, jf, js), (to, tf, ts) = _serve_both(
            jcfg, vals, cfg, tvals, mk, draft="top1", spec_k=3,
            num_blocks=1 + 24, preempt=True, queue_limit=8,
            queue_policy="shed-newest", watchdog_ticks=16, chaos=chaos)
        assert to == jo and tf == jf, seed
        assert ts["chaos"] == js["chaos"]
        assert ts["audits"] == js["audits"] > ts["mixed_steps"]
        assert ts["compile_count"] == 1


def test_spec_oversized_request_fails_clean(granite):
    """The doubled (target + draft lanes) footprint makes a request
    unadmittable: the watchdog fails it, as in the reference, and the
    session drains without leaking."""
    _, _, cfg, tvals = granite
    eng = ServeEngine(tvals, cfg, ServeConfig(
        **dict(BASE, max_batch=1), draft="top1", spec_k=2,
        num_blocks=1 + 8, watchdog_ticks=4), device="cpu")
    outs, fin = eng.serve([
        Request(rid=0, prompt=list(range(1, 33)), max_new=8),
        Request(rid=1, prompt=[4, 2], max_new=4)])
    assert fin[0]["status"] == "failed"
    assert fin[1]["status"] == "completed"
    assert eng.last_stats["free_blocks_at_close"] == 8
