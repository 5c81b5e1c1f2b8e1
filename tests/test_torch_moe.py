"""Port parity: routing, the ragged layout helpers, the grouped expert
FFN and the sorted-dispatch MoE layer of ``repro_torch`` against the JAX
package. Routing decisions (expert ids, keep masks, capacity drops) are
exact on inputs with no near-ties; layouts are exact; float outputs
agree at atol 1e-5 in float32. The CUDA grouped-GEMM kernel is held
against the plain version on the card in ``test_torch_kernels.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import MoECfg as JMoECfg
from repro.configs import get_reduced as jax_reduced
from repro.core import moe as jmoe
from repro.core import routing as jrt
from repro.kernels import grouped_mlp as jgm
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import param as jpm
from repro_torch.configs import MoECfg, get_reduced
from repro_torch.core import moe as tmoe
from repro_torch.core import routing as trt
from repro_torch.kernels import grouped_mlp as tgm
from repro_torch.kernels import ops
from repro_torch.models.convert import from_jax_values
from torch_threads import one_thread  # noqa: F401 (autouse)

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _logits(G, g, E, seed):
    """Router logits whose sorted probabilities have no near-ties, so
    top-k and BPR order are the same in both frameworks."""
    rng = np.random.default_rng(seed)
    while True:
        lg = (rng.normal(size=(G, g, E)) * 2.0).astype(np.float32)
        s = np.sort(lg, axis=-1)
        conf = np.sort(lg.max(-1) - np.log(np.exp(lg).sum(-1)), axis=-1)
        if np.diff(s).min() > 1e-4 and np.diff(conf).min() > 1e-6:
            return lg


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cf", [0.5, 1.0, 2.0])
@pytest.mark.parametrize("bpr", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_route_top_k_matches_jax(cf, bpr, masked):
    G, g, E, k = 2, 12, 6, 2
    lg = _logits(G, g, E, seed=int(cf * 10) + 3 * bpr + masked)
    mask = None
    if masked:
        mask = np.random.default_rng(7).random((G, g)) > 0.3
    kw = dict(num_experts=E, top_k=k, capacity_factor=cf, bpr=bpr)
    jr = jrt.route_top_k(jnp.asarray(lg), JMoECfg(**kw),
                         token_mask=None if mask is None
                         else jnp.asarray(mask))
    tr = trt.route_top_k(_t(lg), MoECfg(**kw),
                         token_mask=None if mask is None else _t(mask))
    np.testing.assert_array_equal(tr.token_expert.numpy(),
                                  np.asarray(jr.token_expert))
    for name in ("token_weight", "probs", "aux_loss", "dropped_frac"):
        np.testing.assert_allclose(
            getattr(tr, name).numpy(), np.asarray(getattr(jr, name)),
            atol=1e-6, rtol=1e-6, err_msg=name,
        )
    if cf < 1.0:
        assert (tr.token_expert == E).any()  # capacity really dropped


def test_switch_route_and_capacity_match_jax():
    lg = _logits(1, 10, 4, seed=11)
    kw = dict(num_experts=4, top_k=3, capacity_factor=1.0)
    jr = jrt.route(jnp.asarray(lg), JMoECfg(**kw), "switch")
    tr = trt.route(_t(lg), MoECfg(**kw), "switch")
    np.testing.assert_array_equal(tr.token_expert.numpy(),
                                  np.asarray(jr.token_expert))
    for g, cf, E in [(1, 1.0, 4), (136, 32.0, 32), (64, 2.0, 8),
                     (7, 0.25, 3), (4096, 1.25, 32)]:
        assert trt.capacity(g, MoECfg(num_experts=E, capacity_factor=cf)) \
            == jrt.capacity(g, JMoECfg(num_experts=E, capacity_factor=cf))
    # Expert Choice takes no token mask, as in the reference (decoders,
    # the only stacks with dead slots, route token-choice).
    with pytest.raises(ValueError, match="token-choice"):
        trt.route(_t(lg), MoECfg(**kw), "expert_choice",
                  token_mask=torch.ones(1, 10, dtype=torch.bool))


def test_assignment_stream_matches_jax():
    lg = _logits(2, 5, 4, seed=2)
    kw = dict(num_experts=4, top_k=2, capacity_factor=0.5)
    jr = jrt.route_top_k(jnp.asarray(lg), JMoECfg(**kw))
    tr = trt.route_top_k(_t(lg), MoECfg(**kw))
    for a, b in zip(trt.assignment_stream(tr, 4, 5),
                    jrt.assignment_stream(jr, 4, 5)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


# ---------------------------------------------------------------------------
# ragged layout helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bm", [4, 8, 16])
def test_layout_helpers_match_jax_exactly(bm):
    rng = np.random.default_rng(bm)
    G, N, E = 2, 37, 5
    key = rng.integers(0, E + 1, size=(G, N)).astype(np.int32)
    key[0][key[0] == 2] = E  # expert 2 empty in group 0
    got = tgm.ragged_destinations(_t(key), E, bm)
    want = jgm.ragged_destinations(jnp.asarray(key), E, bm)
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[4] == want[4]
    counts = got[2]
    nb = got[4] // bm
    for a, b in zip(tgm.block_tables(counts, bm, nb),
                    jgm.block_tables(jnp.asarray(counts.numpy()), bm, nb)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tgm.ragged_row_offsets(counts, bm),
                    jgm.ragged_row_offsets(jnp.asarray(counts.numpy()), bm)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# grouped expert FFN (plain version) against JAX ref / xla / pallas
# ---------------------------------------------------------------------------

GROUPED_CASES = [
    # G, E, d, f, bm, gated, act, per-(group, expert) valid rows
    (2, 4, 16, 24, 8, True, "silu", [[9, 0, 3, 8], [0, 0, 0, 20]]),
    (1, 3, 20, 12, 4, False, "gelu", [[5, 1, 2]]),
    (1, 5, 12, 16, 16, True, "gelu", [[1, 17, 0, 16, 2]]),
]


def _ragged(G, E, d, f, bm, gated, counts, seed=0):
    rng = np.random.default_rng(seed)
    counts = np.asarray(counts, np.int32)
    M = tgm.ragged_buffer_rows(int(counts.sum(-1).max()), E, bm)
    row_off, _ = tgm.ragged_row_offsets(_t(counts), bm)
    xs = np.zeros((G, M, d), np.float32)
    for g in range(G):
        for e in range(E):
            s, c = int(row_off[g, e]), int(counts[g, e])
            xs[g, s:s + c] = rng.normal(size=(c, d))
    w = lambda *s: (rng.normal(size=s) * 0.1).astype(np.float32)  # noqa
    return xs, w(E, d, f), w(E, d, f) if gated else None, w(E, f, d), counts


@pytest.mark.parametrize("case", GROUPED_CASES)
def test_grouped_mlp_plain_matches_jax(case):
    G, E, d, f, bm, gated, act, counts = case
    xs, wi, wg, wo, counts = _ragged(G, E, d, f, bm, gated, counts)
    tw = lambda a: None if a is None else _t(a)  # noqa: E731
    got = ops.grouped_mlp(_t(xs), _t(wi), tw(wg), _t(wo), _t(counts),
                          act=act, block=bm).numpy()
    jw = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    jargs = (jnp.asarray(xs), jnp.asarray(wi), jw(wg), jnp.asarray(wo),
             jnp.asarray(counts))
    want = {"ref": jref.grouped_mlp_ref(*jargs, block=bm, act=act)}
    for impl in ("xla", "pallas"):
        want[impl] = jops.grouped_mlp(*jargs, act=act, block=bm,
                                      implementation=impl)
    for impl, w in want.items():
        np.testing.assert_allclose(got, np.asarray(w), atol=ATOL, rtol=ATOL,
                                   err_msg=impl)


# ---------------------------------------------------------------------------
# the MoE layer, dispatch="sorted"
# ---------------------------------------------------------------------------


def _moe_setup(cf):
    jcfg = jax_reduced("granite-moe-1b-a400m")
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=cf))
    tcfg = get_reduced("granite-moe-1b-a400m")
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=cf))
    vals, _ = jpm.split(jmoe.moe_init(jax.random.PRNGKey(5), jcfg, jcfg.moe))
    return jcfg, tcfg, vals, from_jax_values(jax.tree.map(np.asarray, vals))


@pytest.mark.parametrize("cf", [0.5, 8.0])
@pytest.mark.parametrize("masked", [False, True])
def test_moe_apply_sorted_matches_jax(cf, masked):
    jcfg, tcfg, vals, tvals = _moe_setup(cf)
    rng = np.random.default_rng(int(cf) + masked)
    # 70 tokens: two routing groups of 64 with a padded tail.
    x = rng.normal(size=(7, 10, tcfg.d_model)).astype(np.float32)
    mask = (rng.random((7, 10)) > 0.25) if masked else None
    jy, jm = jmoe.moe_apply(
        vals, jnp.asarray(x), jcfg, jcfg.moe, dispatch="sorted",
        sorted_block=8,
        token_mask=None if mask is None else jnp.asarray(mask),
    )
    ty, tm = tmoe.moe_apply(
        tvals, _t(x), tcfg, tcfg.moe, dispatch="sorted",
        token_mask=None if mask is None else _t(mask),
    )
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL,
                               rtol=ATOL)
    for name in ("aux_loss", "dropped_frac"):
        np.testing.assert_allclose(tm[name].numpy(), np.asarray(jm[name]),
                                   atol=1e-6, err_msg=name)
    if masked:
        assert torch.equal(ty[~_t(mask)], torch.zeros_like(ty[~_t(mask)]))


def test_unported_dispatch_raises():
    # gather, einsum and sorted are all ported; any other name raises.
    _, tcfg, _, tvals = _moe_setup(2.0)
    with pytest.raises(ValueError, match="unknown dispatch"):
        tmoe.moe_apply(tvals, torch.zeros(2, tcfg.d_model), tcfg, tcfg.moe,
                       dispatch="ragged")


# ---------------------------------------------------------------------------
# the grouped FFN's backward and the MoE layer's gradients
# ---------------------------------------------------------------------------


def _assignment_buffers(G, E, d, block, key, x, dy):
    """Lay per-assignment rows x, dy (G, N, d) out in the ragged buffer
    of row block ``block`` (through the port's layout helper); returns
    (xs, dys, counts, rows) with rows[g, a] the buffer row of assignment
    a (-1 if dropped)."""
    perm, key_s, counts, dest, M = tgm.ragged_destinations(_t(key), E,
                                                           block)
    perm, dest = perm.numpy(), dest.numpy()
    xs = np.zeros((G, M, d), np.float32)
    dys = np.zeros((G, M, d), np.float32)
    rows = np.full(key.shape, -1)
    for g in range(G):
        for n in range(key.shape[1]):
            if dest[g, n] < M:
                a = perm[g, n]
                rows[g, a] = dest[g, n]
                xs[g, dest[g, n]] = x[g, a]
                dys[g, dest[g, n]] = dy[g, a]
    return xs, dys, counts.numpy(), rows


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", False)])
def test_grouped_mlp_bwd_plain_matches_pallas(act, gated):
    """G = 2, expert 2 empty in both groups, dropped assignments (key E).
    The JAX buffer uses 8-row blocks, the port's its own 16-row kernel
    block: dx is compared per assignment, dW directly."""
    from repro_torch.kernels import ref as tref

    G, E, d, f, N = 2, 5, 16, 24, 30
    rng = np.random.default_rng(3)
    key = rng.choice([0, 1, 3, 4, E], size=(G, N),
                     p=[0.3, 0.2, 0.2, 0.15, 0.15]).astype(np.int32)
    x = rng.normal(size=(G, N, d)).astype(np.float32)
    dy = rng.normal(size=(G, N, d)).astype(np.float32)
    w = lambda *s: (rng.normal(size=s) * 0.3).astype(np.float32)  # noqa
    wi, wg, wo = w(E, d, f), w(E, d, f) if gated else None, w(E, f, d)
    jxs, jdys, jcounts, jrows = _assignment_buffers(G, E, d, 8, key, x, dy)
    txs, tdys, tcounts, trows = _assignment_buffers(G, E, d, tgm.ROW_BLOCK,
                                                    key, x, dy)
    assert (jcounts[:, 2] == 0).all() and (key == E).any()
    be, bl = jgm.block_tables(jnp.asarray(jcounts), 8, jxs.shape[1] // 8)
    jw = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    jdx, jdwi, jdwg, jdwo = jgm._grouped_mlp_pallas_bwd(
        jnp.asarray(jxs), jnp.asarray(wi), jw(wg), jnp.asarray(wo),
        jnp.asarray(jdys), be, bl, act=act, bm=8, bf=None, bd=None,
        interpret=True)
    tw = lambda a: None if a is None else _t(a)  # noqa: E731
    tdx, tdwi, tdwg, tdwo = tref.grouped_mlp_bwd_ref(
        _t(txs), _t(wi), tw(wg), _t(wo), _t(tdys), _t(tcounts),
        block=tgm.ROW_BLOCK, act=act)
    jdx, tdx = np.asarray(jdx), tdx.numpy()
    for g in range(G):
        for a in range(N):
            if jrows[g, a] >= 0:
                np.testing.assert_allclose(tdx[g, trows[g, a]],
                                           jdx[g, jrows[g, a]], atol=ATOL,
                                           rtol=ATOL)
    # Rows no assignment landed on (padding, dead blocks) give dx = 0.
    hit = np.zeros(tdx.shape[:2], bool)
    for g in range(G):
        hit[g, trows[g][trows[g] >= 0]] = True
    assert not tdx[~hit].any()
    for t, j in ((tdwi, jdwi), (tdwg, jdwg), (tdwo, jdwo)):
        if j is None:
            assert t is None
            continue
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                                   rtol=ATOL)
    assert not tdwi[2].any() and not tdwo[2].any()


def test_grouped_mlp_autograd_matches_jax_grad():
    G, E, d, f, bm = 2, 5, 16, 24, 8
    xs, wi, wg, wo, counts = _ragged(G, E, d, f, bm, True,
                                     [[3, 0, 12, 9, 1], [0, 0, 0, 5, 17]])
    wy = np.random.default_rng(4).normal(size=xs.shape).astype(np.float32)

    def jloss(xs, wi, wg, wo):
        y = jops.grouped_mlp(xs, wi, wg, wo, jnp.asarray(counts), block=bm,
                             implementation="pallas")
        return jnp.sum(y * jnp.asarray(wy))

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (xs, wi, wg, wo)))
    ps = [_t(a).requires_grad_() for a in (xs, wi, wg, wo)]
    y = ops.grouped_mlp(*ps, _t(counts), block=bm)
    tg = torch.autograd.grad((y * _t(wy)).sum(), ps)
    for t, j in zip(tg, jg):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                                   rtol=ATOL)


@pytest.mark.parametrize("cf", [1.0, 8.0])
def test_moe_apply_sorted_grads_match_jax(cf):
    """Gradients through the router logits, the combine weights, the
    grouped FFN and the aux loss (none through the sort)."""
    jcfg, tcfg, vals, tvals = _moe_setup(cf)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(4, 32, tcfg.d_model)).astype(np.float32)
    wy = rng.normal(size=x.shape).astype(np.float32)

    def jloss(vals, x):
        y, m = jmoe.moe_apply(vals, x, jcfg, jcfg.moe, dispatch="sorted",
                              sorted_block=8)
        return jnp.sum(y * jnp.asarray(wy)) + m["aux_loss"]

    jgv, jgx = jax.grad(jloss, argnums=(0, 1))(vals, jnp.asarray(x))
    leaves = [t.requires_grad_() for t in jax.tree.leaves(tvals)]
    tx = _t(x).requires_grad_()
    y, m = tmoe.moe_apply(tvals, tx, tcfg, tcfg.moe, dispatch="sorted")
    tg = torch.autograd.grad((y * _t(wy)).sum() + m["aux_loss"],
                             leaves + [tx])
    for t, j in zip(tg, jax.tree.leaves(jgv) + [jgx]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                                   rtol=1e-4)


def _grouped_mlp_gathered(xs, wi, wg, wo, group_sizes, *, block, act):
    """The plain grouped version as slice 1 shipped it: every row block
    gathers its expert's weights, (G * nb, d, f) a call."""
    from repro_torch.models.layers import activation

    G, M, d = xs.shape
    nb = M // block
    be, bl = tgm.block_tables(group_sizes, block, nb)
    e = be.reshape(-1).long()
    x = xs.float().reshape(G * nb, block, d)
    h = torch.bmm(x, wi.float()[e])
    if wg is not None:
        h = activation(act)(h) * torch.bmm(x, wg.float()[e])
    else:
        h = activation(act)(h)
    y = torch.bmm(h, wo.float()[e])
    y = y * bl.reshape(G * nb, 1, 1).float()
    return y.reshape(G, M, d).to(xs.dtype)


@pytest.mark.parametrize("act,gated,d,f", [("silu", True, 64, 32),
                                          ("silu", True, 1024, 512),
                                          ("gelu", False, 1024, 512)])
def test_segment_walk_matches_the_gathered_plain_version(act, gated, d, f):
    """The segment-walk plain version (one matmul chain per expert, no
    gathered weights) against the slice-1 version at the serve cell's
    grouped shapes (136 rows x top-8 over 32 experts, skewed, with empty
    experts) and at the reduced width. At d = 64 the two are
    bit-identical; at d = 1024 the CPU's BLAS sums one (rows, d) product
    in another order than per-block batched products, so they agree to
    f32 reassociation (measured: 6e-7 of the output's largest entry);
    the bound is 2e-6 of it."""
    from repro_torch.kernels import ref as tref

    rng = np.random.default_rng(12)
    E, n = 32, 136 * 8
    w = rng.random(E) ** 3
    w[[5, 17]] = 0.0
    counts = np.floor(w / w.sum() * n).astype(np.int32)
    counts[0] += n - counts.sum()
    xs, wi, wg, wo, counts = _ragged(1, E, d, f, tgm.ROW_BLOCK, gated,
                                     counts[None], seed=12)
    tw = lambda a: None if a is None else _t(a)  # noqa: E731
    args = (_t(xs), _t(wi), tw(wg), _t(wo), _t(counts))
    kw = dict(block=tgm.ROW_BLOCK, act=act)
    new = tref.grouped_mlp_ref(*args, **kw)
    old = _grouped_mlp_gathered(*args, **kw)
    if d == 64:
        assert torch.equal(new, old)
    else:
        torch.testing.assert_close(new, old, rtol=0,
                                   atol=2e-6 * float(old.abs().max()))


# ---------------------------------------------------------------------------
# Expert Choice, the slot tables, the padded expert FFN and the gather /
# einsum dispatches
# ---------------------------------------------------------------------------


def _ec_logits(G, g, E, pad, seed):
    """Router logits whose per-expert token rankings have no near-ties
    (gaps of at least 1e-5 between the probabilities an expert ranks),
    with the last ``pad`` tokens of the last group exactly zero — the
    zero-padded tail ``_group`` appends, whose uniform probabilities tie
    exactly and must resolve toward the lower token id."""
    rng = np.random.default_rng(seed)
    while True:
        lg = (rng.normal(size=(G, g, E)) * 2.0).astype(np.float32)
        if pad:
            lg[-1, g - pad:] = 0.0
        p = np.exp(lg - lg.max(-1, keepdims=True))
        p = p / p.sum(-1, keepdims=True)
        real = p.copy()
        if pad:
            real[-1, g - pad:] = np.nan
        gaps = [np.diff(np.sort(col[~np.isnan(col)]))
                for col in real.transpose(0, 2, 1).reshape(-1, g)]
        near_uniform = np.abs(real[~np.isnan(real)] - 1.0 / E).min()
        if min(x.min() for x in gaps) > 1e-5 and near_uniform > 1e-5:
            return lg


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("cf,pad", [(2.0, 0), (2.0, 9), (0.5, 5)])
def test_route_expert_choice_matches_jax(normalize, cf, pad):
    G, g, E = 2, 24, 4
    lg = _ec_logits(G, g, E, pad, seed=int(cf * 10) + pad + normalize)
    kw = dict(num_experts=E, capacity_factor=cf, router="expert_choice",
              normalize_combine_weights=normalize)
    jr = jrt.route(jnp.asarray(lg), JMoECfg(**kw), "expert_choice")
    tr = trt.route(_t(lg), MoECfg(**kw), "expert_choice")
    np.testing.assert_array_equal(tr.token_idx.numpy(),
                                  np.asarray(jr.token_idx))
    for name in ("combine", "probs", "aux_loss", "dropped_frac"):
        np.testing.assert_allclose(
            getattr(tr, name).numpy(), np.asarray(getattr(jr, name)),
            atol=1e-6, rtol=1e-6, err_msg=name)
    assert tr.token_expert is None and tr.token_weight is None
    if pad and cf > 1.0:
        # The padded tokens' probabilities tie exactly; some expert takes
        # only part of them: the lower ids, as lax.top_k does.
        taken = [sorted(int(t) for t in row if t >= g - pad)
                 for row in tr.token_idx[-1]]
        part = [t for t in taken if 0 < len(t) < pad]
        assert part and all(t == list(range(g - pad, g - pad + len(t)))
                            for t in part)
    if cf < 1.0:
        assert float(tr.dropped_frac) > 0
    for a, b in zip(trt.assignment_stream(tr, E, g),
                    jrt.assignment_stream(jr, E, g)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("router,cf,masked", [
    ("top_k", 0.5, False), ("top_k", 2.0, True), ("switch", 1.0, False),
    ("switch", 0.25, True)])
def test_token_choice_slot_tables_match_jax(router, cf, masked):
    G, g, E = 2, 12, 6
    lg = _logits(G, g, E, seed=int(cf * 8) + masked)
    mask = np.random.default_rng(3).random((G, g)) > 0.3 if masked else None
    kw = dict(num_experts=E, top_k=2, capacity_factor=cf)
    jr = jrt.route(jnp.asarray(lg), JMoECfg(**kw), router,
                   token_mask=None if mask is None else jnp.asarray(mask))
    tr = trt.route(_t(lg), MoECfg(**kw), router,
                   token_mask=None if mask is None else _t(mask))
    np.testing.assert_array_equal(tr.token_idx.numpy(),
                                  np.asarray(jr.token_idx))
    np.testing.assert_allclose(tr.combine.numpy(), np.asarray(jr.combine),
                               atol=1e-6, rtol=1e-6)
    if cf >= 1.0:
        assert (tr.token_idx == g).any()  # unfilled slots are marked g
    bare = trt.route(_t(lg), MoECfg(**kw), router, slot_tables=False,
                     token_mask=None if mask is None else _t(mask))
    assert bare.token_idx is None and bare.combine is None
    assert torch.equal(bare.token_expert, tr.token_expert)


def _expert_case(G, E, cap, d, f, gated, seed):
    rng = np.random.default_rng(seed)
    xe = rng.normal(size=(G, E, cap, d)).astype(np.float32)
    xe[0, 1, cap - 2:] = 0.0  # unfilled slots arrive as zero rows
    w = lambda *s, fan: (rng.normal(size=s) / fan ** 0.5).astype(  # noqa
        np.float32)
    wi, wo = w(E, d, f, fan=d), w(E, f, d, fan=f)
    wg = w(E, d, f, fan=d) if gated else None
    dy = rng.normal(size=xe.shape).astype(np.float32)
    return xe, wi, wg, wo, dy


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", False)])
def test_expert_ffn_plain_matches_pallas(act, gated):
    """The plain expert FFN and its explicit backward against the TPU
    kernel's custom VJP run in interpret mode (``ops.expert_ffn`` with
    "pallas", vmapped over G = 2), zero rows included: forward at atol
    1e-5, gradients at rtol 2e-4."""
    from repro_torch.kernels import ref as tref

    xe, wi, wg, wo, dy = _expert_case(2, 3, 8, 16, 24, gated, seed=5)
    jw = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    tw = lambda a: None if a is None else _t(a)  # noqa: E731

    def jloss(xe, wi, wg, wo):
        y = jops.expert_ffn(xe, wi, wg, wo, act=act,
                            implementation="pallas")
        return jnp.sum(y * jnp.asarray(dy)), y

    argnums = (0, 1, 2, 3) if gated else (0, 1, 3)
    (_, jy), jg = jax.value_and_grad(jloss, argnums=argnums, has_aux=True)(
        jnp.asarray(xe), jnp.asarray(wi), jw(wg), jnp.asarray(wo))
    ty = ops.expert_ffn(_t(xe), _t(wi), tw(wg), _t(wo), act=act)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL,
                               rtol=ATOL)
    assert torch.equal(ty[0, 1, -2:], torch.zeros_like(ty[0, 1, -2:]))
    dx, dwi, dwg, dwo = tref.expert_ffn_bwd_ref(
        _t(xe), _t(wi), tw(wg), _t(wo), _t(dy), act=act)
    got = [dx, dwi] + ([dwg] if gated else []) + [dwo]
    for t, j in zip(got, jg):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=2e-4,
                                   atol=2e-4 * np.abs(j).max())
    # Autograd through ops.expert_ffn runs the same explicit backward,
    # with (E, cap, d) input too (the reference's squeeze path).
    ps = [_t(xe[1]).requires_grad_(), _t(wi).requires_grad_()]
    y1 = ops.expert_ffn(ps[0], ps[1], tw(wg), _t(wo), act=act)
    g1 = torch.autograd.grad((y1 * _t(dy[1])).sum(), ps)
    jy1 = jops.expert_ffn(jnp.asarray(xe[1]), jnp.asarray(wi), jw(wg),
                          jnp.asarray(wo), act=act, implementation="pallas")
    np.testing.assert_allclose(y1.detach().numpy(), np.asarray(jy1),
                               atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(g1[0].numpy(), dx[1].numpy(), atol=1e-6)


def _dispatch_setup(arch, cf, router_std, seed):
    """Reduced ``arch`` MoE params from the JAX init, the router scaled
    to ``router_std`` so that routing decisions have no near-ties."""
    jcfg = jax_reduced(arch)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=cf))
    tcfg = get_reduced(arch)
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=cf))
    vals, _ = jpm.split(jmoe.moe_init(jax.random.PRNGKey(seed), jcfg,
                                      jcfg.moe))
    vals = jax.tree.map(np.array, vals)
    vals["router"]["w"] = vals["router"]["w"] * np.float32(router_std / 0.02)
    return jcfg, tcfg, vals, from_jax_values(vals)


@pytest.mark.parametrize("dispatch", ["gather", "einsum"])
@pytest.mark.parametrize("arch,cf", [("vit-b16-upcycled", 2.0),
                                     ("vit-b16-upcycled", 0.5),
                                     ("granite-moe-1b-a400m", 1.0)])
def test_moe_apply_padded_dispatch_matches_jax(dispatch, arch, cf):
    """The gather and einsum dispatches against JAX's, with Expert
    Choice (the ViT's router, combine weights normalised) and top-k
    (granite's, gated silu): 70 tokens, two routing groups of 64, the
    second padded with 58 zero tokens. Outputs at atol 1e-5; gradients
    through the router, the combine weights, the gather and the expert
    FFN at rtol 1e-4."""
    jcfg, tcfg, vals, tvals = _dispatch_setup(arch, cf, 0.3, seed=6)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(7, 10, tcfg.d_model)).astype(np.float32)
    wy = rng.normal(size=x.shape).astype(np.float32)

    def jloss(vals, x):
        y, m = jmoe.moe_apply(vals, x, jcfg, jcfg.moe, dispatch=dispatch)
        return jnp.sum(y * jnp.asarray(wy)) + m["aux_loss"], (y, m)

    (_, (jy, jm)), (jgv, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, vals), jnp.asarray(x))
    leaves = [t.requires_grad_() for t in jax.tree.leaves(tvals)]
    tx = _t(x).requires_grad_()
    ty, tm = tmoe.moe_apply(tvals, tx, tcfg, tcfg.moe, dispatch=dispatch)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=ATOL, rtol=ATOL)
    for name in ("aux_loss", "dropped_frac"):
        np.testing.assert_allclose(tm[name].detach().numpy(),
                                   np.asarray(jm[name]), atol=1e-6,
                                   err_msg=name)
    tg = torch.autograd.grad((ty * _t(wy)).sum() + tm["aux_loss"],
                             leaves + [tx])
    for t, j in zip(tg, jax.tree.leaves(jgv) + [jgx]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                                   rtol=1e-4)
    # The three dispatches route alike, so they compute one function.
    ys, _ = tmoe.moe_apply(tvals, _t(x), tcfg, tcfg.moe, dispatch="sorted")
    torch.testing.assert_close(ys, ty.detach(), atol=ATOL, rtol=ATOL)
