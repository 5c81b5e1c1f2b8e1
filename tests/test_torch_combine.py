"""The MoE combine adds each token's rows in a fixed order
(``core.routing.sum_rows``, and ``combine_stream`` for Expert Choice):
no atomic adds, so a call repeats bit for bit on the card. Here, on the CPU: for every router, the gather and
sorted dispatches equal the atomic forms they replaced (``index_add`` /
``scatter_add``) to float32 reassociation (rtol 1e-5, atol 1e-6), their
gradients too, and the metrics carry ``ep_overflow_frac`` — 0 outside
expert parallelism — as the reference's do."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.core import moe as jmoe
from repro.models import param as jpm
from repro_torch.configs import get_reduced
from repro_torch.core import moe as tmoe
from repro_torch.core import routing as trt
from repro_torch.kernels import ops
from repro_torch.kernels.grouped_mlp import ROW_BLOCK, ragged_destinations
from repro_torch.models.convert import from_jax_values
from torch_threads import one_thread  # noqa: F401 (autouse)

ROUTERS = ["top_k", "switch", "expert_choice"]


def _old_gather(params, xg, r, cfg):
    """The gather dispatch's former combine: index_add of every slot's
    weighted row into its token (trash row g)."""
    G, g, d = xg.shape
    idx = r.token_idx
    safe = torch.clamp(idx, max=g - 1).reshape(G, -1, 1).expand(-1, -1, d)
    valid = (idx < g)[..., None].to(xg.dtype)
    xe = torch.gather(xg, 1, safe).reshape(*idx.shape, d) * valid
    ex = params["experts"]
    ye = ops.expert_ffn(xe, ex["wi"], ex.get("wg"), ex["wo"], act=cfg.act,
                        implementation="eager")
    w = (r.combine[..., None] * valid).to(ye.dtype)
    yw = (ye * w).to(xg.dtype).reshape(-1, d)
    rows = (torch.arange(G)[:, None] * (g + 1)
            + idx.reshape(G, -1)).reshape(-1)
    y = xg.new_zeros((G * (g + 1), d)).index_add(0, rows, yw)
    return y.reshape(G, g + 1, d)[:, :g]


def _old_sorted(params, xg, r, cfg):
    """The sorted dispatch's former combine: scatter_add of the ragged
    rows into their tokens."""
    G, g, d = xg.shape
    E = r.probs.shape[-1]
    tok, eid, w = trt.assignment_stream(r, E, g)
    valid = (eid < E) & (tok < g)
    key = torch.where(valid, eid, torch.full_like(eid, E)).to(torch.int32)
    perm, key_s, counts, dest, M = ragged_destinations(key, E, ROW_BLOCK)
    tok_s, w_s = torch.gather(tok, 1, perm), torch.gather(w, 1, perm)
    dest = dest.long()
    src = torch.full((G, M + 1), g, dtype=torch.int64)
    src = src.scatter(1, dest, tok_s.long())[:, :M]
    wr = torch.zeros((G, M + 1), dtype=w.dtype).scatter(
        1, dest, torch.where(key_s < E, w_s, torch.zeros_like(w_s)))[:, :M]
    xs = torch.gather(xg, 1, torch.clamp(src, max=g - 1)[..., None]
                      .expand(G, M, d)) * (src < g)[..., None].to(xg.dtype)
    ex = params["experts"]
    ys = ops.grouped_mlp(xs, ex["wi"], ex.get("wg"), ex["wo"], counts,
                         act=cfg.act, block=ROW_BLOCK,
                         implementation="eager")
    yw = (ys * wr[..., None]).to(xg.dtype)
    y = torch.zeros((G, g + 1, d), dtype=xg.dtype)
    return y.scatter_add(1, src[..., None].expand(G, M, d), yw)[:, :g]


@pytest.fixture(scope="module")
def setup():
    cfg = get_reduced("granite-moe-1b-a400m")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, group_size=16, capacity_factor=1.5))
    params = tmoe.moe_init(torch.Generator().manual_seed(0), cfg, cfg.moe,
                           device="cpu")
    x = torch.randn((4, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    return cfg, params, x.reshape(4, 16, cfg.d_model)


@pytest.mark.parametrize("router", ROUTERS)
@pytest.mark.parametrize("dispatch", ["gather", "sorted"])
def test_fixed_order_combine_equals_atomic_form(setup, router, dispatch):
    """Outputs and gradients (input, router, experts) of the new combine
    against the former atomic one, on the same routing."""
    cfg, params, xg = setup
    new = {"gather": tmoe._gather_dispatch,
           "sorted": tmoe._sorted_dispatch}[dispatch]
    old = {"gather": _old_gather, "sorted": _old_sorted}[dispatch]
    outs = []
    for fn in (lambda p, x, r: new(p, x, r, cfg, implementation="eager"),
               lambda p, x, r: old(p, x, r, cfg)):
        x = xg.clone().requires_grad_(True)
        p = {"router": {"w": params["router"]["w"].clone()
                        .requires_grad_(True)},
             "experts": {k: v.clone().requires_grad_(True)
                         for k, v in params["experts"].items()}}
        logits = x @ p["router"]["w"]
        r = trt.route(logits, cfg.moe, router,
                      slot_tables=dispatch == "gather")
        y = fn(p, x, r)
        leaves = [x, p["router"]["w"], *p["experts"].values()]
        grads = torch.autograd.grad((y ** 2).sum(), leaves)
        outs.append((y.detach(), grads))
    (y_new, g_new), (y_old, g_old) = outs
    torch.testing.assert_close(y_new, y_old, rtol=1e-5, atol=1e-6)
    for a, b in zip(g_new, g_old):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("router", ROUTERS)
def test_combine_repeats_bit_for_bit(setup, router):
    cfg, params, xg = setup
    for dispatch in ("gather", "sorted", "einsum"):
        y1, _ = tmoe.moe_apply(params, xg, cfg, cfg.moe, router_kind=router,
                               dispatch=dispatch)
        y2, _ = tmoe.moe_apply(params, xg, cfg, cfg.moe, router_kind=router,
                               dispatch=dispatch)
        assert torch.equal(y1, y2)


@pytest.mark.parametrize("dispatch", ["gather", "sorted"])
def test_ep_overflow_frac_metric_matches_reference(dispatch):
    """Outside expert parallelism the metric is present and 0, as the
    reference reports it; the other metrics agree too."""
    jcfg, cfg = jax_reduced("grok-1-314b"), get_reduced("grok-1-314b")
    vals, _ = jpm.split(jmoe.moe_init(jax.random.PRNGKey(0), jcfg,
                                      jcfg.moe))
    tvals = from_jax_values(jax.tree.map(np.asarray, vals))
    x = np.random.default_rng(2).normal(
        size=(2, 16, cfg.d_model)).astype(np.float32)
    _, jm = jmoe.moe_apply(vals, x, jcfg, jcfg.moe, dispatch=dispatch)
    _, tm = tmoe.moe_apply(tvals, torch.from_numpy(x), cfg, cfg.moe,
                           dispatch=dispatch)
    assert set(tm) == set(jm)
    assert float(tm["ep_overflow_frac"]) == float(jm["ep_overflow_frac"])
    assert float(tm["ep_overflow_frac"]) == 0.0
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("A", [1, 3])
def test_row_map_moves_are_transposes(A):
    """``take_rows`` gives each row its unit's row and ``sum_rows`` each
    unit the sum of its rows in table order; each one's gradient is the
    other, with no row owned twice and unowned rows zero."""
    T, R, d = 6, 20, 5
    gen = torch.Generator().manual_seed(A)
    rows = torch.randperm(R, generator=gen)[:T * A].reshape(T, A)
    table = torch.where(torch.rand((T, A), generator=gen) < 0.3, R, rows)
    m = trt.row_map(table, R)
    x = torch.randn((T, d), generator=gen, requires_grad=True)
    z = torch.randn((R, d), generator=gen, requires_grad=True)
    taken = trt.take_rows(x, m)
    summed = trt.sum_rows(z, m)
    want_take = torch.zeros(R, d)
    want_sum = torch.zeros(T, d)
    for t in range(T):
        for a in range(A):
            if table[t, a] < R:
                want_take[table[t, a]] = x[t].detach()
                want_sum[t] += z[table[t, a]].detach()
    assert torch.equal(taken.detach(), want_take)
    assert torch.equal(summed.detach(), want_sum)
    u, v = torch.randn((R, d), generator=gen), torch.randn((T, d),
                                                           generator=gen)
    gx, = torch.autograd.grad((taken * u).sum(), x)
    gz, = torch.autograd.grad((summed * v).sum(), z)
    assert torch.equal(gx, trt.sum_rows(u, m))
    assert torch.equal(gz, trt.take_rows(v, m))
