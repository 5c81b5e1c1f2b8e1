"""Query-head padding (``ApplyCfg.pad_heads_multiple``) in the port: the
reference's ``tests/test_attention_padding.py`` ported, and the port at
a multiple held against the reference at the same multiple on the same
weights.

Zero query heads go in per KV group, so padded heads compute attention
that meets zero ``wo`` rows: the output is preserved (atol 2e-5 for a
layer, 1e-4 for a model's logits, as the reference's tests hold it;
float32 sums over more heads in another order). Against the reference:
loss atol 1e-4, rtol 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import model_zoo as jzoo
from repro.models import param as jpm
from repro_torch.configs import MoECfg, get_reduced
from repro_torch.core.moe import moe_apply, moe_init
from repro_torch.models import model_zoo as zoo
from repro_torch.models.attention import (
    attention_apply,
    attention_init,
    init_cache,
    pad_heads,
)
from repro_torch.models.convert import from_jax_values
from torch_threads import one_thread  # noqa: F401 (autouse)

CASES = [
    ("qwen2.5-14b", 3),    # 4 heads / 2 kv -> pad to 6
    ("yi-9b", 16),         # 4 heads / 2 kv -> pad to 16
    ("tinyllama-1.1b", 4),  # 4 heads already divisible -> no-op
]


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int64))
    return {"tokens": toks, "targets": toks}


@pytest.mark.parametrize("arch,mult", CASES)
def test_full_model_preserved(arch, mult):
    cfg = get_reduced(arch)
    v = zoo.init_params(0, cfg, device="cpu")
    b = _batch(cfg)
    l1, _ = zoo.forward_train(v, b, cfg)
    l2, _ = zoo.forward_train(
        v, b, cfg, ac=zoo.ApplyCfg(pad_heads_multiple=mult))
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_layer_level_padding_grouped_correctly():
    """Padded head count keeps H a multiple of Kh (GQA grouping); the
    training path and the static cache's prefill and decode agree."""
    cfg = get_reduced("qwen2.5-14b")  # 4 heads, 2 kv heads
    gen = torch.Generator().manual_seed(0)
    p = attention_init(gen, cfg, device="cpu")
    # mult=3: smallest g1 with 2*g1 % 3 == 0 is g1=3 -> 6 heads, each
    # group's 2 heads first, then its zero head.
    pp = pad_heads(p, 3)
    assert pp["wq"].shape[1] == 6 and pp["wo"].shape[0] == 6
    wq = pp["wq"].reshape(cfg.d_model, 2, 3, -1)
    torch.testing.assert_close(
        wq[:, :, :2].reshape(cfg.d_model, 4, -1), p["wq"], rtol=0, atol=0)
    assert not wq[:, :, 2].any()
    x = torch.randn((2, 16, cfg.d_model), generator=gen)
    y0, _ = attention_apply(p, x, cfg, causal=True)
    y1, _ = attention_apply(p, x, cfg, causal=True, pad_heads_multiple=3)
    np.testing.assert_allclose(y0.numpy(), y1.numpy(), atol=2e-5,
                               rtol=2e-5)
    cache = init_cache(cfg, 2, 24, dtype=torch.float32, device="cpu")
    attention_apply(p, x, cfg, causal=True, cache=cache, cache_index=0)
    q1 = torch.randn((2, 1, cfg.d_model), generator=gen)
    ya, _ = attention_apply(p, q1, cfg, causal=True,
                            cache={k: v.clone() for k, v in cache.items()},
                            cache_index=16)
    yb, _ = attention_apply(p, q1, cfg, causal=True,
                            cache={k: v.clone() for k, v in cache.items()},
                            cache_index=16, pad_heads_multiple=3)
    np.testing.assert_allclose(ya.numpy(), yb.numpy(), atol=2e-5,
                               rtol=2e-5)


def test_bpr_sort_roundtrip_deterministic():
    """BPR's stable sorts are deterministic and differentiable through
    repeated layers: two value-and-grad runs give identical bits."""
    cfg = get_reduced("tinyllama-1.1b")
    moe = MoECfg(num_experts=4, router="top_k", top_k=2, bpr=True,
                 group_size=64, capacity_factor=0.5)
    p = moe_init(torch.Generator().manual_seed(0), cfg, moe, device="cpu")
    x = torch.randn((2, 32, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))

    def run():
        leaves = [p["router"]["w"], *p["experts"].values()]
        for t in leaves:
            t.requires_grad_(True)
        y, drops = x, []
        for _ in range(2):
            y, m = moe_apply(p, y, cfg, moe)
            drops.append(m["dropped_frac"])
        loss = torch.sum(y ** 2)
        grads = torch.autograd.grad(loss, leaves)
        for t in leaves:
            t.requires_grad_(False)
        return loss.detach(), torch.stack(drops).detach(), grads

    l1, d1, g1 = run()
    l2, d2, g2 = run()
    assert float(l1) == float(l2)
    torch.testing.assert_close(d1, d2, rtol=0, atol=0)
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(d1[0]) > 0  # capacity 0.5 forces drops (BPR is active)


@pytest.mark.parametrize("arch,mult", CASES)
def test_padded_loss_matches_reference(arch, mult):
    """The port at ``pad_heads_multiple`` against the reference at the
    same multiple, on the reference's init and the same batch."""
    jcfg, cfg = jax_reduced(arch), get_reduced(arch)
    vals, _ = jpm.split(jzoo.init_params(jax.random.PRNGKey(0), jcfg))
    tvals = from_jax_values(jax.tree.map(np.asarray, vals))
    b = _batch(cfg)
    jb = {k: jnp.asarray(v.numpy()) for k, v in b.items()}
    jl, _ = jzoo.loss_fn(vals, jb, jcfg,
                         ac=jzoo.ApplyCfg(pad_heads_multiple=mult))
    tl, _ = zoo.loss_fn(tvals, b, cfg,
                        ac=zoo.ApplyCfg(pad_heads_multiple=mult))
    np.testing.assert_allclose(float(tl), float(jl), atol=1e-4, rtol=1e-4)
