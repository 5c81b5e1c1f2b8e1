"""Port parity for the serving slice: ``paged_mixed_step`` and
``paged_decode_step`` logits and pools against the JAX package on the
reduced granite model (float32, atol 1e-5), and ``ServeEngine`` outputs
token-identical to the JAX paged engine (greedy, and temperature
sampling given the JAX session's seed), with one step signature. Also:
importing the port leaves jax and repro out, and the entry points raise
without a card unless asked for the CPU."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import model_zoo as jzoo
from repro.models import param as jpm
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_reduced
from repro_torch.models import model_zoo as zoo
from repro_torch.models.convert import from_jax_values, to_jax_values
from repro_torch.serve import Request, ServeConfig, ServeEngine

BS = 8
ATOL = 1e-5
# Pool contents of deeper layers: k/v of hidden states that grew to |x|
# ~ 15 over random pools, after f32 reassociation compounded through the
# layers below (measured: 4e-6 at layer 0, 6e-5 at layer 3).
POOL_ATOL = 1e-4
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


def _dropless(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))


@pytest.fixture(scope="module")
def granite():
    jcfg = _dropless(jax_reduced("granite-moe-1b-a400m"))
    vals, _ = jpm.split(jzoo.init_params(jax.random.PRNGKey(0), jcfg))
    tvals = from_jax_values(jax.tree.map(np.asarray, vals))
    return jcfg, _dropless(get_reduced("granite-moe-1b-a400m")), vals, tvals


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def test_convert_round_trip(granite):
    _, _, vals, tvals = granite
    back = to_jax_values(tvals)
    flat_j, tree_j = jax.tree.flatten(jax.tree.map(np.asarray, vals))
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_j == tree_b
    for a, b in zip(flat_j, flat_b):
        np.testing.assert_array_equal(a, b)


def _random_cache(cfg, P, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, P, BS, cfg.n_kv_heads, cfg.head_dim)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    mk = lambda f: {"stack": {"segments": [  # noqa: E731
        {"pos0": {"mixer": {"k": f(k), "v": f(v)}}}]}}
    return mk(jnp.asarray), mk(_t)


def _pools(cache):
    m = cache["stack"]["segments"][0]["pos0"]["mixer"]
    return np.asarray(m["k"]), np.asarray(m["v"])


def test_mixed_step_matches_jax(granite):
    """Decode rows of ragged lengths (one free) plus two chunk lanes of
    one request (the second attends the first's in-step writes) and an
    idle lane: logits and every live pool block agree."""
    jcfg, cfg, vals, tvals = granite
    B, NC, C, nb = 3, 3, 8, 4
    P = 1 + (B + 1) * nb
    jc, tc = _random_cache(cfg, P, seed=1)
    rng = np.random.default_rng(2)
    tabs = np.arange(1, P).reshape(B + 1, nb).astype(np.int32)
    dec_len = np.array([6, 0, 19], np.int32)
    dec_tab = tabs[:B] * (dec_len > 0)[:, None]
    args = dict(
        dec_tokens=rng.integers(1, 259, (B, 1)).astype(np.int32),
        chunk_tokens=rng.integers(1, 259, (NC, C)).astype(np.int32),
        dec_tables=dec_tab, dec_lengths=dec_len,
        chunk_tables=np.concatenate([np.repeat(tabs[B:], 2, axis=0),
                                     np.zeros((1, nb), np.int32)]),
        chunk_starts=np.array([0, C, 0], np.int32),
        chunk_lens=np.array([C, 5, 0], np.int32),
    )
    jc, jl = jzoo.paged_mixed_step(
        vals, cache=jc, cfg=jcfg,
        ac=jzoo.ApplyCfg(dispatch="sorted", sorted_block=8),
        **{k: jnp.asarray(v) for k, v in args.items()},
    )
    tc, tl = zoo.paged_mixed_step(
        tvals, cache=tc, cfg=cfg, ac=zoo.ApplyCfg(dispatch="sorted"),
        **{k: _t(v) for k, v in args.items()},
    )
    live_rows = slice(0, B + NC - 1)  # the idle lane's logits are unused
    np.testing.assert_allclose(tl.numpy()[live_rows],
                               np.asarray(jl)[live_rows], atol=ATOL,
                               rtol=ATOL)
    for got, want in zip(_pools(tc), _pools(jc)):
        np.testing.assert_allclose(got[:, 1:], want[:, 1:],
                                   atol=POOL_ATOL, rtol=ATOL)


def test_decode_step_matches_jax(granite):
    jcfg, cfg, vals, tvals = granite
    B, nb = 3, 4
    P = 1 + B * nb
    jc, tc = _random_cache(cfg, P, seed=3)
    lengths = np.array([9, 0, 25], np.int32)
    tabs = np.arange(1, P).reshape(B, nb).astype(np.int32)
    tabs = tabs * (lengths > 0)[:, None]
    toks = np.array([[5], [0], [77]], np.int32)
    jc, jl = jzoo.paged_decode_step(
        vals, jnp.asarray(toks), jc, jnp.asarray(tabs),
        jnp.asarray(lengths), jcfg,
        ac=jzoo.ApplyCfg(dispatch="sorted", sorted_block=8),
    )
    tc, tl = zoo.paged_decode_step(tvals, _t(toks), tc, _t(tabs),
                                   _t(lengths), cfg,
                                   ac=zoo.ApplyCfg(dispatch="sorted"))
    live = lengths > 0
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               atol=ATOL, rtol=ATOL)
    for got, want in zip(_pools(tc), _pools(jc)):
        np.testing.assert_allclose(got[:, 1:], want[:, 1:],
                                   atol=POOL_ATOL, rtol=ATOL)


def _serve_both(granite, reqs, *, seed_rng=None, **sc):
    jcfg, cfg, vals, tvals = granite
    common = dict(max_len=64, block_size=BS, **sc)
    jeng = JServeEngine(vals, jcfg, JServeConfig(paged=True, **common))
    jouts, jfin = jeng.serve([JRequest(**r) for r in reqs], rng=seed_rng)
    seed = 0
    if seed_rng is not None:
        seed = int(jax.random.randint(seed_rng, (), 0, 2 ** 31 - 1))
    teng = ServeEngine(tvals, cfg, ServeConfig(**common), device="cpu")
    touts, tfin = teng.serve([Request(**r) for r in reqs], seed=seed)
    return (jouts, jfin, jeng.last_stats), (touts, tfin, teng.last_stats)


def test_engine_greedy_matches_jax_staggered_shared_prefix(granite):
    """Staggered arrivals, a prompt longer than one tick's chunk lanes,
    a shared prefix served from the prefix index (with a copy-on-write
    tail) and a same-tick follower served in flight."""
    prefix = list(range(30, 48))
    reqs = [
        dict(rid=0, prompt=prefix + [7, 8], max_new=6),
        dict(rid=1, prompt=list(range(100, 131)), max_new=5, arrival=1),
        dict(rid=2, prompt=[5, 6], max_new=7, arrival=2),
        dict(rid=3, prompt=prefix[:12] + [9], max_new=5, arrival=6),
        dict(rid=4, prompt=[3] * 17 + [1], max_new=4, arrival=16),
        dict(rid=5, prompt=[3] * 17 + [2], max_new=4, arrival=16),
    ]
    (jo, jf, js), (to, tf, ts) = _serve_both(
        granite, reqs, max_batch=4, chunk_size=8, chunks_per_step=2)
    assert to == jo
    for rid in jf:
        for key in ("prefix_tokens", "admitted_at", "first_token_at",
                    "finished_at", "status", "reason"):
            assert tf[rid][key] == jf[rid][key], (rid, key)
    for key in ("mixed_steps", "prefix_hit_tokens", "chunk_rows_used",
                "inflight_promotions"):
        assert ts[key] == js[key], key
    assert ts["prefix_hit_frac"] > 0 and ts["inflight_promotions"] > 0
    assert ts["compile_count"] == 1


def test_engine_temperature_matches_jax_given_its_seed(granite):
    reqs = [
        dict(rid=0, prompt=[5, 6], max_new=5),
        dict(rid=1, prompt=list(range(80, 93)), max_new=5, arrival=1),
    ]
    (jo, _, _), (to, _, _) = _serve_both(
        granite, reqs, seed_rng=jax.random.PRNGKey(7), max_batch=2,
        chunk_size=8, temperature=0.8)
    assert to == jo


def test_engine_runs_sorted_dispatch_under_default_apply_cfg(granite,
                                                             monkeypatch):
    """``ApplyCfg``'s default dispatch is the reference's "gather"; the
    paged engine switches it to the sorted ragged dispatch, as the
    reference's engine does, so its mixed steps run the grouped FFN and
    never the padded expert FFN."""
    from repro_torch.kernels import ops

    _, cfg, _, tvals = granite
    assert zoo.ApplyCfg().dispatch == "gather"
    calls = {"grouped_mlp": 0, "expert_ffn": 0}
    for name in calls:
        def counted(*a, _fn=getattr(ops, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    eng = ServeEngine(tvals, cfg, ServeConfig(
        max_batch=2, max_len=64, block_size=BS, chunk_size=8,
        chunks_per_step=2), device="cpu")
    assert eng.ac.dispatch == "sorted"
    eng.serve([Request(rid=0, prompt=list(range(10, 22)), max_new=3)])
    assert calls["grouped_mlp"] > 0 and calls["expert_ffn"] == 0
    # An explicit non-default dispatch is kept.
    eng = ServeEngine(tvals, cfg, ServeConfig(max_len=64, block_size=BS),
                      ac=zoo.ApplyCfg(dispatch="einsum"), device="cpu")
    assert eng.ac.dispatch == "einsum"


def test_single_step_signature_and_eos(granite):
    """A heterogeneous trace (prompts across lengths, evictions,
    re-admissions, an EOS stop) runs ONE mixed-step input signature,
    frees every block, and stops at the first EOS like the reference."""
    _, cfg, _, tvals = granite
    eng = ServeEngine(tvals, cfg, ServeConfig(
        max_batch=2, max_len=64, block_size=BS, chunk_size=8,
        chunks_per_step=2), device="cpu")
    reqs = lambda eos=None: [  # noqa: E731
        Request(rid=i, prompt=list(range(10 + i, 10 + i + plen)),
                max_new=3 + i % 3, arrival=2 * i, eos_id=eos)
        for i, plen in enumerate([3, 17, 9, 26, 1, 12])
    ]
    outs, fin = eng.serve(reqs())
    assert eng.last_stats["compile_count"] == 1
    assert eng.last_stats["free_blocks_at_close"] == 2 * 8  # every block
    eos = outs[1][17 + 1]  # rid 1's second generated token
    outs_e, fin_e = eng.serve(reqs(eos))
    gen = outs[1][17:]
    stop = gen.index(eos) + 1
    assert outs_e[1][17:] == gen[:stop]
    assert fin_e[1]["reason"] == "eos"
    assert eng.last_stats["compile_count"] == 1


def test_import_leaves_jax_and_repro_out():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' "
        "or k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok', *sorted(k for k in sys.modules "
        "if k.startswith('repro_torch')))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    walked = set(res.stdout.split()[1:])
    assert len(walked) >= 42
    # The training and vision slices' modules are among those walked.
    assert {f"repro_torch.{m}" for m in (
        "configs.vit_upcycled", "core.routing", "core.upcycle",
        "data.pipeline", "data.synthetic", "kernels.expert_mlp",
        "kernels.flash_attention", "launch.profile_step", "launch.train",
        "optim.adafactor", "optim.base", "optim.schedules",
        "training.train_loop")} <= walked


def test_entry_points_need_a_card_unless_cpu(granite, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    _, cfg, _, tvals = granite
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zoo.init_params(0, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zoo.init_paged_serve_cache(cfg, 4, BS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(tvals, cfg)
    from repro_torch.launch import serve as launch

    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(["--arch", "granite-moe-1b-a400m", "--reduced"])
    # ...and everything runs when asked for the CPU.
    p = zoo.init_params(0, cfg, device="cpu")
    assert p["embed"]["tokens"].device.type == "cpu"
    launch.main(["--arch", "granite-moe-1b-a400m", "--reduced",
                 "--device", "cpu", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "compile_count=1" in out and "req2:" in out


@pytest.mark.parametrize("field,value", [
    ("paged", False), ("admission", "prefill_on_join"), ("draft", "dense"),
    ("chaos", object()),
])
def test_unported_engine_options_raise(granite, field, value):
    _, cfg, _, tvals = granite
    sc = ServeConfig(**{field: value})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServeEngine(tvals, cfg, sc, device="cpu")


def test_reference_init_is_chaotic_until_attention_is_conditioned():
    """Why ``chip_smoke.py`` rescales the random attention projections:
    with the reference's fan-in rule (``fan_in = shape[-2]``, the head
    count for ``wq (d, H, dh)``) a deep random model amplifies a 1e-6
    perturbation into visible logit changes, so two correct f32
    implementations cannot be held together; at fan-in d it stays near
    f32 noise. 24 layers at d 128 on the CPU."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
    import chip_smoke

    base = get_reduced("granite-moe-1b-a400m")
    cfg = dataclasses.replace(
        base, n_layers=24, d_model=128, n_heads=8, n_kv_heads=4, d_ff=64,
        vocab_size=500)
    g = torch.Generator().manual_seed(5)
    B, NC, C, nb = 4, 2, 32, 16
    P = 1 + B * nb
    pools = torch.randn(2, cfg.n_layers, P, 16, 4, 16, generator=g)
    tables = (1 + torch.randperm(P - 1, generator=g)).reshape(B, nb).int()
    dl = torch.tensor([0, 5, 100, 250], dtype=torch.int32)
    toks = torch.randint(1, 500, (B, 1), generator=g, dtype=torch.int32)
    ctoks = torch.randint(1, 500, (NC, C), generator=g, dtype=torch.int32)

    def logits(p, eps):
        p = dict(p, embed={"tokens": p["embed"]["tokens"] * (1 + eps)})
        cache = {"stack": {"segments": [{"pos0": {"mixer": {
            "k": pools[0].clone(), "v": pools[1].clone()}}}]}}
        return zoo.paged_mixed_step(
            p, toks, ctoks, cache, tables * (dl > 0)[:, None], dl,
            tables[:1].repeat(NC, 1),
            torch.tensor([0, C], dtype=torch.int32),
            torch.tensor([C, 20], dtype=torch.int32), cfg)[1]

    p = zoo.init_params(0, cfg, device="cpu")
    chaotic = (logits(p, 0.0) - logits(p, 1e-6)).abs().max()
    chip_smoke.condition_attention(p, cfg)
    calm = (logits(p, 0.0) - logits(p, 1e-6)).abs().max()
    assert chaotic > 1e-3 > 1e-4 > calm, (float(chaotic), float(calm))


def test_profile_step_reports_host_ops_on_cpu(tmp_path, capsys):
    """``launch/profile_step.py`` (the source of PERF.md's op counts and
    step trace): on the CPU it counts the step's host ops and leaves
    every device number null."""
    import json

    from repro_torch.launch import profile_step

    out_file = tmp_path / "trace.json"
    profile_step.main(["--reduced", "--device", "cpu", "--steps", "1",
                       "--out", str(out_file)])
    out = json.loads(out_file.read_text())
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert out["layers"] == get_reduced("granite-moe-1b-a400m").n_layers
    assert out["host_ops_per_layer"] > 100 and out["wall_ms"] > 0
    assert all(out[k] is None for k in ("device_kernels", "device_busy_ms",
                                        "idle_share", "kernels", "top"))
