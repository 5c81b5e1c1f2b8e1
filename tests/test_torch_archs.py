"""Every architecture of the reference in the port: the registry and its
configs against the JAX package's, the port of the reference's
``tests/test_archs_smoke.py`` over all twelve archs, pixtral's patch
frontend (its data stream, its forward, its upcycled config) and the
launchers on jamba, pixtral and qwen1.5, on the CPU at reduced size.

Configs compare field for field (``dataclasses.asdict``). Losses of
the seven archs in NEW are held against the reference's on the same
weights (converted from the reference's init) and the same batch at
rtol 2e-4, as for the other families; logits at atol 1e-5 (float32 sums
in another order); the patch stream bit for bit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.core import upcycle as jup
from repro.data import make_iterator as jmake_iterator
from repro.models import model_zoo as jzoo
from repro.models import param as jpm
from repro_torch import configs as tconfigs
from repro_torch.core import upcycle as tup
from repro_torch.data import make_iterator
from repro_torch.models import model_zoo as zoo
from repro_torch.models.convert import from_jax_values
from repro_torch.models.param import tree_leaves
from repro_torch.optim import adafactor, schedules
from repro_torch.training import init_train_state, make_train_step
from repro_torch.training.train_loop import batch_to
from torch_threads import one_thread  # noqa: F401 (autouse)

ALL = tconfigs.assigned_archs() + ["t5-base-upcycled", "vit-b16-upcycled"]
# The archs beside granite, whisper, rwkv6 and the paper's T5 and ViT,
# whose own parity tests live in their own files.
NEW = ["pixtral-12b", "qwen2.5-14b", "tinyllama-1.1b", "qwen1.5-0.5b",
       "yi-9b", "grok-1-314b", "jamba-1.5-large-398b"]
JAC = jzoo.ApplyCfg(dispatch="gather", moe_impl="xla", attn_impl="xla")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_registry_and_configs_match_the_reference():
    """The same twelve archs, the assigned ten in the same order, every
    FULL and REDUCED equal field for field, the shape grid and every
    (arch, shape) applicability equal, and the config modules'
    ``upcycled()`` targets equal."""
    assert tconfigs.list_configs() == jconfigs.list_configs()
    assert tconfigs.assigned_archs() == jconfigs.assigned_archs()
    assert sorted(ALL) == tconfigs.list_configs()
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    for name in ALL:
        t, j = tconfigs.get_config(name), jconfigs.get_config(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
        assert dataclasses.asdict(tconfigs.get_reduced(name)) == \
            dataclasses.asdict(jconfigs.get_reduced(name)), name
        assert (t.attention_free, t.sub_quadratic) == (
            j.attention_free, j.sub_quadratic), name
        for shape in tconfigs.SHAPES:
            assert tconfigs.shape_applicable(t, tconfigs.SHAPES[shape]) == \
                jconfigs.shape_applicable(j, jconfigs.SHAPES[shape])
    import importlib

    for mod in ("pixtral_12b", "qwen2_5_14b", "tinyllama_1_1b",
                "qwen1_5_0_5b", "yi_9b"):
        t = importlib.import_module(f"repro_torch.configs.{mod}")
        j = importlib.import_module(f"repro.configs.{mod}")
        for n in (None, 8):
            args = () if n is None else (n,)
            assert dataclasses.asdict(t.upcycled(*args)) == \
                dataclasses.asdict(j.upcycled(*args)), mod
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("no-such-arch")


def _condition(vals, cfg):
    """Attention projections at fan-in d, as ``chip_smoke`` conditions
    every attention stack: at the reference's init (fan-in = the head
    count, ROADMAP.md queue 3) near-argmax attention turns summation
    order into 1e-4 logit differences."""
    vals = jax.tree.map(np.array, vals)
    H, Kh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    for seg in vals["stack"]["segments"]:
        for pos in seg.values():
            m = pos["mixer"]
            m["wq"] *= np.float32((H / d) ** 0.5)
            m["wk"] *= np.float32((Kh / d) ** 0.5)
            m["wv"] *= np.float32((Kh / d) ** 0.5)
    return vals


def _reference_loss(name, batch):
    """(the reference's loss on its own init and ``batch``, those
    weights as numpy)."""
    jcfg = jconfigs.get_reduced(name)
    vals = _np(jpm.split(jzoo.init_params(jax.random.PRNGKey(0), jcfg))[0])
    loss, _ = jax.jit(functools.partial(jzoo.loss_fn, cfg=jcfg, ac=JAC))(
        vals, jax.tree.map(jnp.asarray, batch))
    return float(loss), vals


@pytest.mark.parametrize("arch", ALL)
def test_smoke_forward_and_train_step(arch):
    """The port of the reference's smoke test: the reduced config's
    stream, a forward of the right shape with finite logits (MoE layers
    counted), one Adafactor step with a finite loss that moves the
    params. For the archs in NEW, the port's loss on the
    reference's weights and batch equals the reference's at rtol 2e-4."""
    cfg = tconfigs.get_reduced(arch)
    it = make_iterator(cfg, global_batch=4, seq_len=32, host_index=0,
                       host_count=1)
    batch = next(it)
    opt = adafactor(schedules.constant(1e-3))
    state = init_train_state(0, cfg, opt, device="cpu")
    tb = batch_to(batch, "cpu")
    logits, mets = zoo.forward_train(state["params"], tb, cfg)
    if cfg.structure == "encoder_only":
        assert logits.shape == (4, cfg.vocab_size)
    else:
        assert logits.shape == (4, batch["targets"].shape[1],
                                cfg.vocab_size)
        if cfg.moe is not None:
            assert float(mets["moe_layer_count"]) > 0
    assert bool(torch.isfinite(logits).all())
    before = [t.clone() for t in tree_leaves(state["params"])]
    state2, m = make_train_step(cfg, opt)(state, batch)
    assert np.isfinite(float(m["loss"])) and int(state2["step"]) == 1
    assert float((tree_leaves(state2["params"])[0] - before[0]).abs()
                 .max()) > 0
    if arch in NEW:
        jbatch = next(jmake_iterator(jconfigs.get_reduced(arch),
                                     global_batch=4, seq_len=32,
                                     host_index=0, host_count=1))
        assert sorted(jbatch) == sorted(batch)
        want, vals = _reference_loss(arch, jbatch)
        got, _ = zoo.loss_fn(from_jax_values(vals), batch_to(jbatch, "cpu"),
                             cfg)
        np.testing.assert_allclose(float(got), want, rtol=2e-4)


@pytest.mark.parametrize("hosts", [(0, 1), (1, 2)])
def test_pixtral_patch_stream_is_the_references(hosts):
    """The decoder-only patch stream: ``patch_embeds`` (B, min(P, S), d)
    float32 from Philox(task.seed + 7, step), bit-identical to the
    reference's at two steps, whole and as host 1 of 2, with the tokens;
    at a sequence shorter than the patches every position is a patch."""
    index, count = hosts
    for arch, seq in (("pixtral-12b", 32), ("pixtral-12b", 6)):
        cfg = tconfigs.get_reduced(arch)
        t = make_iterator(cfg, global_batch=4, seq_len=seq,
                          host_index=index, host_count=count)
        j = jmake_iterator(jconfigs.get_reduced(arch), global_batch=4,
                           seq_len=seq, host_index=index, host_count=count)
        for step in (0, 3):
            t.restore({"step": step})
            j.restore({"step": step})
            tb, jb = next(t), next(j)
            assert sorted(tb) == sorted(jb) == ["patch_embeds", "targets",
                                                "tokens"]
            for k in tb:
                assert tb[k].dtype == jb[k].dtype, k
                np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
            assert tb["patch_embeds"].shape == (
                4 // count, min(cfg.n_frontend_positions, seq), cfg.d_model)


def test_pixtral_forward_with_patches_and_its_upcycle():
    """pixtral's forward splices the frontend's projection of the
    patches over the first positions (logits at atol 1e-5 against the
    reference's, on attention-conditioned weights; the patches change
    the logits, the later positions see them); its ``upcycled()`` target
    upcycles with the reference's tree layout and its forward runs."""
    arch = "pixtral-12b"
    jcfg, cfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    jbatch = next(jmake_iterator(jcfg, global_batch=2, seq_len=16,
                                 host_index=0, host_count=1))
    w = jzoo.init_params(jax.random.PRNGKey(0), jcfg)
    vals, axes = jpm.split(w)
    vals = _condition(_np(vals), cfg)
    want, _ = jax.jit(functools.partial(jzoo.forward_train, cfg=jcfg,
                                        ac=JAC))(
        vals, jax.tree.map(jnp.asarray, jbatch))
    tvals = from_jax_values(vals)
    tb = batch_to(jbatch, "cpu")
    got, _ = zoo.forward_train(tvals, tb, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    bare, _ = zoo.forward_train(tvals, {k: v for k, v in tb.items()
                                        if k != "patch_embeds"}, cfg)
    n = cfg.n_frontend_positions
    assert float((bare[:, -1] - got[:, -1]).abs().max()) > 1e-3

    jmoe = dataclasses.replace(jcfg, moe=jconfigs.MoECfg(
        num_experts=4, router="top_k", group_size=64))
    tmoe = dataclasses.replace(cfg, moe=tconfigs.MoECfg(
        num_experts=4, router="top_k", group_size=64))
    jsparse = _np(jpm.split(jup.upcycle_params(jpm.wrap(vals, axes), jcfg,
                                               jmoe,
                                               jax.random.PRNGKey(7)))[0])
    tsparse = tup.upcycle_params(tvals, cfg, tmoe, 7)
    assert jax.tree.structure(jax.tree.map(np.shape, jsparse)) == \
        jax.tree.structure(jax.tree.map(lambda t: tuple(t.shape), tsparse))
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.shape, jsparse)),
                    jax.tree.leaves(jax.tree.map(lambda t: tuple(t.shape),
                                                 tsparse))):
        assert a == b
    logits, mets = zoo.forward_train(tsparse, tb, tmoe)
    assert bool(torch.isfinite(logits).all()) and n < logits.shape[1]
    assert float(mets["moe_layer_count"]) == cfg.n_layers // 2


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "pixtral-12b"])
def test_launch_train_on_new_archs(arch, tmp_path, capsys):
    from repro_torch.launch import train as launch

    launch.main(["--arch", arch, "--reduced", "--steps", "2", "--batch",
                 "2", "--seq", "16", "--device", "cpu", "--ckpt-dir",
                 str(tmp_path)])
    out = capsys.readouterr().out
    assert "[train] kernels: moe=eager attn=eager dispatch=gather" in out
    assert ("mamba=scan (plain ops, no kernel)" in out) == (
        arch.startswith("jamba"))
    assert "[train] finished at step 2" in out


@pytest.mark.parametrize("arch,paged", [("jamba-1.5-large-398b", False),
                                        ("qwen1.5-0.5b", True)])
def test_launch_serve_on_new_archs(arch, paged, capsys):
    from repro_torch.launch import serve as launch

    launch.main(["--arch", arch, "--reduced", "--device", "cpu",
                 "--max-new", "3"] + (["--paged"] if paged else []))
    out = capsys.readouterr().out
    assert f"mode={'chunked' if paged else 'static'}" in out
    assert "req2: [7, 7, 7, 7] -> [" in out
    if paged:
        assert "compile_count=1" in out
