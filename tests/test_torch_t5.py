"""Port parity for the paper's language model: t5-base-upcycled (T5 1.1
Base as an encoder-decoder, Expert Choice MoE layers in the encoder,
top-2 in the decoder) and whisper-base (frame frontend) at their reduced
configs, t5's also with the GEGLU of the full config (``gated_mlp``).

The span-corruption and frame streams, ``forward_train``/``loss_fn``
and their gradients, ``upcycle_params``/``upcycle_opt_state`` over both
stacks, dense -> upcycle -> MoE steps, ``prefill`` and ``decode_step``
with the encoder cache, the full config's parameter count, a T5 train
state through both packages' checkpoints, the launcher chain and the
serve engine's refusal. The reference runs its "xla" paths; inputs are
made with numpy from a seed and go through both packages; each
comparison states its tolerance."""
import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.checkpoint import store as jstore
from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.core import upcycle as jup
from repro.data import make_iterator as jmake_iterator
from repro.data import synthetic as jsyn
from repro.models import model_zoo as jzoo
from repro.models import param as jpm
from repro.models import stack as jstk
from repro.optim import adafactor as jadafactor
from repro.optim import schedules as jsched
from repro.training import train_loop as jtl
from repro_torch.checkpoint import store
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs import t5_upcycled as tt5
from repro_torch.configs import whisper_base as twhisper
from repro_torch.core import upcycle as tup
from repro_torch.data import ClusteredBigramTask, make_iterator
from repro_torch.data import synthetic as tsyn
from repro_torch.models import model_zoo as zoo
from repro_torch.models import stack as tstk
from repro_torch.models.convert import from_jax_values, to_jax_values
from repro_torch.models.param import count_params
from repro_torch.optim import adafactor, schedules
from repro_torch.training import init_train_state, make_train_step
from repro_torch.training.train_loop import batch_to, loss_and_grads
from torch_threads import one_thread  # noqa: F401 (autouse)

# The reference's registry loads its config modules only while it is
# empty: importing one module by name first would leave every other
# arch unregistered for the rest of the process. Fill it through the
# registry, then take the modules.
jconfigs.list_configs()
jt5 = sys.modules["repro.configs.t5_upcycled"]
jwhisper = sys.modules["repro.configs.whisper_base"]

T5, WHISPER = "t5-base-upcycled", "whisper-base"
# The reference's default dispatch on its CPU ("xla") paths; the port
# runs its plain versions on the CPU.
JAC = jzoo.ApplyCfg(dispatch="gather", moe_impl="xla", attn_impl="xla")
# 2 x 32 encoder tokens (one routing group of the reduced config's 64)
# and 2 x 8 decoder tokens (make_iterator's max(32 // 4, 8)).
B, S = 2, 32
# The reduced t5 as registered (ungated) and with the full config's
# GEGLU, each dense and upcycled; whisper-base's reduced config (dense).
# (Each t5 MoE tree keeps dense layers in every other position; the
# dense parents' forward runs in test_dense_upcycle_moe_steps_match_jax.)
CASES = [("t5", "moe"), ("t5-geglu", "moe"), ("whisper", "dense")]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(variant):
    """(jax cfg, torch cfg) of a variant."""
    arch = WHISPER if variant == "whisper" else T5
    j, t = jax_reduced(arch), get_reduced(arch)
    if variant == "t5-geglu":
        j = dataclasses.replace(j, gated_mlp=True)
        t = dataclasses.replace(t, gated_mlp=True)
    return j, t


def _condition(params, cfg):
    """The JAX init's attention projections rescaled to fan-in d (its
    fan-in rule takes the head count, which makes random models chaotic:
    ROADMAP.md queue 3), in the encoder's self-attention and in the
    decoder's self- and cross-attention (whose wk and wv read the
    encoder states, also at fan-in d), as
    ``chip_smoke.condition_attention`` does."""
    H, Kh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    scale = {"wq": (H / d) ** 0.5, "wk": (Kh / d) ** 0.5,
             "wv": (Kh / d) ** 0.5}
    out = jax.tree.map(np.array, params)
    for key in ("encoder", "stack"):
        for seg in out[key]["segments"]:
            for pos in seg.values():
                for attn in ("mixer", "cross"):
                    for k, c in scale.items():
                        if attn in pos:
                            pos[attn][k] = pos[attn][k] * np.float32(c)
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


def _close_after_steps(t, j, *, atol, rtol, peak):
    """Parameters after Adafactor steps, held at ``atol``/``rtol`` except
    where a step was Adafactor's first update of an unfactored leaf
    (dims under 128): there beta2 = 0 and the update is sign(g), a full
    step of ``peak`` x the leaf's RMS, also where g is f32 rounding noise
    (a cross-attention wk element of the ungated reduced T5 has a
    gradient 1e-6 of its leaf's largest, of opposite signs in the two
    packages, which hold that leaf's gradient to 3e-6). At most one
    element in 1,000 of a leaf may part so, by at most 2 x peak x the
    leaf's largest |value|."""
    ft, tt = jax.tree.flatten(to_jax_values(t))
    fj, tj = jax.tree.flatten(_np(j))
    assert tt == tj
    for a, b in zip(ft, fj):
        d = np.abs(a - b)
        off = d > atol + rtol * np.abs(b)
        assert off.mean() <= 1e-3, (off.sum(), a.shape)
        assert d.max() <= 2 * peak * np.abs(b).max(), (d.max(), a.shape)


def _dense_jax(jd):
    vals, _ = jpm.split(jzoo.init_params(jax.random.PRNGKey(0), jd))
    return _condition(vals, jd)


def _jax_upcycle(jd, jcfg, vals):
    _, axes = jpm.split(jzoo.init_params(jax.random.PRNGKey(0), jd))
    sw = jup.upcycle_params(jpm.wrap(vals, axes), jd, jcfg,
                            jax.random.PRNGKey(7))
    return jpm.split(sw)[0]


def _routers(sparse, cfg, which):
    """Per-layer router weights of one stack of a sparse values tree
    (None for dense layers), walking its segments in layer order."""
    key = "encoder" if which == "encoder" else "stack"
    out = []
    for si, (reps, pdescs) in enumerate(
            jstk.find_segments(jstk.layer_descs(cfg, stack=which))):
        seg = sparse[key]["segments"][si]
        for r in range(reps):
            for i in range(len(pdescs)):
                ffn = seg[f"pos{i}"]["ffn"]
                out.append(np.asarray(ffn["router"]["w"])[r]
                           if "router" in ffn else None)
    return out


def _upcycle_with_jax_routers(dense, td, tcfg, jsparse, jcfg):
    return tup.upcycle_params(
        dense, td, tcfg, routers=_routers(jsparse, jcfg, "decoder"),
        encoder_routers=_routers(jsparse, jcfg, "encoder"))


def _perturb_experts(vals, seed):
    """Freshly upcycled experts are copies of one MLP, so an Expert
    Choice router's gradient is rounding noise, which Adafactor's
    scale-free update turns into a framework-dependent step. The same
    small numpy noise on every expert of both stacks, in the one tree
    both frameworks start from, gives the routers a real gradient to
    hold."""
    vals = jax.tree.map(np.array, vals)
    rng = np.random.default_rng(seed)
    for key in ("encoder", "stack"):
        for seg in vals[key]["segments"]:
            for pos in seg.values():
                ex = pos["ffn"].get("experts")
                for k in ex or ():
                    ex[k] = (ex[k] + 0.05 * ex[k].std()
                             * rng.normal(size=ex[k].shape)).astype(
                                 np.float32)
    return vals


def _jax_batch(jcfg, step=0):
    it = jmake_iterator(jcfg, global_batch=B, seq_len=S, host_index=0,
                        host_count=1)
    it.restore({"step": step})
    return next(it)


def test_configs_and_descs_match_the_reference():
    """FULL, REDUCED, T5_BASE_DENSE, LANGUAGE_MOE, t5_large_upcycled()
    and whisper's FULL, REDUCED and upcycled() are the reference's field
    by field; the decoder's descs alternate (dense, cross) / (moe, cross)
    in one segment of 2 positions (the dense parent's: one of 1), the
    encoder's have no cross; the encoder routes by Expert Choice and the
    decoder by top-k."""
    pairs = [(jt5.FULL, tt5.FULL), (jt5.REDUCED, tt5.REDUCED),
             (jt5.T5_BASE_DENSE, tt5.T5_BASE_DENSE),
             (jt5.t5_large_upcycled(), tt5.t5_large_upcycled()),
             (jwhisper.FULL, twhisper.FULL),
             (jwhisper.REDUCED, twhisper.REDUCED),
             (jwhisper.upcycled(), twhisper.upcycled()),
             (jax_config(T5), get_config(T5)),
             (jax_config(WHISPER), get_config(WHISPER))]
    assert dataclasses.asdict(tt5.LANGUAGE_MOE) == dataclasses.asdict(
        jt5.LANGUAGE_MOE)
    for j, t in pairs:
        for f in dataclasses.fields(t):
            want, got = getattr(j, f.name), getattr(t, f.name)
            if f.name == "moe":
                assert (got is None) == (want is None)
                if got is not None:
                    assert dataclasses.asdict(got) == dataclasses.asdict(
                        want)
            elif f.name != "sharding_overrides":
                assert got == want, (t.name, f.name)
    assert not tt5.REDUCED.gated_mlp and tt5.FULL.gated_mlp
    for jc, tc in ((jax_config(T5), get_config(T5)),
                   (jax_config(T5).dense_parent(),
                    get_config(T5).dense_parent()),
                   (jax_reduced(T5), get_reduced(T5))):
        for which in ("encoder", "decoder"):
            t = tstk.layer_descs(tc, stack=which)
            j = jstk.layer_descs(jc, stack=which)
            assert [dataclasses.astuple(d) for d in t] == [
                dataclasses.astuple(d) for d in j]
            assert all(d.cross == (which == "decoder") for d in t)
            n = len(t)
            segs = [(r, len(p)) for r, p in tstk.find_segments(t)]
            assert segs == [(r, len(p)) for r, p in jstk.find_segments(j)]
            assert segs == ([(n // 2, 2)] if tc.moe else [(n, 1)])
            if tc.moe:
                assert [d.ffn for d in t] == ["dense", "moe"] * (n // 2)
    assert tstk.stack_router_kind(tt5.FULL, stack="encoder") == \
        "expert_choice"
    assert tstk.stack_router_kind(tt5.FULL, stack="decoder") == "top_k"


@pytest.mark.parametrize("arch", [T5, WHISPER])
def test_encdec_batches_identical(arch):
    """``make_iterator``'s span-corruption (T5) and frame (whisper)
    streams, bit for bit: encoder length ``seq_len``, decoder length
    ``max(seq_len // 4, 8)``. At T5's chip task (the first 2,048 ids)
    and encoder length 512 the sentinels sit at ids 2016..2047 and the
    decoder gets 128 positions."""
    jcfg, tcfg = jax_reduced(arch), get_reduced(arch)
    jit = jmake_iterator(jcfg, global_batch=3, seq_len=40, host_index=0,
                         host_count=1)
    tit = make_iterator(tcfg, global_batch=3, seq_len=40)
    want = (["dec_tokens", "frames", "targets"] if arch == WHISPER
            else ["dec_tokens", "enc_tokens", "targets"])
    for _ in range(3):
        jb, tb = next(jit), next(tit)
        assert sorted(jb) == sorted(tb) == want
        assert tb["dec_tokens"].shape == (3, 10)
        for k in jb:
            assert tb[k].dtype == jb[k].dtype
            np.testing.assert_array_equal(tb[k], jb[k])
    task = ClusteredBigramTask(vocab_size=2048)
    jtask = jsyn.ClusteredBigramTask(vocab_size=2048)
    if arch == T5:
        tb = tsyn.span_corruption_batch(task, 2, 512, 128, 3)
        jb = jsyn.span_corruption_batch(jtask, 2, 512, 128, 3)
        enc = tb["enc_tokens"]
        assert enc.shape == (2, 512) and tb["dec_tokens"].shape == (2, 128)
        # The decoder starts from token 0 and first predicts sentinel 0.
        assert (tb["dec_tokens"][:, 0] == 0).all()
        assert (tb["targets"][:, 0] == 2016).all()
        assert (tb["dec_tokens"][:, 1] == 2016).all()
        assert ((enc == 2016).sum(1) == 1).all()
    else:
        tb = tsyn.frame_batch(task, 2, 60, 15, 16, 3)
        jb = jsyn.frame_batch(jtask, 2, 60, 15, 16, 3)
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k])


def test_count_params_of_full_matches_the_reference():
    """2.003 B parameters for the MoE and 247.58 M for its dense parent
    (the paper's Table 1 "248M / 2.00B"), counted without allocating
    them: the port's init on the meta device, the reference's under
    ``jax.eval_shape``."""
    jcfg, tcfg = jax_config(T5), get_config(T5)
    got = []
    for jc, tc in ((jcfg, tcfg), (jcfg.dense_parent(), tcfg.dense_parent())):
        shapes = jax.eval_shape(
            lambda k, jc=jc: jpm.split(jzoo.init_params(k, jc))[0],
            jax.random.PRNGKey(0))
        want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
        got.append(count_params(zoo.init_params(None, tc, device="meta")))
        assert got[-1] == want
    assert got == [2_003_188_224, 247_577_088]
    p = zoo.init_params(None, tcfg, device="meta")
    assert list(p) == ["embed", "encoder", "enc_final_norm", "stack",
                       "final_norm", "head"]
    layer = p["stack"]["segments"][0]["pos1"]
    assert list(layer) == ["pre_norm", "mixer", "cross_norm", "cross",
                           "ffn_norm", "ffn"]
    assert layer["ffn"]["experts"]["wg"].shape == (6, 32, 768, 2048)


@pytest.mark.parametrize("variant,which", CASES)
def test_forward_and_loss_and_grads_match_jax(variant, which):
    """The encoder-decoder forward (the encoder bidirectional, Expert
    Choice in its MoE layers; the decoder causal with cross-attention,
    top-2 in its MoE layers; the gather dispatch): logits at atol 1e-5;
    loss and metrics (the encoder's added to the decoder's, so
    ``moe_layer_count`` counts both stacks) at rtol 2e-4; gradients
    against ``jax.value_and_grad`` at rtol 2e-4 of each leaf's largest
    entry, on attention-conditioned weights."""
    jcfg, tcfg = _cfgs(variant)
    jd, td = jcfg.dense_parent(), tcfg.dense_parent()
    vals = _dense_jax(jd if jcfg.moe else jcfg)
    if which == "dense":
        jc, tc = (jd, td) if jcfg.moe else (jcfg, tcfg)
    else:
        jc, tc = jcfg, tcfg
        vals = _perturb_experts(_jax_upcycle(jd, jcfg, vals), 4)
    batch = _jax_batch(jc)
    jb = jax.tree.map(jnp.asarray, batch)
    jlogits, _ = jax.jit(functools.partial(jzoo.forward_train, cfg=jc,
                                           ac=JAC))(vals, jb)
    tvals = from_jax_values(_np(vals))
    tb = batch_to(batch, "cpu")
    tlogits, tmets = zoo.forward_train(tvals, tb, tc)
    assert tlogits.shape == (B, max(S // 4, 8), tc.vocab_size)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=1e-5)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        functools.partial(jzoo.loss_fn, cfg=jc, ac=JAC), has_aux=True))(
            vals, jb)
    tg, tm = loss_and_grads(tvals, tb, tc)
    n_moe = tc.n_layers // 2 + tc.n_encoder_layers // 2
    assert float(tm["moe_layer_count"]) == float(jm["moe_layer_count"]) == (
        n_moe if which == "moe" else 0)
    if which == "moe":
        assert float(tm["aux_loss"]) > 0  # the decoder's top-2 aux loss
    for k in ("loss", "ce", "aux_loss", "z_loss", "dropped_frac_sum"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-4,
                                   atol=1e-7, err_msg=k)
    for t, j in zip(jax.tree.leaves(to_jax_values(tg)),
                    jax.tree.leaves(_np(jg))):
        np.testing.assert_allclose(t, j, rtol=2e-4,
                                   atol=2e-4 * np.abs(j).max())


@pytest.mark.parametrize("variant", ["t5", "t5-geglu"])
def test_upcycle_both_stacks_exact_with_jax_routers(variant):
    """``upcycle_params`` maps the encoder by the encoder's descs and
    the decoder stack by the decoder's (experts copied into every other
    layer of each, the JAX routers handed in) and ``upcycle_opt_state``
    carries both stacks' Adafactor slots (broadcast over the experts,
    routers' slots fresh, the step kept): both equal the reference's
    exactly. ``depth_tile`` tiles the decoder stack and copies the
    encoder, as the reference's does."""
    jcfg, tcfg = _cfgs(variant)
    jd, td = jcfg.dense_parent(), tcfg.dense_parent()
    dense = _dense_jax(jd)
    jsparse = _jax_upcycle(jd, jcfg, dense)
    for which in ("encoder", "decoder"):
        assert [r is None for r in _routers(jsparse, jcfg, which)] == [
            True, False, True, False]
    tsparse = _upcycle_with_jax_routers(from_jax_values(_np(dense)), td,
                                        tcfg, jsparse, jcfg)
    dense_t = from_jax_values(_np(dense))
    assert list(tsparse) == list(dense_t)  # the dense tree's key order
    _close_trees(tsparse, jsparse, atol=0, exact=True)
    drawn = tup.upcycle_params(from_jax_values(_np(dense)), td, tcfg, 3)
    for key in ("encoder", "stack"):
        w = drawn[key]["segments"][0]["pos1"]["ffn"]["router"]["w"]
        assert w.shape == (2, td.d_model, tcfg.moe.num_experts)
        assert abs(float(w.std()) - 0.02) < 0.006

    jopt = jadafactor(jsched.constant(0.01))
    topt = adafactor(schedules.constant(0.01))
    rng = np.random.default_rng(1)
    grads = jax.tree.map(
        lambda v: jnp.asarray(rng.normal(size=v.shape), jnp.float32), dense)
    _, jdense_state = jopt.update(grads, jopt.init(dense), dense)
    jout = jup.upcycle_opt_state(jopt.init(jsparse), jdense_state, jd, jcfg)
    tout = tup.upcycle_opt_state(
        topt.init(from_jax_values(_np(jsparse))),
        from_jax_values(_np(jdense_state)), td, tcfg)
    _close_trees(tout, jout, atol=0, exact=True)

    _, axes = jpm.split(jzoo.init_params(jax.random.PRNGKey(0), jd))
    jtiled, jtcfg = jup.depth_tile(jpm.wrap(dense, axes), jd, 2)
    ttiled, ttcfg = tup.depth_tile(from_jax_values(_np(dense)), td, 2)
    assert (ttcfg.n_layers, ttcfg.n_encoder_layers) == (
        jtcfg.n_layers, jtcfg.n_encoder_layers) == (8, 4)
    _close_trees(ttiled, jpm.split(jtiled)[0], atol=0, exact=True)


@pytest.mark.parametrize("variant", ["t5", "t5-geglu"])
def test_dense_upcycle_moe_steps_match_jax(variant):
    """The language recipe end to end at the reduced width: 2 dense
    Adafactor steps on the span-corruption stream, upcycle (JAX routers
    handed in, both stacks) with the optimizer state carried over and
    the step counter kept, 3 MoE steps (Expert Choice in the encoder,
    top-2 in the decoder, gather dispatch). The MoE steps start from one
    sparse tree whose experts carry the same small noise
    (_perturb_experts). Losses agree at rtol 2e-5 and gradient norms at
    rtol 2e-4, as on the granite and ViT paths; parameters at atol 1e-5,
    rtol 1e-4 after the dense steps and atol 1e-4, rtol 1e-3 after the
    MoE steps, but for Adafactor's sign(g) first steps
    (_close_after_steps)."""
    jcfg, tcfg = _cfgs(variant)
    jd, td = jcfg.dense_parent(), tcfg.dense_parent()
    opt_args = dict(peak=0.01, warmup_steps=2)
    jopt = jadafactor(jsched.inverse_sqrt(**opt_args))
    topt = adafactor(schedules.inverse_sqrt(**opt_args))
    js = jtl.init_train_state(jax.random.PRNGKey(0), jd, jopt)
    js["params"] = jax.tree.map(jnp.asarray, _condition(js["params"], jd))
    ts = from_jax_values(_np(js))
    jit = jmake_iterator(jd, global_batch=B, seq_len=S, host_index=0,
                         host_count=1)
    tit = make_iterator(td, global_batch=B, seq_len=S)
    jstep = jax.jit(jtl.make_train_step(jd, jopt, ac=JAC))
    tstep = make_train_step(td, topt)
    losses = []
    for _ in range(2):
        js, jm = jstep(js, next(jit))
        ts, tm = tstep(ts, next(tit))
        losses.append((float(tm["loss"]), float(jm["loss"])))
    _close_after_steps(ts["params"], js["params"], atol=1e-5, rtol=1e-4,
                       peak=opt_args["peak"])

    jsparse = _jax_upcycle(jd, jcfg, js["params"])
    tsparse = _upcycle_with_jax_routers(ts["params"], td, tcfg, jsparse,
                                        jcfg)
    _close_after_steps(tsparse, jsparse, atol=1e-5, rtol=1e-4,
                       peak=opt_args["peak"])
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
        assert float(tm["moe_layer_count"]) == 4.0
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=2e-4)
    t, j = np.array(losses).T
    np.testing.assert_allclose(t, j, rtol=2e-5)
    assert int(ts2["step"]) == int(js2["step"]) == 5
    _close_after_steps(ts2["params"], js2["params"], atol=1e-4, rtol=1e-3,
                       peak=opt_args["peak"])


@pytest.mark.parametrize("variant,which", CASES)
def test_prefill_and_decode_match_jax(variant, which):
    """The reference's encoder-decoder serving pattern: ``prefill``
    encodes the encoder input into ``cache["enc"]`` and runs the decoder
    prompt; each ``decode_step`` reads the cache (the decoder's self
    k/v and the encoder states, its cross-attention's single query
    through the flash path). Logits at atol 1e-5 over the prefill and 4
    greedy steps; the greedy tokens identical."""
    jcfg, tcfg = _cfgs(variant)
    vals = _dense_jax(jcfg.dense_parent() if jcfg.moe else jcfg)
    if which == "dense":
        jc, tc = ((jcfg.dense_parent(), tcfg.dense_parent()) if jcfg.moe
                  else (jcfg, tcfg))
    else:
        jc, tc = jcfg, tcfg
        vals = _perturb_experts(
            _jax_upcycle(jcfg.dense_parent(), jcfg, vals), 5)
    batch = _jax_batch(jc, step=2)
    plen, new = 4, 4
    batch["dec_tokens"] = batch["dec_tokens"][:, :plen]
    batch.pop("targets")
    enc_len = S
    jcache = jzoo.init_serve_cache(jc, B, plen + new, dtype=jnp.float32,
                                   enc_len=enc_len)
    jcache, jl = jzoo.prefill(vals, jax.tree.map(jnp.asarray, batch),
                              jcache, jc, ac=JAC)
    tvals = from_jax_values(_np(vals))
    tcache = zoo.init_serve_cache(tc, B, plen + new, dtype=torch.float32,
                                  device="cpu", enc_len=enc_len)
    tcache, tl = zoo.prefill(tvals, batch_to(batch, "cpu"), tcache, tc)
    np.testing.assert_allclose(to_jax_values(tcache["enc"]),
                               np.asarray(jcache["enc"]), atol=1e-5)
    toks = []
    for i in range(new):
        assert tl.shape == (B, 1, tc.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                                   rtol=1e-5, err_msg=f"step {i}")
        jt = np.asarray(jnp.argmax(jl[:, -1], -1))
        tt = tl[:, -1].argmax(-1).numpy()
        np.testing.assert_array_equal(tt, jt)
        toks.append(tt)
        if i == new - 1:
            break
        jcache, jl = jzoo.decode_step(
            vals, jnp.asarray(jt[:, None]), jcache,
            jnp.asarray(plen + i, jnp.int32), jc, ac=JAC)
        tcache, tl = zoo.decode_step(tvals, torch.from_numpy(tt[:, None]),
                                     tcache, plen + i, tc)
    assert np.array(toks).shape == (new, B)


def test_condition_attention_walks_encoder_and_cross():
    """``chip_smoke.condition_attention`` rescales the encoder's
    self-attention and the decoder's self- and cross-attention
    projections (wq, wk, wv; not wo) as the tests' ``_condition`` does;
    a decoder-only or encoder-only tree keeps its old treatment (only
    ``stack``'s mixers)."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
    import chip_smoke

    jcfg, tcfg = _cfgs("t5")
    raw, _ = jpm.split(jzoo.init_params(jax.random.PRNGKey(0), jcfg))
    p = from_jax_values(_np(raw))
    chip_smoke.condition_attention(p, tcfg)
    _close_trees(p, _condition(raw, jcfg), atol=0, exact=True)
    assert torch.equal(p["stack"]["segments"][0]["pos0"]["cross"]["wo"],
                       torch.from_numpy(np.array(
                           raw["stack"]["segments"][0]["pos0"]["cross"]
                           ["wo"])))
    vit = get_reduced("vit-b16-upcycled")
    q = zoo.init_params(0, vit, device="cpu")
    want = q["stack"]["segments"][0]["pos0"]["mixer"]["wq"] * (
        (vit.n_heads / vit.d_model) ** 0.5)
    chip_smoke.condition_attention(q, vit)
    assert torch.equal(q["stack"]["segments"][0]["pos0"]["mixer"]["wq"],
                       want)


def test_get_config_after_a_config_module_alone():
    """Importing one config module on its own registers its arch; the
    registry still loads the others on the next lookup. The reference's
    ``_load_all`` returns once anything is registered, so there the
    lookup raises (ROADMAP.md queue 3); the port does not copy that."""
    import subprocess

    code = ("from {p}.configs import whisper_base\n"
            "from {p}.configs import get_config\n"
            "print(get_config('t5-base-upcycled').d_model)")
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), os.pardir, "src"))
    run = lambda p: subprocess.run(  # noqa: E731
        [sys.executable, "-c", code.format(p=p)], env=env,
        capture_output=True, text=True)
    port, ref = run("repro_torch"), run("repro")
    assert port.returncode == 0 and port.stdout.strip() == "768"
    assert ref.returncode != 0 and "KeyError" in ref.stderr


def _path_bits(pairs):
    out = {}
    for path, leaf in pairs:
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        out[path] = np.asarray(leaf)
    return out


def test_t5_train_state_checkpoints_cross_both_ways(tmp_path):
    """A reduced T5 MoE train state (params, Adafactor slots of both
    stacks, step counters) saved by the port and restored by the
    reference, and the other way, bit for bit by key path. The port's
    tree is built in insertion order (``embed``, ``encoder``,
    ``enc_final_norm``, ``stack``, ...), the files in sorted-key order
    (``enc_final_norm`` < ``encoder`` < ... < ``stack``)."""
    jcfg, tcfg = _cfgs("t5-geglu")
    jopt = jadafactor(jsched.inverse_sqrt(peak=0.01, warmup_steps=2))
    topt = adafactor(schedules.inverse_sqrt(peak=0.01, warmup_steps=2))
    js = _np(jtl.init_train_state(jax.random.PRNGKey(0), jcfg, jopt))
    ts = init_train_state(3, tcfg, topt, device="cpu")
    assert list(ts["params"]) == ["embed", "encoder", "enc_final_norm",
                                  "stack", "final_norm", "head"]
    flat = store._flatten(ts)
    assert [p for p, _ in flat] == [
        jax.tree_util.keystr(p)
        for p, _ in jax.tree_util.tree_flatten_with_path(js)[0]]

    p = str(tmp_path / "port")
    store.save_tree(p, ts, metadata={"step": 3})
    back = jstore.load_tree(p, js)
    want = _path_bits(flat)
    got = _path_bits((jax.tree_util.keystr(k), v) for k, v in
                     jax.tree_util.tree_flatten_with_path(back)[0])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    p = str(tmp_path / "ref")
    jstore.save_tree(p, js, metadata={"step": 3})
    out = store.load_tree(p, ts)
    assert list(out["params"]) == list(ts["params"])
    want = _path_bits((jax.tree_util.keystr(k), v) for k, v in
                      jax.tree_util.tree_flatten_with_path(js)[0])
    got = _path_bits(store._flatten(out))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_launch_train_t5_chain_on_cpu(capsys, tmp_path):
    """``launch.train --arch t5-base-upcycled --reduced``: the dense
    parent's Trainer checkpoints, ``upcycle_from`` restores it and
    upcycles both stacks, and ``main --upcycle-from`` trains the MoE;
    whisper-base trains too."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train
    from repro_torch.optim import inverse_sqrt
    from repro_torch.training import TrainConfig, Trainer

    cfg = get_reduced(T5)
    dense_dir = tmp_path / "dense"
    it = make_iterator(cfg.dense_parent(), global_batch=2, seq_len=16)
    tr = Trainer(cfg.dense_parent(),
                 adafactor(inverse_sqrt(peak=0.01, warmup_steps=2)), it,
                 str(dense_dir), tc=TrainConfig(checkpoint_every=2,
                                                log_every=1000),
                 device="cpu")
    out = tr.run(2)
    assert CheckpointManager(str(dense_dir)).latest_step() == 2
    dense, sparse, step = train.upcycle_from(str(dense_dir), cfg,
                                             device="cpu")
    assert step == 2
    for a, b in zip(jax.tree.leaves(to_jax_values(dense)),
                    jax.tree.leaves(to_jax_values(out["state"]["params"]))):
        np.testing.assert_array_equal(a, b)
    assert "router" in sparse["encoder"]["segments"][0]["pos1"]["ffn"]
    assert "router" in sparse["stack"]["segments"][0]["pos1"]["ffn"]
    capsys.readouterr()
    train.main(["--arch", T5, "--reduced", "--upcycle-from",
                str(dense_dir), "--ckpt-dir", str(tmp_path / "moe"),
                "--steps", "2", "--batch", "2", "--seq", "16", "--device",
                "cpu"])
    text = capsys.readouterr().out
    assert f"[train] upcycled from {dense_dir} @ step 2" in text
    assert "[train] kernels: moe=eager attn=eager dispatch=gather" in text
    last = text.strip().splitlines()[-1]
    assert last.startswith("[train] finished at step 2, loss")
    assert np.isfinite(float(last.rsplit(" ", 1)[1]))
    train.main(["--arch", WHISPER, "--reduced", "--steps", "2", "--batch",
                "2", "--seq", "16", "--device", "cpu", "--ckpt-dir",
                str(tmp_path / "whisper")])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("[train] finished at step 2, loss")


@pytest.mark.parametrize("paged", [False, True])
def test_serve_engine_refuses_encoder_decoder(paged):
    """Neither engine serves the family (neither of the reference's
    does): a NotImplementedError that names it, static or paged; the
    paged cache refuses it as the reference's does."""
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = get_reduced(T5)
    params = zoo.init_params(0, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        ServeEngine(params, cfg, ServeConfig(paged=paged), device="cpu")
    with pytest.raises(ValueError, match="decoder_only"):
        zoo.init_paged_serve_cache(cfg, 4, 16, device="cpu")


def test_profile_step_traces_a_t5_train_step_on_cpu(capsys):
    """``launch/profile_step.py --train --arch t5-base-upcycled`` (the
    source of PERF.md's T5 step trace): on the CPU it counts the step's
    host ops and leaves every device number null."""
    import json

    from repro_torch.launch import profile_step

    profile_step.main(["--train", "--arch", T5, "--reduced", "--device",
                       "cpu", "--steps", "1", "--batch", "2", "--seq",
                       "32"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["step"] == "train" and out["arch"] == T5
    assert out["dispatch"] == "gather" and out["batch"] == 2
    assert out["wall_ms"] > 0 and out["host_ops_per_layer"] > 20
    assert all(out[k] is None for k in ("device_kernels", "device_busy_ms",
                                        "idle_share", "kernels", "top"))
