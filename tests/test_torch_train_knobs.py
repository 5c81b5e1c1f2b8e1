"""Port parity for the training knobs of ``ApplyCfg``: remat, the
chunked cross-entropy and the bfloat16 compute dtype of
``repro_torch`` against the JAX package, at reduced granite (sorted
dispatch) and the reduced ViT (Expert Choice, gather dispatch), float32
unless a test says otherwise; and the training launcher's new flags, on
granite and on rwkv6.

The JAX model runs its "xla" paths (the bfloat16 test: its "ref" expert
FFN, see there); the port its plain versions on the CPU. Inputs come
from the JAX init (seed 0, attention conditioned to fan-in d) and the
reference's data stream.
"""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.data import make_iterator as jmake_iterator
from repro.models import model_zoo as jzoo
from repro.models import param as jpm
from repro_torch.configs import get_reduced
from repro_torch.data import make_iterator
from repro_torch.models import model_zoo as zoo
from repro_torch.models.convert import from_jax_values, to_jax_values
from repro_torch.training.train_loop import batch_to, loss_and_grads
from torch_threads import one_thread  # noqa: F401 (autouse)

GRANITE, VIT = "granite-moe-1b-a400m", "vit-b16-upcycled"
JAC = {GRANITE: dict(dispatch="sorted", sorted_block=8, moe_impl="xla",
                     attn_impl="xla"),
       VIT: dict(dispatch="gather", moe_impl="xla", attn_impl="xla")}
TAC = {GRANITE: dict(dispatch="sorted"), VIT: dict(dispatch="gather")}
# 4 x 16 tokens: one routing group of the reduced granite's 64.
B, S = 4, 16


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _init(jcfg):
    """The JAX init's values (seed 0), traced once: eager it dispatches
    thousands of small ops."""
    return _np(jax.jit(lambda k: jpm.split(jzoo.init_params(k, jcfg))[0])(
        jax.random.PRNGKey(0)))


def _condition(params, cfg):
    """Attention projections rescaled to fan-in d (the reference's
    fan-in rule makes random models chaotic: ROADMAP.md queue 3)."""
    H, Kh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    scale = {"wq": (H / d) ** 0.5, "wk": (Kh / d) ** 0.5,
             "wv": (Kh / d) ** 0.5}
    out = jax.tree.map(np.array, params)
    for seg in out["stack"]["segments"]:
        for pos in seg.values():
            for k, c in scale.items():
                pos["mixer"][k] = pos["mixer"][k] * np.float32(c)
    return out


def _setup(arch):
    jcfg, tcfg = jax_reduced(arch), get_reduced(arch)
    vals = _init(jcfg)
    it = jmake_iterator(jcfg, global_batch=B, seq_len=S, host_index=0,
                        host_count=1)
    return jcfg, tcfg, _condition(vals, jcfg), next(it)


@pytest.fixture(scope="module")
def models():
    """arch -> (JAX cfg, port cfg, conditioned initial params (numpy), a
    batch of the reference's stream)."""
    return {arch: _setup(arch) for arch in (GRANITE, VIT)}


def _jax_loss_grads(jcfg, vals, batch, **ac):
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jzoo.loss_fn(p, b, jcfg, ac=jzoo.ApplyCfg(**ac)),
        has_aux=True))
    (_, mets), grads = fn(jax.tree.map(jnp.asarray, vals),
                          jax.tree.map(jnp.asarray, batch))
    return {k: float(v) for k, v in mets.items()}, _np(grads)


def _port_loss_grads(tcfg, vals, batch, **ac):
    grads, mets = loss_and_grads(from_jax_values(_np(vals)),
                                 batch_to(batch, "cpu"), tcfg,
                                 ac=zoo.ApplyCfg(**ac))
    return {k: float(v) for k, v in mets.items()}, to_jax_values(grads)


def _grads_close(t, j, rtol):
    """Each leaf within rtol of its largest entry (f32 summation order
    through the stack; entries near zero held to the same absolute
    bound)."""
    for a, b in zip(jax.tree.leaves(t), jax.tree.leaves(j)):
        np.testing.assert_allclose(a, b, rtol=rtol,
                                   atol=rtol * np.abs(b).max())


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def no_remat(models):
    """arch -> the port's metrics and gradients without remat."""
    return {arch: _port_loss_grads(tcfg, vals, batch, **TAC[arch])
            for arch, (_, tcfg, vals, batch) in models.items()}


@pytest.mark.parametrize("arch", [GRANITE, VIT])
@pytest.mark.parametrize("remat", ["full", "dots", "moe"])
def test_remat_matches_no_remat(models, no_remat, arch, remat):
    """Each policy against no remat: loss, every metric and every
    gradient bit-identical on the CPU (the body's recompute repeats its
    forward exactly; nothing in the step draws random numbers, so the
    checkpoint's RNG bookkeeping cannot part them). The ViT's body is
    its one 12-layer (here 4-layer) segment, as in the reference."""
    _, tcfg, vals, batch = models[arch]
    m0, g0 = no_remat[arch]
    m, g = _port_loss_grads(tcfg, vals, batch, remat=remat, **TAC[arch])
    assert m == m0
    for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(g0)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch,remat", [(GRANITE, "full"), (GRANITE, "dots"),
                                        (GRANITE, "moe"), (VIT, "full")])
def test_remat_matches_the_reference(models, arch, remat):
    """Against the reference's same policy: the metrics at rtol 2e-5,
    the gradients at 2e-4 of each leaf's largest entry, the step
    parity's tolerances."""
    jcfg, tcfg, vals, batch = models[arch]
    m, g = _port_loss_grads(tcfg, vals, batch, remat=remat, **TAC[arch])
    jm, jg = _jax_loss_grads(jcfg, vals, batch, remat=remat, **JAC[arch])
    for k in ("loss", "ce", "aux_loss", "z_loss", "moe_layer_count"):
        np.testing.assert_allclose(m[k], jm[k], rtol=2e-5, err_msg=k)
    _grads_close(g, jg, 2e-4)


@pytest.mark.parametrize("remat", ["none", "full", "dots", "moe"])
def test_remat_recomputes_each_forward_once(models, monkeypatch, remat):
    """The launches chip_smoke.py holds on the card, counted on the
    plain versions (each CUDA wrapper launches once where its plain
    version is called once): no policy can save the attention and
    expert FFN's outputs (autograd Functions over kernel calls, which a
    selective policy does not see), so under every policy the forward of
    each layer runs twice and its backward once."""
    from repro_torch.kernels import ref

    calls = collections.Counter()
    for name in ("flash_attention_ref", "flash_attention_bwd_ref",
                 "grouped_mlp_ref", "grouped_mlp_bwd_ref"):
        def counted(*a, _fn=getattr(ref, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(ref, name, counted)
    _, tcfg, vals, batch = models[GRANITE]
    _port_loss_grads(tcfg, vals, batch, remat=remat, **TAC[GRANITE])
    L = tcfg.n_layers
    fwd = L if remat == "none" else 2 * L
    assert calls == {"flash_attention_ref": fwd, "grouped_mlp_ref": fwd,
                     "flash_attention_bwd_ref": L, "grouped_mlp_bwd_ref": L}


def test_unknown_remat_raises(models):
    _, tcfg, vals, batch = models[GRANITE]
    with pytest.raises(ValueError, match="unknown remat"):
        _port_loss_grads(tcfg, vals, batch, remat="some", **TAC[GRANITE])


# ---------------------------------------------------------------------------
# the chunked cross-entropy
# ---------------------------------------------------------------------------


def _masked(batch):
    batch = {k: v.copy() for k, v in batch.items()}
    batch["targets"][0, :5] = -1
    batch["targets"][1, -2:] = -1
    return batch


def test_chunked_ce_matches_the_reference(models):
    """ce_chunk 3 (S = 16: a ragged last chunk of 1, padded with masked
    targets) against the reference's, with masked targets in the batch:
    metrics at rtol 2e-5, gradients at 2e-4."""
    jcfg, tcfg, vals, batch = models[GRANITE]
    batch = _masked(batch)
    m, g = _port_loss_grads(tcfg, vals, batch, ce_chunk=3, **TAC[GRANITE])
    jm, jg = _jax_loss_grads(jcfg, vals, batch, ce_chunk=3, **JAC[GRANITE])
    for k in ("loss", "ce"):
        np.testing.assert_allclose(m[k], jm[k], rtol=2e-5, err_msg=k)
    _grads_close(g, jg, 2e-4)


@pytest.mark.parametrize("chunk", [3, 5, S, 4 * S])
def test_chunked_ce_matches_the_whole_logits(models, chunk):
    """ce_chunk 3 and 5 (ragged last chunks), S (one chunk) and beyond S
    (min(chunk, S)) against the whole logits (ce_chunk 0): metrics at
    rtol 2e-5, gradients at 2e-4 (the sum's order differs)."""
    _, tcfg, vals, batch = models[GRANITE]
    batch = _masked(batch)
    m, g = _port_loss_grads(tcfg, vals, batch, ce_chunk=chunk,
                            **TAC[GRANITE])
    m0, g0 = _port_loss_grads(tcfg, vals, batch, **TAC[GRANITE])
    for k in ("loss", "ce"):
        np.testing.assert_allclose(m[k], m0[k], rtol=2e-5, err_msg=k)
    _grads_close(g, g0, 2e-4)


# ---------------------------------------------------------------------------
# bfloat16 compute
# ---------------------------------------------------------------------------

# Against the reference's bfloat16 loss and gradients with its "ref"
# expert FFN, whose hidden stays float32 as the port's plain versions'
# (and kernels') do; its "xla" FFN rounds the hidden to bfloat16. Two
# bfloat16 implementations round the same sites but not bit for bit:
# XLA fuses and contracts elementwise ops under jit and rounds its
# bfloat16 sigmoid at every op, and a flipped rounding can flip a
# routing choice. So they part about as far as the reference's own
# bfloat16 step parts from its float32 one (measured over 3 batches at
# S 16 and 32, granite dense and MoE: loss 2.5e-7 to 6.6e-5 apart,
# float32 2.9e-6 to 2.1e-4 away; gradient norms to 4.2e-3, float32 to
# 6.1e-3; the ViT's loss over 4 images to 8.8e-4, its gradient norm to
# 1.1e-3). These limits hold the bfloat16 path to that scale, ~3x the
# largest distance measured. A skipped cast site mostly raises (torch
# refuses a bfloat16 x float32 matmul, where JAX promotes); the logits'
# float32 cast, whose skip runs the CE in bfloat16, moves the granite
# loss 1.1e-3 and fails here (CHANGES.md); test_bfloat16_compute_dtypes
# holds the dtype at each stage.
BF16_LOSS_RTOL = {GRANITE: 2e-4, VIT: 3e-3}
BF16_GRAD_NORM_RTOL = {GRANITE: 1e-2, VIT: 3e-3}


@pytest.mark.parametrize("arch,ce_chunk", [(GRANITE, 0), (GRANITE, 8),
                                           (VIT, 0)])
def test_bfloat16_compute_matches_the_reference(models, arch, ce_chunk):
    jcfg, tcfg, vals, batch = models[arch]
    jac = dict(JAC[arch], moe_impl="ref")
    m, g = _port_loss_grads(tcfg, vals, batch, compute_dtype="bfloat16",
                            ce_chunk=ce_chunk, **TAC[arch])
    jm, jg = _jax_loss_grads(jcfg, vals, batch, compute_dtype="bfloat16",
                             ce_chunk=ce_chunk, **jac)
    np.testing.assert_allclose(m["loss"], jm["loss"],
                               rtol=BF16_LOSS_RTOL[arch])
    gn = np.sqrt(sum(np.sum(np.square(x.astype(np.float64)))
                     for x in jax.tree.leaves(g)))
    jgn = np.sqrt(sum(np.sum(np.square(x.astype(np.float64)))
                      for x in jax.tree.leaves(jg)))
    np.testing.assert_allclose(gn, jgn, rtol=BF16_GRAD_NORM_RTOL[arch])
    # The gradients reach the float32 masters through the cast.
    assert all(x.dtype == np.float32 for x in jax.tree.leaves(g))


def test_bfloat16_compute_dtypes(monkeypatch):
    """The hidden states run in bfloat16, the logits and the loss in
    float32; the chunked CE gets a bfloat16 hidden and weight (the
    reference's cast of the CE weight, which its float32 logits would
    not show); float32 compute uses the params as they are (no copy)."""
    tcfg = get_reduced(GRANITE)
    params = zoo.init_params(0, tcfg, device="cpu")
    batch = batch_to(next(make_iterator(tcfg, global_batch=2, seq_len=8)),
                     "cpu")
    ac = zoo.ApplyCfg(compute_dtype="bfloat16")
    h, _ = zoo.forward_train(params, batch, tcfg, ac=ac, return_hidden=True)
    logits, _ = zoo.forward_train(params, batch, tcfg, ac=ac)
    loss, _ = zoo.loss_fn(params, batch, tcfg, ac=ac)
    assert (h.dtype, logits.dtype, loss.dtype) == (
        torch.bfloat16, torch.float32, torch.float32)
    seen = []
    chunked = zoo._chunked_ce
    monkeypatch.setattr(zoo, "_chunked_ce", lambda hid, w, t, c: (
        seen.append((hid.dtype, w.dtype)), chunked(hid, w, t, c))[1])
    loss, _ = zoo.loss_fn(params, batch, tcfg, ac=dataclasses.replace(
        ac, ce_chunk=3))
    assert seen == [(torch.bfloat16, torch.bfloat16)]
    assert loss.dtype == torch.float32
    same = zoo._cast_params(params, torch.float32)
    assert all(a is b for a, b in zip(jax.tree.leaves(same),
                                      jax.tree.leaves(params)))
    with pytest.raises(ValueError, match="unknown compute_dtype"):
        zoo.forward_train(params, batch, tcfg,
                          ac=zoo.ApplyCfg(compute_dtype="float16"))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,flags,line", [
    (GRANITE, ["--grad-accum", "2", "--compression", "int8", "--remat",
               "moe", "--dispatch", "sorted", "--ep", "none"],
     "dispatch=sorted mixer=eager remat=moe device=cpu"),
    ("rwkv6-7b", ["--remat", "full", "--compression", "bf16"],
     "dispatch=gather mixer=eager remat=full device=cpu"),
])
def test_launch_train_takes_the_training_flags(capsys, tmp_path, arch,
                                               flags, line):
    """``launch.train.main`` with the reference's flags on the CPU,
    through the Trainer; an rwkv6 stack trains through the eager
    (chunked) WKV, the reference launcher's path, printed on the kernels
    line."""
    from repro_torch.launch import train

    train.main(["--arch", arch, "--reduced", "--steps", "2", "--batch", "2",
                "--seq", "8", "--device", "cpu",
                "--ckpt-dir", str(tmp_path / "run"), *flags])
    out = capsys.readouterr().out
    assert f"[train] kernels: moe=eager attn=eager {line}" in out
    assert "[train] finished at step 2, loss" in out
    assert "nan" not in out.split("[train] finished")[1]


def test_launch_train_refuses_expert_parallelism(capsys, tmp_path):
    """The launcher refuses an expert-parallel layout it does not know;
    ``--ep a2a`` in one process has no mesh to run over and trains the
    single-device path (the multi-process runs:
    tests/test_torch_dist_train.py, tests/test_torch_dist_ckpt.py)."""
    from repro_torch.launch import train

    with pytest.raises(SystemExit):
        train.parse_args(["--arch", GRANITE, "--ep", "all2all"])
    assert "invalid choice" in capsys.readouterr().err
    train.main(["--arch", GRANITE, "--reduced", "--device", "cpu",
                "--steps", "1", "--batch", "2", "--seq", "8",
                "--dispatch", "sorted", "--ep", "a2a",
                "--ckpt-dir", str(tmp_path / "run")])
    out = capsys.readouterr().out
    assert "ranks=" not in out
    assert "[train] finished at step 1, loss" in out


def test_launcher_apply_cfg_pins_the_eager_mixer():
    """On the card the launcher's ApplyCfg runs attention and the experts
    through the kernels and the WKV mixer through autograd of the chunked
    version (the kernel has no backward)."""
    from repro_torch.launch import train

    ac = train.apply_cfg(train.parse_args(["--arch", "rwkv6-7b",
                                           "--remat", "dots"]), "cuda")
    assert (ac.moe_impl, ac.attn_impl, ac.mixer_impl, ac.remat) == (
        "cuda", "cuda", "eager", "dots")
    assert dataclasses.replace(ac, mixer_impl="auto").resolve(
        "cuda").mixer_impl == "cuda"
