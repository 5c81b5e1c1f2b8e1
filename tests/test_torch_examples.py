"""The port's four examples (``examples/torch_*.py``) against the
reference's (``examples/*.py``) on the CPU, at constants and flags cut
by this test (set on both modules, never by editing a file), with the
same seeds.

The port draws its random weights with ``torch.Generator`` where the
reference draws them from a ``PRNGKey``, so the test hands both the
reference's draws: the port's ``init_train_state`` / ``init_params``
take the reference's init at ``PRNGKey(0)`` (converted) and its
``upcycle_params`` the routers the reference's upcycle draws from its
key (the experts are copies either way). The attention projections of
the training examples' dense init are rescaled to fan-in d in both
(the reference's fan-in rule takes the head count, which makes a
random model chaotic under Adafactor's first sign-like steps: ROADMAP
queue 3), as ``tests/test_torch_train.py`` conditions them.

* quickstart (2 dense steps, 3 more of each): the three printed CEs
  within rtol 2e-5 of the reference's, the tolerance
  ``tests/test_torch_train.py`` holds the losses of a few Adafactor
  steps to;
* ablation (2 dense steps): the dense CE and the (capacity x renorm)
  grid of step-0 CEs within rtol 2e-5;
* serve_moe: the printed greedy lines token-identical, static and
  ``--paged`` (the paged lines' arrival, admission and finish ticks and
  prefix hits too);
* train_upcycled_100m at a cut ``SLIM``: a run preempted at step 4 and
  rerun resumes to the same loss, bit for bit, as an uninterrupted one,
  within rtol 2e-5 of the reference's.

Without a card and without ``--device cpu`` each example raises.
"""
import builtins
import dataclasses
import importlib.util
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro_torch.models.convert import from_jax_values, to_jax_values
from torch_threads import one_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 2e-5
NAMES = ("quickstart", "ablation_initial_drop", "train_upcycled_100m",
         "serve_moe")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def pair():
    """(the reference example, the port's) of a name, freshly loaded."""
    return lambda name: (_load(name), _load(f"torch_{name}"))


def _condition(values, cfg):
    """The reference init's attention projections rescaled to fan-in d
    (numpy values tree, in place)."""
    H, Kh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    for seg in values["stack"]["segments"]:
        for pos in seg.values():
            m = pos["mixer"]
            if "wq" in m:
                m["wq"] = m["wq"] * np.float32((H / d) ** 0.5)
                m["wk"] = m["wk"] * np.float32((Kh / d) ** 0.5)
                m["wv"] = m["wv"] * np.float32((Kh / d) ** 0.5)
    return values


def _jax_dense(jcfg, *, condition=True):
    """The reference's init of ``jcfg`` (its ArchConfig) at PRNGKey(0)
    as a numpy values tree."""
    from repro.models import model_zoo as jzoo
    from repro.models import param as jpm

    vals, _ = jpm.split(jzoo.init_params(jax.random.PRNGKey(0), jcfg))
    vals = jax.tree.map(np.array, vals)
    return _condition(vals, jcfg) if condition else vals


def _jax_cfg(cfg):
    """The reference's ArchConfig with ``cfg``'s fields."""
    from repro.configs import ArchConfig as JArch
    from repro.configs import MoECfg as JMoE

    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if cfg.moe is not None:
        kw["moe"] = JMoE(**{f.name: getattr(cfg.moe, f.name)
                            for f in dataclasses.fields(cfg.moe)})
    return JArch(**kw)


def _jax_routers(dense, dense_cfg, target_cfg, seed):
    """The routers the reference's upcycle draws from PRNGKey(seed),
    one per layer of the port's stack (None for a dense layer)."""
    from repro.core import upcycle as jup
    from repro.models import model_zoo as jzoo
    from repro.models import param as jpm
    from repro_torch.core.upcycle import _unstack
    from repro_torch.models import stack as stk

    jd, jt = _jax_cfg(dense_cfg), _jax_cfg(target_cfg)
    _, axes = jpm.split(jax.eval_shape(
        lambda: jzoo.init_params(jax.random.PRNGKey(0), jd)))
    sw = jup.upcycle_params(jpm.wrap(to_jax_values(dense), axes), jd, jt,
                            jax.random.PRNGKey(seed))
    sparse = from_jax_values(jax.tree.map(np.array, jpm.split(sw)[0]))
    layers = _unstack(sparse["stack"], stk.layer_descs(target_cfg))
    return [lay["ffn"]["router"]["w"] if "router" in lay["ffn"] else None
            for lay in layers]


def _inject_training(monkeypatch, ref, port, seed):
    """The reference's dense init (conditioned) in both modules' fresh
    train states; in the port's upcycle the routers the reference's
    draws from PRNGKey(``seed``)."""
    from repro_torch.training import init_train_state

    real_j = ref.init_train_state

    def jinit(rng, cfg, opt, **kw):
        if kw.get("params") is None:
            kw["params"] = jax.tree.map(
                jax.numpy.asarray, _jax_dense(cfg))
        return real_j(rng, cfg, opt, **kw)

    def tinit(gen, cfg, opt, *, params=None, device=None, **kw):
        if params is None:
            params = from_jax_values(_jax_dense(_jax_cfg(cfg)))
        return init_train_state(gen, cfg, opt, params=params, **kw)

    monkeypatch.setattr(ref, "init_train_state", jinit)
    monkeypatch.setattr(port, "init_train_state", tinit)
    real_up = port.upcycle_params
    monkeypatch.setattr(port, "upcycle_params", lambda d, dc, tc, gen:
                        real_up(d, dc, tc, routers=_jax_routers(d, dc, tc,
                                                                seed)))


class _NoDonation:
    """``jax`` for a reference example, its ``jit`` without donation."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn, **kw):
        kw.pop("donate_argnums", None)
        return jax.jit(fn, **kw)


_NoDonation = _NoDonation()


def test_quickstart_matches_reference(pair, monkeypatch, capsys):
    """2 dense steps, upcycle, 3 more steps of each: the dense, the
    continued dense and the upcycled MoE's CE within rtol 2e-5."""
    ref, port = pair("quickstart")
    for mod in (ref, port):
        mod.PRETRAIN, mod.EXTRA = 2, 3
    _inject_training(monkeypatch, ref, port, 7)
    got_ref = []
    real_train = ref.train

    def train(*a):
        state, ce = real_train(*a)
        got_ref.append(ce)
        return state, ce

    monkeypatch.setattr(ref, "train", train)
    # The reference's dense continuation donates the dense state, whose
    # embedding and norms its upcycled params share (its upcycle keeps
    # those leaves as they are): with donation honoured, as JAX's CPU
    # backend now does, its MoE continuation reads deleted arrays. Its
    # steps run here without donation (the same numbers).
    monkeypatch.setattr(ref, "jax", _NoDonation)
    ref.main()
    want = capsys.readouterr().out
    got = port.main(["--device", "cpu"])
    out = capsys.readouterr().out
    np.testing.assert_allclose(
        [got["dense_ce"], got["dense_continued_ce"], got["moe_ce"]],
        got_ref, rtol=LOSS_RTOL)
    # The same lines, the same parameter counts.
    assert re.findall(r"params: .*", out) == re.findall(r"params: .*", want)
    assert [ln.split(":")[0] for ln in out.splitlines()] == \
        [ln.split(":")[0] for ln in want.splitlines()]


def test_ablation_initial_drop_matches_reference(pair, monkeypatch, capsys):
    """2 dense steps, then the step-0 CE of 8 upcycles: the dense eval CE
    and every grid entry within rtol 2e-5, the table's lines as many."""
    ref, port = pair("ablation_initial_drop")
    port.PRETRAIN = 2
    # The reference pretrains range(200) steps inline.
    monkeypatch.setattr(ref, "range", lambda n: builtins.range(
        2 if n == 200 else n), raising=False)
    _inject_training(monkeypatch, ref, port, 7)
    seen = []
    real_zoo = ref.zoo

    class Zoo:
        init_params = staticmethod(real_zoo.init_params)

        @staticmethod
        def loss_fn(*a, **kw):
            out = real_zoo.loss_fn(*a, **kw)
            seen.append(float(out[1]["ce"]))
            return out

    monkeypatch.setattr(ref, "zoo", Zoo)
    ref.main()
    want = capsys.readouterr().out
    got = port.main(["--device", "cpu"])
    out = capsys.readouterr().out
    grid = [got["grid"][(c, r)] for r in (True, False)
            for c in port.CAPACITIES]
    np.testing.assert_allclose([got["eval_dense_ce"]] + grid, seen,
                               rtol=LOSS_RTOL)
    assert len(out.splitlines()) == len(want.splitlines())


def _request_lines(out):
    return [ln.strip() for ln in out.splitlines()
            if re.match(r"\s+request \d+: prompt=", ln)]


@pytest.mark.parametrize("paged", [False, True])
def test_serve_moe_greedy_matches_reference(pair, monkeypatch, capsys,
                                            paged):
    """The greedy outputs of the static batch (4 prompts, 12 new) and of
    the paged engine's staggered requests (its arrival, admission and
    finish ticks and prefix hits) printed identically."""
    ref, port = pair("serve_moe")
    monkeypatch.setattr(port, "init_params", lambda gen, cfg, **kw:
                        from_jax_values(_jax_dense(_jax_cfg(cfg),
                                                   condition=False)))
    real_up = port.upcycle_params
    monkeypatch.setattr(port, "upcycle_params", lambda d, dc, tc, gen:
                        real_up(d, dc, tc, routers=_jax_routers(d, dc, tc,
                                                                1)))
    flags = ["--paged"] if paged else []
    monkeypatch.setattr(sys, "argv", ["serve_moe.py"] + flags)
    ref.main()
    want = capsys.readouterr().out
    port.main(flags + ["--device", "cpu"])
    out = capsys.readouterr().out
    lines = _request_lines(out)
    assert len(lines) == (5 if paged else 4)
    assert lines == _request_lines(want)


def _slim(mod):
    return dataclasses.replace(
        mod.SLIM, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=512, moe=dataclasses.replace(mod.SLIM.moe, group_size=64))


def test_train_upcycled_100m_resumes_after_preemption(pair, monkeypatch,
                                                      capsys, tmp_path):
    """At a cut ``SLIM`` (2 layers, d 64, vocab 512), 3 dense steps and 6
    MoE steps (batch 4 x 32, grad accumulation 2): preempted after step
    4 (a blocking save) and rerun, the Trainer resumes and ends at the
    uninterrupted run's loss bit for bit; both within rtol 2e-5 of the
    reference's."""
    from repro.training import train_loop as jtl
    from repro_torch.training import train_loop as ttl

    ref, port = pair("train_upcycled_100m")
    for mod in (ref, port):
        mod.SLIM = _slim(mod)
    real_j, real_t = jtl.init_train_state, ttl.init_train_state

    def jinit(rng, cfg, opt, **kw):
        if kw.get("params") is None:
            kw["params"] = jax.tree.map(jax.numpy.asarray, _jax_dense(cfg))
        return real_j(rng, cfg, opt, **kw)

    def tinit(gen, cfg, opt, *, params=None, device=None, **kw):
        if params is None:
            params = from_jax_values(_jax_dense(_jax_cfg(cfg)))
        return real_t(gen, cfg, opt, params=params, **kw)

    monkeypatch.setattr(jtl, "init_train_state", jinit)
    monkeypatch.setattr(ttl, "init_train_state", tinit)
    real_up = port.upcycle_params
    monkeypatch.setattr(port, "upcycle_params", lambda d, dc, tc, gen:
                        real_up(d, dc, tc, routers=_jax_routers(d, dc, tc,
                                                                11)))
    runs = []

    class Trainer(ref.Trainer):
        def run(self, *a, **kw):
            runs.append(super().run(*a, **kw))
            return runs[-1]

    monkeypatch.setattr(ref, "Trainer", Trainer)
    flags = ["--steps", "6", "--dense-steps", "3", "--batch", "4", "--seq",
             "32"]
    monkeypatch.setattr(sys, "argv", ["train_upcycled_100m.py"] + flags
                        + ["--ckpt-dir", str(tmp_path / "ref")])
    ref.main()
    want = capsys.readouterr().out
    assert "done at step 6" in want
    loss_ref = float(runs[-1]["metrics"]["loss"])
    straight = port.main(flags + ["--ckpt-dir", str(tmp_path / "a"),
                                  "--device", "cpu"])
    port.main(flags + ["--ckpt-dir", str(tmp_path / "b"), "--preempt-at",
                       "4", "--device", "cpu"])
    first = capsys.readouterr().out
    assert "preempted at step 4" in first, first
    resumed = port.main(flags + ["--ckpt-dir", str(tmp_path / "b"),
                                 "--device", "cpu"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out, out
    assert int(resumed["state"]["step"]) == 6
    assert resumed["metrics"]["loss"] == straight["metrics"]["loss"]
    np.testing.assert_allclose(straight["metrics"]["loss"], loss_ref,
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(re.findall(r"loss (\S+)", out)[-1]),
                               loss_ref, atol=1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_examples_raise_without_a_card(name):
    """Without ``--device cpu`` an example asks for the card and raises
    where there is none (never a quiet fall back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    port = _load(f"torch_{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.main([])
