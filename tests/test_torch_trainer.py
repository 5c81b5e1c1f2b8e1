"""Port parity for the fault-tolerant Trainer: ``repro_torch.training``
(Trainer, SpikeDetector, chaos) against ``repro.training``, at reduced
granite on the CPU.

* On the same initial params and batches, the two Trainers give the
  same per-step losses (rtol 2e-5, as the step parity of
  test_torch_train.py), the same tracker rows (``deterministic_rows``:
  metric floats at that tolerance, everything else equal) and the same
  rollback records for an injected spike.
* ``SpikeDetector`` and ``ChaosState`` decide as the reference's do for
  the same inputs and seeds.
* The port's kill-at-step-k resume, preemption storm and corrupt store
  replay bit-exactly on the CPU.
* The launcher chain: dense Trainer checkpoint -> ``launch.train
  --upcycle-from`` -> MoE checkpoint -> ``launch.serve --ckpt-dir``;
  the reference's loaders, which take a params-only tree, raise on a
  Trainer's full-state checkpoint (ROADMAP.md queue 3).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.configs import get_reduced as jax_reduced
from repro.core import upcycle as jup
from repro.data import make_iterator as jmake_iterator
from repro.models import model_zoo as jzoo
from repro.models import param as jpm
from repro.obs import MemorySink as JMemorySink
from repro.obs import Tracker as JTracker
from repro.optim import adafactor as jadafactor
from repro.optim import schedules as jsched
from repro.training import chaos as jchaos
from repro.training import health as jhealth
from repro.training import train_loop as jtl
from repro_torch.checkpoint import CheckpointManager, store
from repro_torch.configs import get_reduced
from repro_torch.core import upcycle as tup
from repro_torch.data import make_iterator
from repro_torch.models import model_zoo as zoo
from repro_torch.models.convert import from_jax_values
from repro_torch.obs import MemorySink, Tracker, deterministic_rows
from repro_torch.optim import adafactor, schedules
from repro_torch.training import (
    ChaosState,
    PreemptionSignal,
    SpikeDetector,
    TrainChaosConfig,
    TrainConfig,
    Trainer,
    run_chaotic,
)

ARCH = "granite-moe-1b-a400m"
JAC = jzoo.ApplyCfg(dispatch="sorted", sorted_block=8, moe_impl="xla",
                    attn_impl="xla")
TAC = zoo.ApplyCfg(dispatch="sorted")
B, S = 4, 32
LOSS_RTOL, GRAD_NORM_RTOL = 2e-5, 2e-4
OPT = dict(peak=0.01, warmup_steps=2)


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


@pytest.fixture(scope="module")
def cfgs():
    return jax_reduced(ARCH), get_reduced(ARCH)


@pytest.fixture(scope="module")
def init_vals(cfgs):
    """The MoE's initial params (numpy, conditioned) from the JAX init."""
    jcfg, _ = cfgs
    vals, _ = jpm.split(jzoo.init_params(jax.random.PRNGKey(0), jcfg))
    return _condition(vals, jcfg)


def _jax_trainer(cfg, d, tc, *, sink, chaos=None, state=None):
    it = jmake_iterator(cfg, global_batch=B, seq_len=S, host_index=0,
                        host_count=1)
    return jtl.Trainer(cfg, jadafactor(jsched.inverse_sqrt(**OPT)), it,
                       str(d), ac=JAC, tc=tc, log_fn=lambda s: None,
                       tracker=JTracker((sink,)), chaos=chaos,
                       chaos_state=state)


def _torch_trainer(cfg, d, tc, *, sink=None, chaos=None, state=None,
                   preemption=None, batch=B, seq=S):
    it = make_iterator(cfg, global_batch=batch, seq_len=seq)
    trk = Tracker((sink,)) if sink is not None else None
    return Trainer(cfg, adafactor(schedules.inverse_sqrt(**OPT)), it,
                   str(d), ac=TAC, tc=tc, log_fn=lambda s: None,
                   tracker=trk, chaos=chaos, chaos_state=state,
                   preemption=preemption, device="cpu")


def _float_close(a, b, key):
    if isinstance(a, float) and isinstance(b, float):
        rtol = GRAD_NORM_RTOL if key == "grad_norm" else LOSS_RTOL
        return math.isclose(a, b, rel_tol=rtol, abs_tol=1e-7)
    return a == b


def _rows_match(port_rows, ref_rows):
    """deterministic_rows of both trackers: the same rows in the same
    order, floats at the step parity's tolerance, the rest equal."""
    assert len(port_rows) == len(ref_rows)
    for p, r in zip(port_rows, ref_rows):
        assert set(p) == set(r), (p, r)
        for k in p:
            assert _float_close(p[k], r[k], k), (k, p, r)


# (scenario, steps, TrainConfig, chaos): a straight run, and one whose
# observed loss at batch 5 is multiplied 100x (a seeded spike).
SCENARIOS = {
    "straight": (4, TrainConfig(checkpoint_every=2, log_every=1000), None),
    "spike": (8, TrainConfig(checkpoint_every=2, log_every=1000,
                             spike_threshold=3.0, spike_min_history=3,
                             max_rollbacks=2, rollback_skip=2,
                             rollback_lr_decay=0.5, rollback_cooldown=2),
              dict(seed=0, spike_batches=(5,))),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_trainer_matches_reference(cfgs, init_vals, tmp_path, scenario):
    jcfg, tcfg = cfgs
    steps, tc, chaos = SCENARIOS[scenario]
    jtc = jtl.TrainConfig(**{f: getattr(tc, f) for f in (
        "checkpoint_every", "log_every", "spike_threshold",
        "spike_min_history", "max_rollbacks", "rollback_skip",
        "rollback_lr_decay", "rollback_cooldown")})
    jsink, tsink = JMemorySink(), MemorySink()
    jch = None if chaos is None else jchaos.TrainChaosConfig(**chaos)
    tch = None if chaos is None else TrainChaosConfig(**chaos)
    jout = _jax_trainer(jcfg, tmp_path / "jax", jtc, sink=jsink,
                        chaos=jch).run(
        steps, init_params=jax.tree.map(jnp.asarray, init_vals))
    tout = _torch_trainer(tcfg, tmp_path / "torch", tc, sink=tsink,
                          chaos=tch).run(
        steps, init_params=from_jax_values(init_vals))
    jrows = deterministic_rows(jsink.rows)
    trows = deterministic_rows(tsink.rows)
    _rows_match(trows, jrows)
    losses = [r["loss"] for r in trows if r["kind"] == "train"]
    # the spike at step 6 rolls back to step 4: steps 5 and 6 replay
    assert len(losses) == steps + (2 if scenario == "spike" else 0)
    jrb, trb = jout["stats"]["rollbacks"], tout["stats"]["rollbacks"]
    assert len(trb) == len(jrb) == (scenario == "spike")
    for t, j in zip(trb, jrb):
        assert set(t) == set(j)
        for k in t:
            assert _float_close(t[k], j[k], k), (k, t, j)
    if trb:
        assert trb[0]["batch"] == 5 and trb[0]["restored_to"] == 4
    assert int(tout["state"]["step"]) == int(jout["state"]["step"]) == steps
    for k in ("skipped_steps", "cooldown_left", "resumed_from", "store"):
        assert tout["stats"][k] == jout["stats"][k], k


def test_trainer_config_refuses_what_the_step_lacks():
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        TrainConfig(grad_accum=2)
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        TrainConfig(compression="bf16")


# ---------------------------------------------------------------------------
# the detector and the chaos coins
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["median", "ewma"])
def test_spike_detector_matches_reference(mode):
    rng = np.random.default_rng(0)
    losses = list(5.0 - 0.05 * np.arange(60) + rng.normal(0, 0.1, 60))
    losses[20] *= 8.0
    losses[33] = float("nan")
    losses[41] *= 3.5
    kw = dict(window=8, min_history=3, mode=mode, ewma=0.8)
    dets = (SpikeDetector(2.5, **kw), jhealth.SpikeDetector(2.5, **kw))
    for x in losses:
        decisions = [d.is_spike(x) for d in dets]
        assert decisions[0] == decisions[1]
        assert dets[0].baseline() == dets[1].baseline()
        if not decisions[0]:
            for d in dets:
                d.update(x)
    assert dets[0].state() == dets[1].state()
    back = SpikeDetector(2.5, **kw)
    back.restore(dets[1].state())
    assert back.state() == dets[1].state()
    assert not SpikeDetector(0.0).enabled


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chaos_state_matches_reference(seed, tmp_path):
    kw = dict(seed=seed, spike_batches=(3,), spike_prob=0.2,
              crash_steps=(4,), crash_prob=0.1, preempt_prob=0.15,
              io_fault_prob=0.3, corrupt_steps=(6,), max_corrupts=1)
    sts = (ChaosState(TrainChaosConfig(**kw)),
           jchaos.ChaosState(jchaos.TrainChaosConfig(**kw)))
    for i in range(40):
        assert sts[0].spike_at(i) == sts[1].spike_at(i)
        assert sts[0].crash_at(i) == sts[1].crash_at(i)
        assert sts[0].preempt_at(i) == sts[1].preempt_at(i)
        raised = []
        for st in sts:
            try:
                st.fault_hook("save", 0)
                raised.append(False)
            except OSError:
                raised.append(True)
        assert raised[0] == raised[1]
    # corruption tears the just-written checkpoint's first leaf
    m = CheckpointManager(str(tmp_path))
    m.save(6, {"w": torch.ones(3)})
    assert sts[0].maybe_corrupt(m, 6)
    assert not sts[0].maybe_corrupt(m, 6)  # fires once
    with pytest.raises(store.CorruptCheckpointError):
        store.load_tree(m.step_path(6), {"w": torch.ones(3)})
    sts[1].corrupts += 1
    assert sts[0].summary() == sts[1].summary()


# ---------------------------------------------------------------------------
# bit-exact resume on the CPU
# ---------------------------------------------------------------------------


def _assert_states_equal(a, b):
    fa, fb = store._flatten(a), store._flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), p


def _last_train_rows(rows):
    out = {}
    for r in deterministic_rows(rows):
        if r.get("kind") == "train":
            out[r["t"]] = r
    return out


# (chaos, steps, checkpoint_every): a crash after step 5 (before its
# save: steps 4-5 replay from step 3); a preemption storm (save and exit
# at steps 2 and 5); a crash after step 7 with the step-6 checkpoint torn
# after COMMIT and every store op's first attempt failing.
RESUME_CASES = {
    "crash": (dict(seed=1, crash_steps=(5,)), 8, 3),
    "preempt": (dict(seed=2, preempt_steps=(2, 5), max_preempts=4), 8,
                100),
    "corrupt": (dict(seed=3, crash_steps=(7,), io_fault_prob=1.0,
                     max_io_faults=100, corrupt_steps=(6,)), 9, 3),
}


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_kill_and_resume_is_bit_exact(cfgs, tmp_path, case):
    _, tcfg = cfgs
    chaos, steps, every = RESUME_CASES[case]
    tc = TrainConfig(checkpoint_every=every, log_every=1000)
    a_sink, b_sink = MemorySink(), MemorySink()
    out_a = _torch_trainer(tcfg, tmp_path / "straight", tc,
                           sink=a_sink).run(steps)
    preempt = case == "preempt"
    out_b, st = run_chaotic(
        lambda ch, s: _torch_trainer(
            tcfg, tmp_path / case, tc, sink=b_sink, chaos=ch, state=s,
            preemption=PreemptionSignal() if preempt else None),
        steps, TrainChaosConfig(**chaos))
    assert st.rebuilds == (2 if preempt else 1)
    assert int(out_b["state"]["step"]) == steps
    _assert_states_equal(out_a["state"], out_b["state"])
    ra, rb = _last_train_rows(a_sink.rows), _last_train_rows(b_sink.rows)
    assert set(ra) == set(rb) == set(range(1, steps + 1))
    assert ra == rb
    if case == "corrupt":
        assert st.corrupts == 1 and st.io_faults > 0
        assert out_b["stats"]["store"]["fallbacks"] >= 1


# ---------------------------------------------------------------------------
# the launcher chain
# ---------------------------------------------------------------------------


def test_checkpoint_chain_through_the_launchers(cfgs, tmp_path, capsys):
    """Dense parent trained by the Trainer (full train-state
    checkpoints) -> ``launch.train --upcycle-from`` -> the MoE's
    checkpoint -> ``launch.serve --ckpt-dir --paged``. The restored dense
    params are the Trainer's bit for bit, in both packages; the upcycled
    tree equals the reference's upcycle of them (its routers injected);
    the reference's params-only loader raises on the same checkpoint."""
    from repro_torch.launch import serve as lserve
    from repro_torch.launch import train as ltrain

    jcfg, tcfg = cfgs
    dense_dir, moe_dir = tmp_path / "dense", tmp_path / "moe"
    out = _torch_trainer(tcfg.dense_parent(), dense_dir,
                         TrainConfig(checkpoint_every=2, log_every=1000),
                         batch=2, seq=16).run(4)
    final = out["state"]["params"]

    dense, sparse, step = ltrain.upcycle_from(str(dense_dir), tcfg,
                                              device="cpu")
    assert step == 4
    _assert_states_equal(dense, final)
    # The reference restores the same checkpoint as its full train state.
    jd = jcfg.dense_parent()
    jopt = jadafactor(jsched.inverse_sqrt(**OPT))
    like = jax.tree.map(np.asarray, jtl.init_train_state(
        jax.random.PRNGKey(0), jd, jopt))
    jstate, jstep, _ = JManager(str(dense_dir)).restore_latest(like)
    assert jstep == 4 and int(jstate["step"]) == 4
    _assert_states_equal(from_jax_values(jax.tree.map(
        np.asarray, jstate["params"])), final)
    # ... but its params-only loaders (--upcycle-from, serve --ckpt-dir)
    # refuse it.
    with pytest.raises(ValueError, match=r"extra=\[\"\['opt_state'\]"):
        JManager(str(dense_dir)).restore_latest({"params": like["params"]})
    _, axes = jpm.split(jzoo.init_params(jax.random.PRNGKey(0), jd))
    jsparse = jpm.split(jup.upcycle_params(
        jpm.wrap(jstate["params"], axes), jd, jcfg,
        jax.random.PRNGKey(7)))[0]
    w = np.asarray(jsparse["stack"]["segments"][0]["pos0"]["ffn"]["router"]
                   ["w"])
    injected = tup.upcycle_params(dense, tcfg.dense_parent(), tcfg,
                                  routers=[w[l] for l in range(w.shape[0])])
    _assert_states_equal(injected, from_jax_values(
        jax.tree.map(np.asarray, jsparse)))
    seeded = tup.upcycle_params(dense, tcfg.dense_parent(), tcfg,
                                torch.Generator().manual_seed(7))
    _assert_states_equal(sparse, seeded)

    capsys.readouterr()
    ltrain.main(["--arch", ARCH, "--reduced", "--upcycle-from",
                 str(dense_dir), "--ckpt-dir", str(moe_dir), "--steps",
                 "100", "--batch", "2", "--seq", "16", "--dispatch",
                 "sorted", "--device", "cpu"])
    text = capsys.readouterr().out
    assert f"[train] upcycled from {dense_dir} @ step 4" in text
    assert "[train] finished at step 100" in text
    assert store.load_metadata(str(moe_dir / "step_00000100"))[
        "arch"] == tcfg.name
    lserve.main(["--arch", ARCH, "--reduced", "--ckpt-dir", str(moe_dir),
                 "--paged", "--max-new", "4", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "[serve] loaded checkpoint step 100" in text
    assert "status_counts={'completed': 3}" in text
    # serve's restore gives the Trainer's params, not the seed-0 init
    params, step = lserve.load_params(
        tcfg, device="cpu", manager=CheckpointManager(str(moe_dir)))
    assert step == 100
    init = zoo.init_params(0, tcfg, device="cpu")
    assert not torch.equal(params["embed"]["tokens"],
                           init["embed"]["tokens"])


def test_crash_while_the_last_save_writes_resumes_from_it(cfgs, tmp_path,
                                                         monkeypatch):
    """A crash after step 3 while step 2's async save is still writing
    (a slow store): the restart resumes from step 2 — run_chaotic joins
    the crashed Trainer's writer — and replays bit-exactly."""
    import threading
    import time

    _, tcfg = cfgs
    tc = TrainConfig(checkpoint_every=2, log_every=1000)
    out_a = _torch_trainer(tcfg, tmp_path / "straight", tc).run(4)
    save_tree = store.save_tree

    def slow_save(path, tree, **kw):
        if threading.current_thread() is not threading.main_thread():
            time.sleep(0.5)
        save_tree(path, tree, **kw)

    monkeypatch.setattr(store, "save_tree", slow_save)
    trainers = []

    def make(ch, s):
        trainers.append(_torch_trainer(tcfg, tmp_path / "crash", tc,
                                       chaos=ch, state=s))
        return trainers[-1]

    out_b, st = run_chaotic(make, 4, TrainChaosConfig(crash_steps=(3,)))
    assert st.crashes == 1
    assert trainers[-1].stats["resumed_from"] == 2
    _assert_states_equal(out_a["state"], out_b["state"])
