"""Port parity for observability: ``repro_torch.obs`` against
``repro.obs``. The tracker-core cases of tests/test_obs.py run through
both packages (each case parametrised over the package), the same
instrument calls give the same rows in both, and the port's Trainer,
CheckpointManager and serve scheduler emit through the port's tracker.
"""
import json

import numpy as np
import pytest

import repro.checkpoint as jckpt
import repro.obs as jobs
import repro_torch.checkpoint as tckpt
import repro_torch.obs as tobs

OBS = {"jax": jobs, "torch": tobs}
CKPT = {"jax": jckpt, "torch": tckpt}


@pytest.fixture(params=sorted(OBS))
def which(request):
    return request.param


def test_sink_fanout_and_bind(which):
    obs = OBS[which]
    a, b = obs.MemorySink(), obs.MemorySink()
    trk = obs.Tracker((a, b), clock=lambda: 7, tags={"run": "x"})
    trk.count("hits")
    trk.count("hits", 2)
    trk.gauge("depth", 3.5, t=9)
    assert a.rows == b.rows and len(a.rows) == 3
    assert a.rows[0] == {"kind": "counter", "name": "hits", "t": 7,
                         "inc": 1, "value": 1, "run": "x"}
    assert a.rows[1]["value"] == 3 and a.rows[2]["t"] == 9
    child = trk.bind(engine=2)
    child.count("hits")
    assert a.rows[-1]["value"] == 1 and a.rows[-1]["engine"] == 2
    child.close()
    assert not a.closed and not b.closed
    trk.close()
    assert a.closed and b.closed


def test_span_nesting_and_summaries(which):
    obs = OBS[which]
    sink = obs.MemorySink()
    trk = obs.Tracker((sink,), clock=lambda: 0)
    with trk.span("tick"):
        with trk.span("admission"):
            pass
        with trk.span("mixed_step"):
            with trk.span("dispatch"):
                pass
    spans = [r for r in sink.rows if r["kind"] == "span"]
    assert [s["path"] for s in spans] == [
        "tick/admission", "tick/mixed_step/dispatch", "tick/mixed_step",
        "tick"]
    assert [s["depth"] for s in spans] == [2, 3, 2, 1]
    by = {s["path"]: s for s in spans}
    assert by["tick"]["dur_ms"] >= by["tick/admission"]["dur_ms"] >= 0
    assert not [r for r in sink.rows if r["kind"] == "observe"]
    trk.close()
    summaries = [r for r in sink.rows if r["kind"] == "summary"]
    assert {s["name"] for s in summaries} == {f"span.{p}" for p in by}


def test_histogram_percentiles_vs_numpy(which):
    obs = OBS[which]
    rng = np.random.default_rng(0)
    xs = rng.lognormal(mean=3.0, sigma=1.0, size=5000)
    h = obs.Histogram()
    for x in xs:
        h.record(float(x))
    s = h.summary()
    assert s["count"] == 5000
    assert s["min"] == xs.min() and s["max"] == xs.max()
    for q in (50, 99):
        ratio = h.percentile(q) / np.percentile(xs, q)
        assert 1 / 1.45 < ratio < 1.45, (q, ratio)


def test_jsonl_roundtrip_and_flush_per_row(which, tmp_path):
    obs = OBS[which]
    path = str(tmp_path / "rows.jsonl")
    sink = obs.JsonlSink(path, keep_rows=True)
    trk = obs.Tracker((sink,))
    trk.count("a", t=1)
    trk.row("train", t=2, loss=0.5)
    with open(path) as f:  # flushed on every row, before close
        assert [json.loads(ln) for ln in f] == sink.rows
    trk.close()
    assert sink.closed
    s2 = obs.JsonlSink(str(tmp_path / "crash.jsonl"))
    with pytest.raises(RuntimeError):
        with s2:
            s2.write({"kind": "event", "name": "boom", "t": 0})
            raise RuntimeError("mid-run crash")
    assert s2.closed


def test_null_tracker_is_inert_until_bound(which):
    obs = OBS[which]
    n = obs.NullTracker()
    assert not n.enabled and not obs.NULL.enabled
    n.count("x")
    with n.span("z"):
        pass
    assert n.bind(engine=1) is n
    sink = obs.MemorySink()
    real = n.bind(extra_sinks=(sink,), clock=lambda: 3)
    real.count("x")
    assert sink.rows[0]["t"] == 3


def test_deterministic_rows_strips_wall_nondeterminism(which):
    obs = OBS[which]
    rows = [
        {"kind": "span", "path": "tick", "dur_ms": 1.0, "t": 0},
        {"kind": "summary", "name": "span.tick", "p50": 1.0, "t": 0},
        {"kind": "summary", "name": "latency", "p50": 4.0, "t": 0},
        {"kind": "train", "t": 1, "loss": 2.0, "step_ms": 9.9},
    ]
    assert obs.deterministic_rows(rows) == [
        {"kind": "summary", "name": "latency", "p50": 4.0, "t": 0},
        {"kind": "train", "t": 1, "loss": 2.0},
    ]
    assert obs.WALL_FIELDS == jobs.WALL_FIELDS


def test_checkpoint_manager_counts_retries_and_fallbacks(which, tmp_path):
    obs, ckpt = OBS[which], CKPT[which]
    sink = obs.MemorySink()
    trk = obs.Tracker((sink,))
    fails = {"n": 2}

    def fault(op, attempt):
        if op == "save" and fails["n"] > 0:
            fails["n"] -= 1
            raise OSError("flaky mount")

    tree = {"w": np.arange(4, dtype=np.float32)}
    mgr = ckpt.CheckpointManager(str(tmp_path), fault_hook=fault,
                                 sleep=lambda s: None, tracker=trk)
    mgr.save(1, tree)
    counters = {r["name"]: r["value"] for r in sink.rows
                if r["kind"] == "counter"}
    assert counters == {"checkpoint.io_retries": 2}
    mgr2 = ckpt.CheckpointManager(str(tmp_path), tracker=trk,
                                  sleep=lambda s: None)
    mgr2.save(2, {"w": np.ones(4, dtype=np.float32)})
    (tmp_path / "step_00000002" / "leaf_00000.npy").write_bytes(b"\x93NU")
    restored, step, _ = mgr2.restore_latest(tree)
    assert step == 1
    np.testing.assert_array_equal(np.asarray(restored["w"]), tree["w"])
    counters = {r["name"]: r["value"] for r in sink.rows
                if r["kind"] == "counter"}
    # the torn step's restore was retried twice before the fallback
    assert counters == {"checkpoint.io_retries": 4,
                        "checkpoint.fallbacks": 1}


def _script(obs):
    """One run of instrument calls; its rows minus wall-clock."""
    sink = obs.MemorySink()
    clock = {"t": 0}
    trk = obs.Tracker((sink,), clock=lambda: clock["t"],
                      hist_bounds=(1, 2, 4, 8), tags={"run": 1})
    for t in range(5):
        clock["t"] = t
        trk.count("steps")
        trk.gauge("queue", 3 - t)
        trk.observe("lat", 1.5 * t)
        trk.event("tick", n=t)
        trk.row("train", loss=2.0 / (t + 1), step_ms=float(t))
        with trk.span("step"):
            pass
    trk.bind(engine=3).count("steps", t=9)
    trk.close()
    return obs.deterministic_rows(sink.rows)


def test_same_calls_give_the_same_rows():
    rows = _script(tobs)
    assert rows == _script(jobs)
    assert {r["kind"] for r in rows} == {"counter", "gauge", "observe",
                                         "event", "train", "summary"}


def test_trainer_emits_train_rows_every_step(tmp_path):
    from repro_torch.configs import get_reduced
    from repro_torch.data import make_iterator
    from repro_torch.optim import adafactor, constant
    from repro_torch.training import TrainConfig, Trainer

    cfg = get_reduced("granite-moe-1b-a400m").dense_parent()
    sink = tobs.MemorySink()
    it = make_iterator(cfg, global_batch=2, seq_len=16)
    tr = Trainer(cfg, adafactor(constant(1e-3)), it, str(tmp_path),
                 tc=TrainConfig(checkpoint_every=100, log_every=100),
                 log_fn=lambda s: None, tracker=tobs.Tracker((sink,)),
                 device="cpu")
    tr.run(3)
    trows = [r for r in sink.rows if r["kind"] == "train"]
    assert [r["t"] for r in trows] == [1, 2, 3]
    for r in trows:
        assert set(r) == {"kind", "t", "loss", "ce", "grad_norm",
                          "skipped", "skipped_steps", "spike", "rollbacks",
                          "lr_scale", "step_ms"}
        assert np.isfinite(r["loss"]) and r["grad_norm"] >= 0
        assert r["skipped"] == 0.0 and r["skipped_steps"] == 0


def test_scheduler_counts_into_the_port_tracker():
    from repro_torch.serve import scheduler

    assert scheduler.NULL is tobs.NULL
