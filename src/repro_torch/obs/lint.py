"""Schema lint (port of ``repro/obs/lint.py``): every metric name the
port emits must be documented.

Runs a smoke serve (the solo chunked engine and a small fleet) and a
checkpoint retry through a real :class:`JsonlSink`, on the CPU at
reduced granite, reads the rows back, and fails if any emitted name —
counter/gauge/observe/event ``name``, span ``path``, or a structured
``engine``/``fleet``/``train`` row field — is missing from the
backticked names in ``src/repro_torch/obs/README.md``:

    PYTHONPATH=src python -m repro_torch.obs.lint

Exit 0 = every emitted name documented; exit 1 lists the offenders.
The documented set is simply every `` `token` `` in the README, so
adding a metric means adding one table row there.
"""
from __future__ import annotations

import json
import os
import re
import sys
import tempfile

README = os.path.join(os.path.dirname(__file__), "README.md")

# Bound-tag keys that may ride on any row (fleet mode tags engine
# rows/counters with the replica eid).
TAG_KEYS = {"engine"}
STRUCT_COMMON = {"kind", "t"}


def documented_names(readme_path: str = README) -> set:
    with open(readme_path) as f:
        text = f.read()
    return set(re.findall(r"`([^`\n]+)`", text))


def emitted_names(rows) -> set:
    """Every name a row set exercises, per the README contract."""
    names = set()
    for r in rows:
        kind = r.get("kind")
        if kind in ("counter", "gauge", "observe", "event"):
            names.add(str(r["name"]))
        elif kind == "summary":
            n = str(r.get("name", ""))
            # span.<path> summaries are documented by their span path
            names.add(n[len("span."):] if n.startswith("span.") else n)
        elif kind == "span":
            names.add(str(r.get("path", r.get("name", ""))))
        elif kind in ("engine", "train"):
            names.update(k for k in r
                         if k not in STRUCT_COMMON | TAG_KEYS)
        elif kind == "fleet":
            names.update(k for k in r if k not in STRUCT_COMMON)
            names.update(r.get("fleet", {}))
    return names


def smoke_rows(path: str) -> list:
    """Exercise serve solo + fleet + checkpoint through a JsonlSink, on
    the CPU."""
    import dataclasses

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_reduced
    from repro_torch.models import model_zoo as zoo
    from repro_torch.obs import JsonlSink, Tracker
    from repro_torch.serve import (
        AutoscaleConfig,
        Fleet,
        FleetConfig,
        Request,
        ServeConfig,
        ServeEngine,
    )

    cfg = get_reduced("granite-moe-1b-a400m")
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    vals = zoo.init_params(0, cfg, device="cpu")

    def mkreq(rid, arrival=0):
        prompt = [(37 * rid + 11 * i) % 97 + 1 for i in range(8)]
        return Request(rid=rid, prompt=prompt, max_new=6, arrival=arrival)

    with JsonlSink(path, keep_rows=True) as sink:
        trk = Tracker((sink,))

        # solo serve: engine rows + spans + scheduler counters
        eng = ServeEngine(vals, cfg, ServeConfig(
            max_batch=3, max_len=64, paged=True, block_size=8,
            chunk_size=8, chunks_per_step=2, audit_invariants=True),
            device="cpu")
        outs, fin = eng.serve([mkreq(r, arrival=r // 2) for r in range(4)],
                              tracker=trk)
        assert all(rec["status"] == "completed" for rec in fin.values())

        # fleet: fleet rows, tagged engine rows, autoscale counters
        fleet = Fleet(eng, FleetConfig(
            num_engines=2,
            autoscale=AutoscaleConfig(min_engines=1, max_engines=3,
                                      up_ticks=2, cooldown=2),
        ), tracker=trk)
        _, ffin = fleet.run([mkreq(r, arrival=r // 2) for r in range(6)])
        assert all(rec["status"] == "completed" for rec in ffin.values())

        # checkpoint retry counter via an injected transient fault
        boom = {"n": 0}

        def fault(op, attempt):
            if op == "save" and boom["n"] == 0:
                boom["n"] += 1
                raise OSError("injected transient store failure")

        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d, fault_hook=fault,
                                    sleep=lambda s: None, tracker=trk)
            mgr.save(1, {"w": torch.zeros((2,))})

        trk.close()

    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def main() -> int:
    doc = documented_names()
    with tempfile.TemporaryDirectory() as d:
        rows = smoke_rows(os.path.join(d, "obs.jsonl"))
    emitted = emitted_names(rows)
    missing = sorted(n for n in emitted if n and n not in doc)
    kinds = sorted({str(r.get("kind")) for r in rows})
    print(f"[obs-lint] {len(rows)} rows, kinds={kinds}, "
          f"{len(emitted)} distinct names, {len(doc)} documented tokens")
    if missing:
        print("[obs-lint] FAIL — emitted but not in "
              "src/repro_torch/obs/README.md:")
        for n in missing:
            print(f"  {n}")
        return 1
    print("[obs-lint] OK — every emitted name is documented")
    return 0


if __name__ == "__main__":
    sys.exit(main())
