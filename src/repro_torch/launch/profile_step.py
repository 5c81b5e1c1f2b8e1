"""Trace one fixed-shape ``paged_mixed_step`` with ``torch.profiler`` and
report where its time goes.

    PYTHONPATH=src python -m repro_torch.launch.profile_step \\
        [--train [--arch granite-moe-1b-a400m|vit-b16-upcycled] \\
         [--batch N] [--seq S]] \\
        [--reduced] [--steps 3] [--device cuda|cpu] \\
        [--out trace_summary.json]

Without ``--train`` the model is granite-moe-1b-a400m, the serve
cell's, with dropless routing and the sorted dispatch. The step carries
the serve shapes of ``chip_smoke.py`` (8 decode rows of ragged lengths,
two 64-token chunk lanes, 16-token blocks, 512-token sequences) over
random pools and random weights from seed 0. ``--train`` traces one MoE
train step of ``--arch`` instead, on a fixed batch of the arch's
synthetic stream, as its train cell in ``chip_smoke.py`` runs it:
granite at 16 x 512 tokens through the sorted dispatch, the ViT at 104
images of 196 patches (its sequence; ``--seq`` is not read) through the
gather dispatch. It prints one JSON object per run:

* ``wall_ms``: host wall time per step, synchronised at both ends,
  untraced; ``traced_wall_ms`` the same under the profiler;
* ``host_ops``: PyTorch operators the step dispatches from Python
  (top-level ``aten::`` calls), per step and per layer;
* ``device_kernels``, ``device_busy_ms``, ``idle_share``: on a card,
  the kernels the step ran, the union of their intervals per step and
  ``1 - busy / wall_ms`` (kernel times are read on the device's
  clock, so the profiler's host overhead does not enter them); ``null``
  where the profiler saw no device activity (always on the CPU);
* ``kernels``: device ms per step of each of the port's CUDA kernels;
* ``top``: the eight device kernels that took the most time.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

ARCH = "granite-moe-1b-a400m"
# The serve shapes of chip_smoke.py.
SERVE = dict(max_batch=8, max_len=512, block_size=16, chunk_size=64,
             chunks_per_step=2)
PORT_KERNELS = {"decode_attention": "decode_kernel",
                "paged_prefill": "prefill_kernel",
                "grouped_mlp": "grouped_mlp_kernel",
                "flash_attention": "flash_fwd_kernel",
                "flash_attention_dq": "flash_dq_kernel",
                "flash_attention_dkv": "flash_dkv_kernel",
                "grouped_mlp_dx": "grouped_dx_kernel",
                "grouped_mlp_dw": "grouped_dw_kernel",
                "expert_mlp": "expert_ffn_kernel",
                "expert_mlp_dx": "expert_dx_kernel",
                "expert_mlp_dw": "expert_dw_kernel"}
# The train cells of chip_smoke.py: default batch (images for the
# encoder-only ViT) and MoE dispatch.
TRAIN_CELLS = {"granite-moe-1b-a400m": dict(batch=16, dispatch="sorted"),
               "vit-b16-upcycled": dict(batch=104, dispatch="gather")}


def mixed_step_inputs(cfg, device, *, serve: dict = SERVE):
    """A paged cache with random pools, and the token and lane arguments
    of one ``paged_mixed_step`` at the ``serve`` shapes (8 slots, two
    lanes of at least 64 tokens): decode slots of lengths (0, 5, 16, 33,
    100, 0, 250, 400) and two chunk lanes of one request at positions
    0..63 and 64..103. Returns ``(cache, args)`` with ``args`` in the
    step's positional order after ``params``."""
    import torch

    from repro_torch.models import model_zoo as zoo

    gen = torch.Generator(device=device).manual_seed(2)
    bs, nb = serve["block_size"], serve["max_len"] // serve["block_size"]
    B, NC, C = (serve["max_batch"], serve["chunks_per_step"],
                serve["chunk_size"])
    P = 1 + B * nb
    cache = zoo.init_paged_serve_cache(cfg, P, bs, dtype=torch.float32,
                                       device=device)
    for seg in cache["stack"]["segments"]:
        for pos in seg.values():
            for pool in pos["mixer"].values():
                pool.normal_(generator=gen)
    i32 = dict(dtype=torch.int32, device=device)
    tables = (1 + torch.randperm(P - 1, generator=gen, device=device)
              ).reshape(B, nb).to(torch.int32)
    dec_len = torch.tensor([0, 5, 16, 33, 100, 0, 250, 400], **i32)
    dec_tab = tables * (dec_len > 0)[:, None]
    tok = lambda *s: torch.randint(1, cfg.vocab_size, s, generator=gen,  # noqa
                                   **i32)
    args = (tok(B, 1), tok(NC, C), cache, dec_tab, dec_len,
            tables[5:6].repeat(NC, 1).contiguous(),
            torch.tensor([0, 64], **i32), torch.tensor([64, 40], **i32))
    return cache, args


def _union_ms(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def mixed_step_fn(cfg, device):
    """One serve-cell mixed step, as a closure."""
    import torch

    from repro_torch.models import model_zoo as zoo

    params = zoo.init_params(torch.Generator(device=device).manual_seed(0),
                             cfg, device=device)
    _, args = mixed_step_inputs(cfg, device)
    ac = zoo.ApplyCfg(dispatch="sorted")
    return lambda: zoo.paged_mixed_step(params, *args, cfg, ac=ac)


def train_step_fn(cfg, device, *, batch: int, seq: int, dispatch: str):
    """One train-cell MoE step on a fixed batch, as a closure."""
    import torch

    from repro_torch.data import ClusteredBigramTask, make_iterator
    from repro_torch.launch.train import TASK_VOCAB
    from repro_torch.models import model_zoo as zoo
    from repro_torch.optim import adafactor, inverse_sqrt
    from repro_torch.training import init_train_state, make_train_step

    opt = adafactor(inverse_sqrt(peak=0.01, warmup_steps=100))
    state = init_train_state(torch.Generator(device=device).manual_seed(0),
                             cfg, opt, device=device)
    task = ClusteredBigramTask(vocab_size=min(cfg.vocab_size, TASK_VOCAB))
    data = next(make_iterator(cfg, global_batch=batch, seq_len=seq,
                              task=task))
    step = make_train_step(cfg, opt, ac=zoo.ApplyCfg(dispatch=dispatch))
    return lambda: step(state, data)


def profile(step_fn, cfg, device, *, steps: int) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    for _ in range(2):  # warm-up: allocator, cuBLAS, kernel builds
        step_fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        step_fn()
    sync()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if on_card else [])
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step_fn()
        sync()
        traced_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = list(prof.events())
    host = [e for e in events if e.device_type == DeviceType.CPU
            and e.name.startswith("aten::")
            and (e.cpu_parent is None
                 or not e.cpu_parent.name.startswith("aten::"))]
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    out = {
        "arch": cfg.name, "layers": cfg.n_layers, "device": str(device),
        "card": torch.cuda.get_device_name(0) if on_card else None,
        "steps": steps, "wall_ms": wall_ms, "traced_wall_ms": traced_ms,
        "host_ops": len(host) / steps,
        "host_ops_per_layer": len(host) / steps / cfg.n_layers,
        "device_kernels": None, "device_busy_ms": None, "idle_share": None,
        "kernels": None, "top": None,
    }
    if dev:
        busy = _union_ms((e.time_range.start, e.time_range.end)
                         for e in dev) / steps
        by_name: dict = {}
        for e in dev:
            by_name[e.name] = by_name.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3 / steps
        out.update(
            device_kernels=len(dev) / steps, device_busy_ms=busy,
            idle_share=1.0 - busy / wall_ms,
            kernels={k: sum(v for n, v in by_name.items() if sym in n)
                     for k, sym in PORT_KERNELS.items()},
            top=sorted(by_name.items(), key=lambda kv: -kv[1])[:8],
        )
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--train", action="store_true",
                    help="trace a MoE train step instead of a mixed step")
    ap.add_argument("--arch", default=ARCH, choices=sorted(TRAIN_CELLS),
                    help="the model of --train")
    ap.add_argument("--batch", type=int, default=None,
                    help="--train batch (default: the arch's train cell)")
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_config, get_reduced

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    arch = args.arch if args.train else ARCH
    cfg = get_reduced(arch) if args.reduced else get_config(arch)
    if args.train:
        cell = TRAIN_CELLS[arch]
        batch = args.batch or cell["batch"]
        step_fn = train_step_fn(cfg, device, batch=batch, seq=args.seq,
                                dispatch=cell["dispatch"])
    else:
        # Dropless routing, as chip_smoke.py serves the model.
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
        step_fn = mixed_step_fn(cfg, device)
    out = profile(step_fn, cfg, device, steps=args.steps)
    out["step"] = "train" if args.train else "mixed"
    if args.train:
        out.update(batch=batch, dispatch=cell["dispatch"])
    text = json.dumps(out)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")


if __name__ == "__main__":
    main()
