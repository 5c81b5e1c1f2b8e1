"""Trace one fixed-shape ``paged_mixed_step`` (or a train step, or the
static engine's prefill and decode step) with ``torch.profiler`` and
report where its time goes.

    PYTHONPATH=src python -m repro_torch.launch.profile_step \\
        [--train [--arch granite-moe-1b-a400m|vit-b16-upcycled|\\
                         t5-base-upcycled|pixtral-12b] \\
         [--batch N] [--seq S] [--remat none|full|dots|moe] \\
         [--compute-dtype float32|bfloat16]] \\
        [--static [--arch rwkv6-7b|rwkv6-7b-moe|granite-moe-1b-a400m|\\
                          jamba-1.5-large-398b] \\
         [--batch 8] [--seq 512]] \\
        [--serve-step mixed|verify|prefill|decode] \\
        [--reduced] [--steps 3] [--device cuda|cpu] \\
        [--out trace_summary.json]

Without ``--train`` the model is granite-moe-1b-a400m, the serve
cell's, with dropless routing and the sorted dispatch. The step carries
the serve shapes of ``chip_smoke.py`` (8 decode rows of ragged lengths,
two 64-token chunk lanes, 16-token blocks, 512-token sequences) over
random pools and random weights from seed 0. ``--serve-step`` picks the
serve step: the chunked engine's ``paged_mixed_step`` (the default), the
speculating engine's ``paged_verify_step`` (the decode rows become
verify lanes of 5 rows, spec_k 4, beside the same chunk lanes), or
prefill-on-join's B = 1 ``paged_prefill`` (a 256-token bucket) and its
batched ``paged_decode_step`` (the 8 decode rows). ``--train`` traces one MoE
train step of ``--arch`` instead, on a fixed batch of the arch's
synthetic stream, as its train cell in ``chip_smoke.py`` runs it:
granite at 16 x 512 tokens through the sorted dispatch, the ViT at 104
images of 196 patches (its sequence; ``--seq`` is not read) and T5 at 16
x 512 encoder and 16 x 128 decoder tokens through the gather dispatch,
pixtral-12b at 4 of its 40 layers (as ``chip_smoke.py`` trains it) at 4
x 1,152 positions (``--seq`` defaults to 1,152 there), the first 1,024
of them stub patches, under ``--remat`` and in ``--compute-dtype`` (the
step's ``ApplyCfg``;
the train output adds ``peak_memory_bytes``, the untraced steps' peak
on the card). ``--static`` traces the static engine on ``--arch``
instead (random weights from seed 0, dropless routing, float32 caches;
``rwkv6-7b-moe`` is rwkv6-7b's channel-mix MoE, ``rwkv6_7b.upcycled()``,
at 4 layers as ``chip_smoke.py`` serves it; ``jamba-1.5-large-398b`` at 5
of its 72 layers, the fewest that hold its attention layer, with
bfloat16 weights, activations and caches, as ``chip_smoke.py`` serves
its upcycled MoE):
one prefill of ``--batch`` x ``--seq`` random tokens from an empty cache
(the cache's allocation included, as ``generate`` does it), and one
decode step of the batch at position ``--seq``; each phase gets the
fields below under ``"prefill"`` and ``"decode"``. It prints one JSON
object per run:

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
* ``top``: the eight device kernels that took the most time;
* ``movement_ms``: device ms per step of PyTorch's row-moving kernels
  (names holding ``index``, ``gather`` or ``scatter``: the MoE's
  dispatch and combine, embedding lookups, the routers' tables);
* ``counted_flops`` (``aten_flops`` + the kernels' ``kernel_flops``),
  ``kernel_bytes`` and ``kernel_calls``: one more step run under
  ``launch/flops.step_cost`` after the timed ones (the count's dispatch
  mode slows the step it counts, so no time is taken from it);
  ``--train`` adds ``model_flops`` (6 N D, N the active parameters of
  the model as built, D the step's tokens: images x patches for the
  ViT, encoder tokens for T5), ``mfu`` and ``hardware_flops_util``
  (model and counted FLOPs over ``wall_ms`` x the card's dense bf16
  peak, 989 TFLOP/s, for every dtype) and ``useful_flops_ratio``; the
  serve steps add ``hbm_share``, the kernels' bytes over ``wall_ms`` x
  the card's HBM rate. The shares are ``null`` on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

ARCH = "granite-moe-1b-a400m"
RWKV_MOE, RWKV_MOE_LAYERS = "rwkv6-7b-moe", 4
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
                "expert_mlp": "ffn_gemm",
                "expert_mlp_dx": "expert_dx_",
                "expert_mlp_dw": "expert_dw_kernel",
                "rwkv6": "wkv6_kernel"}
# Name fragments of PyTorch's row-moving kernels (``movement_ms``).
MOVEMENT = ("index", "gather", "scatter")
# The train cells of chip_smoke.py: default batch (images for the
# encoder-only ViT) and MoE dispatch.
TRAIN_CELLS = {"granite-moe-1b-a400m": dict(batch=16, dispatch="sorted"),
               "vit-b16-upcycled": dict(batch=104, dispatch="gather"),
               "t5-base-upcycled": dict(batch=16, dispatch="gather"),
               "pixtral-12b": dict(batch=4, dispatch="gather", seq=1152)}
JAMBA = "jamba-1.5-large-398b"
# Full-width models cut in depth, as chip_smoke.py runs them.
DEPTH = {JAMBA: 5, "pixtral-12b": 4}
# Served with bfloat16 weights (the 5-layer jamba MoE is 48 GB so).
STATIC_BF16 = (JAMBA,)


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


SPEC_K1, PP_BUCKET = 5, 256  # verify rows a lane; prefill-on-join's bucket


def serve_step_fn(cfg, device, kind: str):
    """One serve-cell ``verify``, ``prefill`` (prefill-on-join) or
    ``decode`` (its batched decode) step, as a closure, on the mixed
    step's pools, tables and lengths."""
    import torch

    from repro_torch.models import model_zoo as zoo

    params = zoo.init_params(torch.Generator(device=device).manual_seed(0),
                             cfg, device=device)
    _, args = mixed_step_inputs(cfg, device)
    tok, ctoks, cache, dec_tab, dec_len, ctab, cstart, clen = args
    ac = zoo.ApplyCfg(dispatch="sorted")
    gen = torch.Generator(device=device).manual_seed(3)
    i32 = dict(dtype=torch.int32, device=device)
    if kind == "verify":
        vtoks = torch.randint(1, cfg.vocab_size, (tok.shape[0], SPEC_K1),
                              generator=gen, **i32)
        vlen = torch.where(dec_len > 0, SPEC_K1, 0).to(torch.int32)
        return lambda: zoo.paged_verify_step(
            params, vtoks, ctoks, cache, dec_tab, dec_len, vlen, ctab,
            cstart, clen, cfg, ac=ac)
    if kind == "prefill":
        toks = torch.randint(1, cfg.vocab_size, (1, PP_BUCKET),
                             generator=gen, **i32)
        return lambda: zoo.paged_prefill(params, toks, cache, ctab[:1],
                                         PP_BUCKET - 3, cfg, ac=ac)
    return lambda: zoo.paged_decode_step(params, tok, cache, dec_tab,
                                         dec_len, cfg, ac=ac)


def train_step_fn(cfg, device, *, batch: int, seq: int, dispatch: str,
                  remat: str = "none", compute_dtype: str = "float32"):
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
    step = make_train_step(cfg, opt, ac=zoo.ApplyCfg(
        dispatch=dispatch, remat=remat, compute_dtype=compute_dtype))
    return lambda: step(state, data)


def static_step_fns(cfg, device, *, batch: int, seq: int,
                    dtype: str = "float32"):
    """The static engine's prefill (from a fresh cache) and one decode
    step at position ``seq``, as closures; weights, activations and
    caches in ``dtype``."""
    import torch

    from repro_torch.models import model_zoo as zoo

    dt = getattr(torch, dtype)
    params = zoo.init_params(torch.Generator(device=device).manual_seed(0),
                             cfg, dtype=dt, device=device)
    ac = zoo.ApplyCfg(compute_dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=gen,
                         device=device)

    def fresh_cache():
        return zoo.init_serve_cache(cfg, batch, seq + 1, dtype=dt,
                                    device=device)

    def prefill():
        return zoo.prefill(params, {"tokens": toks[:, :seq]}, fresh_cache(),
                           cfg, ac=ac)

    cache, _ = prefill()
    return prefill, lambda: zoo.decode_step(params, toks[:, seq:], cache,
                                            seq, cfg, ac=ac)


def profile(step_fn, cfg, device, *, steps: int) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    for _ in range(2):  # warm-up: allocator, cuBLAS, kernel builds
        step_fn()
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        step_fn()
    sync()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    peak = torch.cuda.max_memory_allocated() if on_card else None
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
        "kernels": None, "top": None, "movement_ms": None,
        "peak_memory_bytes": peak,
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
            movement_ms=sum(v for n, v in by_name.items()
                            if any(w in n.lower() for w in MOVEMENT)),
        )
    return out


def cost_fields(step_fn, wall_ms: float) -> dict:
    """One more step under ``step_cost``: its counted FLOPs and the
    kernels' work (module docstring)."""
    from repro_torch.launch.flops import step_cost

    _, cost = step_cost(step_fn)
    return {"counted_flops": cost["total_flops"],
            "aten_flops": cost["aten_flops"],
            "kernel_flops": cost["kernel_flops"],
            "kernel_bytes": cost["kernel_bytes"],
            "kernel_calls": cost["kernel_calls"]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--train", action="store_true",
                    help="trace a MoE train step instead of a mixed step")
    ap.add_argument("--static", action="store_true",
                    help="trace the static engine's prefill and decode "
                         "step instead of a mixed step")
    ap.add_argument("--arch", default=ARCH,
                    choices=sorted({*TRAIN_CELLS, "rwkv6-7b", RWKV_MOE,
                                    JAMBA}),
                    help="the model of --train or --static")
    ap.add_argument("--batch", type=int, default=None,
                    help="--train batch (default: the arch's train cell); "
                         "--static batch (default 8)")
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length (default 512; pixtral's train "
                         "cell 1,152)")
    ap.add_argument("--remat", default="none",
                    choices=["none", "full", "dots", "moe"],
                    help="--train: the step's remat policy")
    ap.add_argument("--compute-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="--train: the step's compute dtype")
    ap.add_argument("--serve-step", default="mixed",
                    choices=["mixed", "verify", "prefill", "decode"],
                    help="the serve step to trace (without --train and "
                         "--static)")
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
    arch = args.arch if args.train or args.static else ARCH
    if arch == RWKV_MOE:
        from repro_torch.configs import rwkv6_7b

        cfg = (rwkv6_7b.REDUCED if args.reduced else dataclasses.replace(
            rwkv6_7b.FULL, n_layers=RWKV_MOE_LAYERS))
        cfg = dataclasses.replace(cfg.with_moe(rwkv6_7b.upcycled().moe),
                                  name=RWKV_MOE)
    else:
        cfg = get_reduced(arch) if args.reduced else get_config(arch)
        if not args.reduced and arch in DEPTH:
            cfg = dataclasses.replace(cfg, n_layers=DEPTH[arch])
    cell = TRAIN_CELLS.get(arch, {})
    seq = args.seq or cell.get("seq", 512)
    if args.static:
        if cfg.moe is not None:  # dropless, as chip_smoke.py serves it
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
        batch = args.batch or 8
        dtype = "bfloat16" if arch in STATIC_BF16 else "float32"
        with torch.no_grad():
            fns = static_step_fns(cfg, device, batch=batch, seq=seq,
                                  dtype=dtype)
            out = {"arch": cfg.name, "layers": cfg.n_layers,
                   "device": str(device), "step": "static", "batch": batch,
                   "seq": seq, "dtype": dtype}
            for phase, fn in zip(("prefill", "decode"), fns):
                out[phase] = profile(fn, cfg, device, steps=args.steps)
                out[phase].update(cost_fields(fn, out[phase]["wall_ms"]))
        out["card"] = out["prefill"]["card"]
        text = json.dumps(out)
        print(text, flush=True)
        if args.out:
            with open(args.out, "w") as fh:
                fh.write(text + "\n")
        return
    if args.train:
        batch = args.batch or cell["batch"]
        step_fn = train_step_fn(cfg, device, batch=batch, seq=seq,
                                dispatch=cell["dispatch"], remat=args.remat,
                                compute_dtype=args.compute_dtype)
    else:
        # Dropless routing, as chip_smoke.py serves the model.
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
        step_fn = (mixed_step_fn(cfg, device) if args.serve_step == "mixed"
                   else serve_step_fn(cfg, device, args.serve_step))
    out = profile(step_fn, cfg, device, steps=args.steps)
    out["step"] = "train" if args.train else args.serve_step
    out.update(cost_fields(step_fn, out["wall_ms"]))
    if args.train:
        from repro_torch.launch.flops import model_flops, utilization

        tokens = batch * (cfg.n_frontend_positions
                          if cfg.structure == "encoder_only" else seq)
        out.update(batch=batch, seq=seq, dispatch=cell["dispatch"],
                   remat=args.remat, compute_dtype=args.compute_dtype,
                   tokens=tokens,
                   model_flops=model_flops(cfg, "train", tokens))
        util = utilization(out["model_flops"], out["counted_flops"],
                           out["wall_ms"] / 1e3)
        # A share of the card's peak only from a step on the card.
        out.update(util if device.type == "cuda" else dict.fromkeys(util))
    else:
        from repro_torch.launch.mesh import HBM_BW

        out["hbm_share"] = (sum(out["kernel_bytes"].values())
                            / (out["wall_ms"] / 1e3 * HBM_BW)
                            if device.type == "cuda" else None)
    text = json.dumps(out)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")


if __name__ == "__main__":
    main()
