"""Time a kernel against a variant of its sources, on the card.

    PYTHONPATH=src python -m repro_torch.launch.ab_dw \\
        [--kernel {expert_dw,grouped_dw,wkv}] \\
        [--file expert_gemm.cuh --old TEXT --new TEXT | --csrc DIR] \\
        [--rounds 2]

Copies ``kernels/csrc`` under ``build/`` with one text substitution in
``--file``, or takes the sources in ``--csrc`` (another version of
``kernels/csrc``, say a parent commit's unpacked with ``git archive``),
and builds both libraries. The default substitution makes
``gemm_slabs``' A-transposed mode find every staged chunk's depth row
(``stage_rows``), never staging a slab that lies in one group as one run
of rows (``stage_tile``). Inputs are random from seed 0, float32, at the
main path's shapes as ``chip_smoke.py`` times the kernel: ``expert_dw``
the ViT-B/16 MoE's padded buffer (5, 32, 256, 768), f 3072, ungated;
``grouped_dw`` granite's training buffer (two groups of 33,280 rows, d
1024, f 512, gated; the scratch from the plain dx); ``wkv`` the rwkv
prefill (8, 512, 64, 64, 64) and a decode step. A substitution must give
the same bits; sources from ``--csrc`` may sum in another order, so
their largest difference (relative to the largest output) is printed.
Then it times source, variant, variant, source, ``--rounds`` times, with
``chip_smoke.py``'s device-clock timer (20 calls queued behind a spin
kernel, L2 flushed before each). Prints the card's name and power limit,
each reading, and one JSON line.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
STAGE_ONE_RUN = ("if (cap % sk != 0) return false;  // a slab may cross "
                 "into a group")


def variant_kernel(base, file: str, old: str, new: str, csrc=None):
    """``base`` built from a copy of its sources with ``old`` replaced
    by ``new`` (exactly once) in ``file``, or from the sources in
    ``csrc``."""
    from repro_torch.kernels.build import Kernel, build_dir

    if csrc is None:
        src = base.csrc / file
        text = src.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"ab_dw: {old!r} occurs {text.count(old)} "
                             f"times in {file}, not once")
        csrc = build_dir() / "ab_csrc"
        shutil.rmtree(csrc, ignore_errors=True)
        shutil.copytree(base.csrc, csrc)
        (csrc / file).write_text(text.replace(old, new))
    return Kernel(base.name, base.symbol, base.argtypes,
                  source=base.source.stem, csrc=Path(csrc))


def cases(kernel: str, dev):
    """(module, attribute of its Kernel, {shape: call}) of ``kernel``;
    each call runs the module's wrapper on fixed inputs."""
    import torch

    from chip_smoke import train_cases, wkv_case
    from repro_torch.configs import get_config
    from repro_torch.kernels import expert_mlp as em
    from repro_torch.kernels import grouped_mlp as gm
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6 as wkv

    gen = torch.Generator(device=dev).manual_seed(0)
    if kernel == "expert_dw":
        G, E, cap, d, f = 5, 32, 256, 768, 3072
        rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa
        xe, dy, da, h = rnd(G, E, cap, d), rnd(G, E, cap, d), \
            rnd(G, E, cap, f), rnd(G, E, cap, f)
        return em, "KERNEL_DW", {
            "vit": lambda: em.expert_ffn_dw_cuda(xe, dy, da, None, h)}
    if kernel == "grouped_dw":
        _, c = train_cases(get_config("granite-moe-1b-a400m"), dev, gen)
        _, da, dg, h = ref.grouped_mlp_dx_ref(
            c["xs"], c["wi"], c["wg"], c["wo"], c["dy"], c["counts"],
            block=gm.ROW_BLOCK)
        args = (c["xs"], c["dy"], da, dg, h, c["counts"])
        return gm, "KERNEL_DW", {
            "granite_train": lambda: gm.grouped_mlp_dw_cuda(*args)}
    calls = {}
    for tag, T, state in (("prefill", 512, False), ("decode", 1, True)):
        w = wkv_case(get_config("rwkv6-7b"), T, dev, gen, state=state)
        args = (w["r"], w["k"], w["v"], w["w"], w["u"], w["s0"])
        calls[tag] = lambda a=args: wkv.rwkv6_cuda(*a)
    return wkv, "KERNEL", calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", default="expert_dw",
                    choices=("expert_dw", "grouped_dw", "wkv"))
    ap.add_argument("--file", default="expert_gemm.cuh")
    ap.add_argument("--old", default=STAGE_ONE_RUN)
    ap.add_argument("--new", default="return false;  // row by row")
    ap.add_argument("--csrc", default=None,
                    help="build the variant from these sources instead")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ab_dw: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from chip_smoke import card_line, time_ms

    from repro_torch.kernels.build import build_all

    dev = torch.device("cuda")
    mod, attr, calls = cases(args.kernel, dev)
    base = getattr(mod, attr)
    alt = variant_kernel(base, args.file, args.old, args.new, args.csrc)
    secs = build_all([base, alt])
    print(card_line(), flush=True)
    print(f"[ab_dw] built both in {secs:.1f} s", flush=True)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)

    def call(kern, fn):
        setattr(mod, attr, kern)
        try:
            return fn()
        finally:
            setattr(mod, attr, base)

    ms, diff = {}, {}
    for shape, fn in calls.items():
        for y, z in zip(call(base, fn), call(alt, fn)):
            if y is None:
                continue
            if args.csrc is None and not torch.equal(y, z):
                raise SystemExit("ab_dw: the variant's bits differ")
            rel = float((y - z).abs().max() / y.abs().max().clamp_min(1e-30))
            diff[shape] = max(diff.get(shape, 0.0), rel)
        print(f"[ab_dw] {shape}: max |source - variant| / max |source| = "
              f"{diff[shape]:.3e}", flush=True)
        ms[shape] = {"source": [], "variant": []}
        for _ in range(args.rounds):
            for tag, kern in (("source", base), ("variant", alt),
                              ("variant", alt), ("source", base)):
                t = time_ms(lambda: call(kern, fn), flush=flush)
                ms[shape][tag].append(t)
                print(f"[ab_dw] {shape} {tag}: {t:.4f} ms", flush=True)
    print(json.dumps({"kernel": args.kernel, "file": args.file,
                      "old": args.old, "new": args.new, "csrc": args.csrc,
                      "max_rel_diff": diff, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
