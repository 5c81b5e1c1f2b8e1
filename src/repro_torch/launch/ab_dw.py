"""Time the expert dW kernel against a variant of its sources, on the card.

    PYTHONPATH=src python -m repro_torch.launch.ab_dw \\
        [--file expert_gemm.cuh --old TEXT --new TEXT] [--rounds 2]

Copies ``kernels/csrc`` under ``build/`` with one text substitution in
``--file`` and builds both libraries. The default substitution makes
``gemm_slabs``' A-transposed mode find every staged chunk's depth row
(``stage_rows``), never staging a slab that lies in one group as one run
of rows (``stage_tile``). At the ViT-B/16 MoE shape, as ``chip_smoke.py``
times the kernel (the padded buffer (5, 32, 256, 768), f 3072, float32,
ungated, random inputs from seed 0), it requires the two libraries to
give the same bits, then times them in the order source, variant,
variant, source, ``--rounds`` times, with ``chip_smoke.py``'s device-clock
timer (20 calls queued behind a spin kernel, L2 flushed before each).
Prints the card's name and power limit, each reading, and one JSON line.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
STAGE_ONE_RUN = "if (depth.cap % SK == 0) {  // the slab lies in one group"


def variant_kernel(base, file: str, old: str, new: str):
    """``base`` built from a copy of its sources with ``old`` replaced
    by ``new`` (exactly once) in ``file``."""
    from repro_torch.kernels.build import Kernel, build_dir

    src = base.csrc / file
    text = src.read_text()
    if text.count(old) != 1:
        raise SystemExit(f"ab_dw: {old!r} occurs {text.count(old)} times "
                         f"in {file}, not once")
    csrc = build_dir() / "ab_csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(base.csrc, csrc)
    (csrc / file).write_text(text.replace(old, new))
    return Kernel(base.name, base.symbol, base.argtypes,
                  source=base.source.stem, csrc=csrc)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--file", default="expert_gemm.cuh")
    ap.add_argument("--old", default=STAGE_ONE_RUN)
    ap.add_argument("--new", default="if (false) {")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ab_dw: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from chip_smoke import card_line, time_ms

    from repro_torch.kernels import expert_mlp as em
    from repro_torch.kernels.build import build_all

    base = em.KERNEL_DW
    alt = variant_kernel(base, args.file, args.old, args.new)
    secs = build_all([base, alt])
    print(card_line(), flush=True)
    print(f"[ab_dw] built both in {secs:.1f} s", flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    G, E, cap, d, f = 5, 32, 256, 768, 3072
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa
    xe, dy, da, h = rnd(G, E, cap, d), rnd(G, E, cap, d), \
        rnd(G, E, cap, f), rnd(G, E, cap, f)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)

    def call(kern):
        em.KERNEL_DW = kern
        try:
            return em.expert_ffn_dw_cuda(xe, dy, da, None, h)
        finally:
            em.KERNEL_DW = base

    for y, z in zip(call(base), call(alt)):
        if y is not None and not torch.equal(y, z):
            raise SystemExit("ab_dw: the variant's bits differ")
    ms = {"source": [], "variant": []}
    for _ in range(args.rounds):
        for tag, kern in (("source", base), ("variant", alt),
                          ("variant", alt), ("source", base)):
            t = time_ms(lambda: call(kern), flush=flush)
            ms[tag].append(t)
            print(f"[ab_dw] {tag}: {t:.4f} ms", flush=True)
    print(json.dumps({"file": args.file, "old": args.old, "new": args.new,
                      "shape": [G, E, cap, d, f], "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
