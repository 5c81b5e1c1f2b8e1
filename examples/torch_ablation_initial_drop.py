"""Ablation script, PyTorch port: the paper's Figure 15 initial-drop
experiment, live (the counterpart of ``examples/ablation_initial_drop.py``).

    PYTHONPATH=src python examples/torch_ablation_initial_drop.py \
        [--device cpu]

Upcycles one dense checkpoint under a grid of (capacity factor x combine-
weight renormalization) and prints the step-0 quality drop vs the dense
model — the crispest mechanism in the paper: with renorm and enough
capacity, the surgery is lossless. Runs on the card unless ``--device
cpu`` asks for the plain PyTorch path; raises without a card otherwise.
"""
import argparse
import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.configs import MoECfg, get_reduced
from repro_torch.core.upcycle import upcycle_params
from repro_torch.data import make_iterator
from repro_torch.models.model_zoo import loss_fn
from repro_torch.optim import adafactor, inverse_sqrt
from repro_torch.training import init_train_state, make_train_step
from repro_torch.training.train_loop import batch_to

PRETRAIN = 200
CAPACITIES = (0.5, 1.0, 2.0, 4.0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    dense_cfg = get_reduced("tinyllama-1.1b")
    opt = adafactor(inverse_sqrt(peak=0.01, warmup_steps=50))
    it = make_iterator(dense_cfg, global_batch=16, seq_len=64,
                       host_index=0, host_count=1)
    state = init_train_state(0, dense_cfg, opt, device=device)
    step = make_train_step(dense_cfg, opt)
    print(f"== pretraining dense checkpoint ({PRETRAIN} steps)")
    for _ in range(PRETRAIN):
        state, mets = step(state, next(it))
    base = float(mets["ce"])
    print(f"   dense CE {base:.4f}")

    dw = state["params"]
    eval_batch = batch_to(next(it), device)

    with torch.no_grad():
        dense_ce = float(loss_fn(dw, eval_batch, dense_cfg)[1]["ce"])
    grid = {}
    print(f"\n{'C':>6} {'renorm':>7} {'step0 CE':>9} {'drop':>8}")
    for renorm in (True, False):
        for c in CAPACITIES:
            cfg = dataclasses.replace(
                dense_cfg, name="u",
                moe=MoECfg(num_experts=4, router="top_k", top_k=2,
                           capacity_factor=c, group_size=64,
                           layer_pattern="every_other",
                           normalize_combine_weights=renorm),
            )
            sp = upcycle_params(dw, dense_cfg, cfg, 7)
            with torch.no_grad():
                ce = float(loss_fn(sp, eval_batch, cfg)[1]["ce"])
            grid[(c, renorm)] = ce
            print(f"{c:6.1f} {str(renorm):>7} {ce:9.4f} "
                  f"{ce - dense_ce:+8.4f}")
    print("\n(with renorm + drop-free capacity the drop is exactly 0 — "
          "paper Fig. 15)")
    return {"dense_ce": base, "eval_dense_ce": dense_ce, "grid": grid}


if __name__ == "__main__":
    main()
