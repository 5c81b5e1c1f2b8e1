"""Quickstart, PyTorch port: sparse-upcycle a dense checkpoint in ~40
lines (the counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

1. trains a small dense LM for a few hundred steps,
2. upcycles it into a 4-expert MoE (paper Figure 1 surgery),
3. verifies the initial quality, continues training,
4. compares against plain dense continuation.

Runs on the card (the flash and expert-FFN kernels) unless ``--device
cpu`` asks for the plain PyTorch path; raises without a card otherwise.
"""
import argparse
import dataclasses

from repro_torch import resolve_device
from repro_torch.configs import MoECfg, get_reduced
from repro_torch.core.upcycle import upcycle_params
from repro_torch.data import make_iterator
from repro_torch.models.param import count_params
from repro_torch.optim import adafactor, inverse_sqrt
from repro_torch.training import init_train_state, make_train_step

PRETRAIN, EXTRA = 200, 200


def train(cfg, state, steps, start):
    opt = adafactor(inverse_sqrt(peak=0.01, warmup_steps=50))
    it = make_iterator(cfg, global_batch=16, seq_len=64,
                       host_index=0, host_count=1)
    it.restore({"step": start})
    step_fn = make_train_step(cfg, opt)
    for _ in range(steps):
        state, mets = step_fn(state, next(it))
    return state, float(mets["ce"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    dense_cfg = get_reduced("tinyllama-1.1b")
    opt = adafactor(inverse_sqrt(peak=0.01, warmup_steps=50))

    print(f"== pretraining dense {dense_cfg.name} for {PRETRAIN} steps")
    state = init_train_state(0, dense_cfg, opt, device=device)
    state, ce = train(dense_cfg, state, PRETRAIN, 0)
    print(f"   dense checkpoint CE: {ce:.4f}")

    print("== upcycling: every other MLP -> 4-expert top-2 MoE")
    sparse_cfg = dataclasses.replace(
        dense_cfg, name="upcycled",
        moe=MoECfg(num_experts=4, router="top_k", top_k=2,
                   capacity_factor=2.0, layer_pattern="every_other",
                   group_size=64),
    )
    sparse_params = upcycle_params(state["params"], dense_cfg, sparse_cfg, 7)
    print(f"   params: {count_params(state['params']):,} -> "
          f"{count_params(sparse_params):,}")

    sp_state = init_train_state(0, sparse_cfg, opt, params=sparse_params)
    sp_state["step"] = state["step"]  # continue the LR schedule (§4.1)

    print(f"== continuing both for {EXTRA} steps")
    d2, d_ce = train(dense_cfg, state, EXTRA, PRETRAIN)
    s2, s_ce = train(sparse_cfg, sp_state, EXTRA, PRETRAIN)
    print(f"   dense continuation CE: {d_ce:.4f}")
    print(f"   upcycled MoE       CE: {s_ce:.4f}"
          f"   (gain {d_ce - s_ce:+.4f})")
    return {"dense_ce": ce, "dense_continued_ce": d_ce, "moe_ce": s_ce}


if __name__ == "__main__":
    main()
