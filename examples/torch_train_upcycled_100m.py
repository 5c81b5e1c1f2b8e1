"""End-to-end script, PyTorch port: train a ~100M-param upcycled MoE for
a few hundred steps with the full production stack — fault-tolerant
Trainer, checkpoint rotation + auto-resume, grad accumulation,
preemption handling (the counterpart of
``examples/train_upcycled_100m.py``).

    PYTHONPATH=src python examples/torch_train_upcycled_100m.py \
        [--steps 300] [--preempt-at 150] [--device cpu]

The model is a slimmed qwen1.5-family decoder (d_model 512, 8 layers,
vocab 32k, 4 experts) — ~100M params total. Kill the process at any point
and rerun: it resumes from the newest valid checkpoint. Runs on the card
unless ``--device cpu`` asks for the plain PyTorch path; raises without
a card otherwise.
"""
import argparse

from repro_torch import resolve_device
from repro_torch.configs import ArchConfig, MoECfg
from repro_torch.core.upcycle import upcycle_params
from repro_torch.data import make_iterator
from repro_torch.models.param import count_params
from repro_torch.optim import adafactor, inverse_sqrt
from repro_torch.training import TrainConfig, Trainer
from repro_torch.training.train_loop import PreemptionSignal

SLIM = ArchConfig(
    name="qwen1.5-0.5b-slim",
    family="moe",
    structure="decoder_only",
    n_layers=8,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=1408,
    vocab_size=32000,
    qkv_bias=True,
    gated_mlp=True,
    moe=MoECfg(num_experts=4, router="top_k", top_k=2,
               capacity_factor=2.0, layer_pattern="every_other",
               group_size=512),
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--dense-steps", type=int, default=50)
    ap.add_argument("--ckpt-dir", default="artifacts/example_100m")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--grad-accum", type=int, default=2)
    ap.add_argument("--preempt-at", type=int, default=0,
                    help="simulate a preemption at this step")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    sparse_cfg = SLIM
    dense_cfg = sparse_cfg.dense_parent()
    opt = adafactor(inverse_sqrt(peak=0.01, warmup_steps=100))
    tc = TrainConfig(grad_accum=args.grad_accum, checkpoint_every=50,
                     log_every=10)

    # Phase 1: dense warm start (skipped if a checkpoint already exists).
    it = make_iterator(dense_cfg, global_batch=args.batch,
                       seq_len=args.seq, host_index=0, host_count=1)
    dense_tr = Trainer(dense_cfg, opt, it, args.ckpt_dir + "/dense", tc=tc,
                       device=device)
    out = dense_tr.run(args.dense_steps)
    dense_state = out["state"]

    # Phase 2: surgery.
    sparse_params = upcycle_params(dense_state["params"], dense_cfg,
                                   sparse_cfg, 11)
    print(f"[example] upcycled params: "
          f"{count_params(sparse_params) / 1e6:.1f}M")

    # Phase 3: fault-tolerant continued training.
    sig = PreemptionSignal().install()
    it2 = make_iterator(sparse_cfg, global_batch=args.batch,
                        seq_len=args.seq, host_index=0, host_count=1)
    it2.restore({"step": int(dense_state["step"])})
    tr = Trainer(sparse_cfg, opt, it2, args.ckpt_dir + "/sparse", tc=tc,
                 preemption=sig, device=device)
    if args.preempt_at:
        orig_watchdog = tr._watchdog

        def watchdog(step, dt):
            orig_watchdog(step, dt)
            if step + 1 >= args.preempt_at:
                sig.trigger()

        tr._watchdog = watchdog
    out = tr.run(args.steps, init_params=sparse_params)
    print(f"[example] done at step {int(out['state']['step'])}, "
          f"loss {float(out['metrics']['loss']):.4f}")
    return out


if __name__ == "__main__":
    main()
